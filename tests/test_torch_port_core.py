"""The port's native core against the JAX package's, on the CPU.

Each package runs its own build of the ``cpp/`` sources (the port's with
its own ``collectives.cc``) in worlds of 2 and 3 processes
(``torch_port_core_worker.py``): every eager op over every dtype, bf16
included, gives the same bytes, but for the fp16 rounding of a reduction
(ties to even in the port). The ``torch.distributed``
plane (``HVD_TPU_EAGER_BACKEND=dist``) runs the same cases against the
JAX core. The engine's state is driven through the public API in gloo
worlds (``torch_port_eager_worker.py``): the response cache's steady
state, the error paths, the ``hvd_engine_*`` gauges on ``/metrics`` and
their drop at a re-mesh, and a stalled rank's autopsy."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import (REPO, build_core,  # noqa: E402
                               launch_env_world, reserve_ports, spawn_world)

CORE_WORKER = os.path.join(REPO, "tests", "torch_port_core_worker.py")
EAGER_WORKER = os.path.join(REPO, "tests", "torch_port_eager_worker.py")


@pytest.fixture(scope="module", autouse=True)
def _core_built():
    """The core is built before any world starts (a cold build under load
    must not eat a world's timeout)."""
    build_core()


def _jax_core_available() -> bool:
    from horovod_tpu.core import core_available
    return core_available()


def launch_core_world(pkg: str, n: int, out, extra_env=None):
    """``n`` ranks of ``torch_port_core_worker.py --pkg PKG`` (the dist
    plane selected for ``dist``); returns each rank's results."""
    launch_env_world([CORE_WORKER, "--pkg", pkg, "--out", str(out)], n, out,
                     dict({"HVD_TPU_EAGER_BACKEND": "dist"},
                          **(extra_env or {})), name=pkg)
    return [dict(np.load(os.path.join(str(out), f"{pkg}.rank{r}.npz")))
            for r in range(n)]


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX package's core: every case, in worlds of 2 and 3."""
    env = {}
    if not _jax_core_available():
        # the JAX package's own build is absent: its binding over the
        # port's build of the same sources
        from horovod_tpu_torch.core import library_path
        env["HVD_TPU_CORE_LIB"] = library_path()
    return {n: launch_core_world("jax", n, tmp_path_factory.mktemp(f"jax{n}"),
                                 extra_env=env) for n in (2, 3)}


def _f16_ties_away(v: np.ndarray) -> np.ndarray:
    """float32 to fp16 as ``cpp/collectives.cc``'s ``F32ToF16`` rounds:
    to nearest, ties away from zero (finite inputs)."""
    out = []
    for u in v.astype(np.float32).reshape(-1).view(np.uint32).tolist():
        sign, man = (u >> 16) & 0x8000, u & 0x7FFFFF
        e = ((u >> 23) & 0xFF) - 127 + 15
        if e >= 0x1F:
            h = sign | 0x7C00
        elif e <= 0:
            if e < -10:
                h = sign
            else:
                man |= 0x800000
                shift = 14 - e
                h = sign | ((man >> shift) + ((man >> (shift - 1)) & 1))
        else:
            h = (sign | (e << 10) | (man >> 13)) + ((man >> 12) & 1)
        out.append(h)
    return np.asarray(out, np.uint16).view(np.float16).reshape(v.shape)


def _f16_ties_even(v: np.ndarray) -> np.ndarray:
    return v.astype(np.float32).astype(np.float16)   # IEEE, as numpy


def _f16_ring(ins, op, pre, post, avg, rnd, last):
    """An fp16 allreduce as the core's ring computes it, ``rnd`` rounding
    every result: each input prescaled, the inputs of every rank but
    ``last`` combined, then ``last``'s (the ring's order for the chunk
    that holds the element), then the average and the postscale. Scales
    go through a double and a float, as ``ScaleBuffer`` does."""
    def scale(x, f):
        return x if f == 1.0 else rnd(np.float32(
            x.astype(np.float32).astype(np.float64) * f))
    xs = [scale(x, pre) for x in ins]
    order = [x for i, x in enumerate(xs) if i != last] + [xs[last]]
    acc = order[0]
    for x in order[1:]:
        a, b = acc.astype(np.float32), x.astype(np.float32)
        acc = rnd(a * b if op == "prod" else a + b)
    if avg:
        acc = scale(acc, 1.0 / len(ins))
    return scale(acc, post)


def _f16_rounding_cases(n):
    """``{key: (inputs of every rank, op, pre, post, avg, rows)}`` for the
    fp16 reductions that round (a grouped key has one entry a tensor;
    ``rows``: a reducescatter's rank ``r`` keeps rows ``r*rows`` on)."""
    from torch_port_core_worker import AVG, PRODUCT, cases
    per_rank = [cases(r, n) for r in range(n)]
    out = {}
    for i, (key, kind, _, args) in enumerate(per_rank[0]):
        if not key.endswith(".float16") or kind not in (
                "allreduce", "grouped", "reducescatter") or \
                args[0] not in (AVG, PRODUCT, 1):   # 1: Sum
            continue
        pre, post = (args[1], args[2]) if kind == "allreduce" else (1.0, 1.0)
        op = "prod" if args[0] == PRODUCT else "sum"
        rows = 2 if kind == "reducescatter" else None
        tensors = list(zip(*(per_rank[r][i][2] for r in range(n))))
        keys = [f"{key}.{j}" for j in range(len(tensors))] \
            if kind == "grouped" else [key]
        for k, ins in zip(keys, tensors):
            out[k] = (list(ins), op, pre, post, args[0] == AVG, rows)
    return out


def _f16_hit(got, ins, op, pre, post, avg, rows, r, rnd):
    """Where fp16 ``got`` (rank ``r``'s bytes) is, to the bit, the ring's
    result under ``rnd`` for some ring order of the element."""
    hit = None
    for last in range(len(ins)):
        want = _f16_ring(ins, op, pre, post, avg, rnd, last)
        if rows is not None:
            want = want[r * rows:(r + 1) * rows]
        eq = want.view(np.uint16) == got.view(np.float16).reshape(
            want.shape).view(np.uint16)
        hit = eq if hit is None else hit | eq
    return hit


@pytest.mark.parametrize("n", [2, 3])
def test_port_core_is_bit_equal_to_the_jax_core(jax_results, tmp_path, n):
    """Every allreduce op (sum, min, max, product, average, scaled,
    Adasum), grouped allreduce, ragged allgather, broadcast from every
    root, uneven alltoall and reducescatter over fp32/fp64/fp16/bf16/
    int32/int64/uint8/int8 (and bool), plus join: the same bytes. The one
    departure is the fp16 rounding of a reduction: the port's core rounds
    ties to even (IEEE's default, as the reference's F16C path, numpy and
    torch round), the JAX core's ``cpp/`` ties away from zero. Each such
    element is, to the bit, the ring's result under the port's rounding
    (and the JAX core's under its own) for one of the ring's orders."""
    port = launch_core_world("port", n, tmp_path)
    f16 = _f16_rounding_cases(n)
    # without a build of its own the JAX binding ran the port's library
    jax_round = _f16_ties_away if _jax_core_available() else _f16_ties_even
    for r in range(n):
        a, b = jax_results[n][r], port[r]
        assert sorted(a) == sorted(b)
        differ = [k for k in a if k not in f16 and
                  not np.array_equal(a[k], b[k])]
        assert not differ, differ
        assert int(b["responses_executed"][0]) > 0
        for key, case in f16.items():
            for pkg, got, rnd in (("port", b, _f16_ties_even),
                                  ("jax", a, jax_round)):
                hit = _f16_hit(got[key], *case, r, rnd)
                assert hit.all(), (pkg, key, r, np.flatnonzero(~hit))


def _dtype_of(key: str) -> str:
    return key.split(".")[1] if "." in key else ""


@pytest.mark.parametrize("n", [2, 3])
def test_dist_plane_matches_the_jax_core(jax_results, tmp_path, n):
    """The ``torch.distributed`` plane over gloo against the JAX core:
    data movement and integer reductions equal, fp32/fp64 within 1e-6
    relative, fp16 and bf16 within one unit in the last place of the
    result (2^-10 and 2^-7 relative: a sum of three rounds after each
    addition, in another order). Adasum is left out (a binary tree over
    zero padding, not the core's VHDD: ``test_torch_port_adasum.py``),
    and so is join."""
    tol = {"float32": 1e-6, "float64": 1e-6, "float16": 2.0 ** -10,
           "bfloat16": 2.0 ** -7}
    dist = launch_core_world("dist", n, tmp_path)
    for r in range(n):
        a, b = jax_results[n][r], dist[r]
        for k in b:
            if "adasum" in k:
                continue
            dt = _dtype_of(k)
            if k.endswith((".shape", ".splits")) or dt not in tol:
                assert np.array_equal(a[k], b[k]), k
                continue
            x, y = _floats(a[k], dt), _floats(b[k], dt)
            np.testing.assert_allclose(y, x, rtol=tol[dt], atol=tol[dt],
                                       err_msg=k)


def _floats(raw: np.ndarray, dt: str) -> np.ndarray:
    if dt == "bfloat16":
        return (raw.view(np.uint16).astype(np.uint32) << 16).view(
            np.float32).astype(np.float64)
    return raw.view(np.dtype(dt)).astype(np.float64)


def test_core_builds_into_build_dir_and_refuses_a_failed_build(
        tmp_path, monkeypatch):
    """The library is built from ``cpp/`` under ``build/horovod_tpu_torch``
    (never in ``cpp/``, never the JAX package's library), its name hashes
    the sources and the flags, and a failed build raises."""
    from horovod_tpu_torch import core
    before = set(os.listdir(core.CPP))
    path = core.library_path()
    assert path.startswith(core.BUILD_DIR) and os.path.exists(path)
    assert "horovod_tpu/core" not in path
    assert set(os.listdir(core.CPP)) == before
    d0 = core._digest()
    monkeypatch.setattr(core, "CXXFLAGS", core.CXXFLAGS + ("-DX",))
    assert core._digest() != d0
    monkeypatch.setattr(core, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(core, "_cxx", lambda: "false")
    with pytest.raises(RuntimeError, match="building the core failed"):
        core.library_path()


def test_core_config_round_trips_the_env(monkeypatch):
    from horovod_tpu_torch.core.bindings import core_config_dump
    monkeypatch.setenv("HVD_TPU_CACHE_CAPACITY", "77")
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "4096")
    cfg = core_config_dump()
    assert cfg["cache_capacity"] == "77", cfg
    assert cfg["fusion_threshold"] == "4096", cfg


def test_response_cache_evicts_hits_and_fuses(tmp_path):
    """``cache_worker.py``: eviction under a capacity of 4, hits in the
    steady state (``metrics_snapshot()["engine"]`` and ``derived``),
    fused ragged allgathers against a per-tensor oracle, and the core's
    timeline restarted mid-run (both files parse)."""
    tl1, tl2 = tmp_path / "tl1.json", tmp_path / "tl2.json"
    res = spawn_world(EAGER_WORKER, "cache", 2, tmp_path, extra_env={
        "HOROVOD_CACHE_CAPACITY": "4", "HVD_TPU_FUSION_THRESHOLD": "512",
        "HVD_TEST_TL1": str(tl1), "HVD_TEST_TL2": str(tl2)}, timeout=90)
    assert int(res[0]["hits"][0]) > 0
    for p in (tl1, tl2):
        events = json.loads(p.read_text())
        assert isinstance(events, list) and events


def test_core_error_paths(tmp_path):
    """``error_worker.py``: a shape mismatch, a duplicate in-flight name
    and a poisoned group fail cleanly on every rank, a fractional integer
    scale is refused before the wire, and the engine keeps working."""
    spawn_world(EAGER_WORKER, "errors", 2, tmp_path, timeout=90)


def test_engine_gauges_on_metrics_and_dropped_at_remesh(tmp_path):
    """``hvd_engine_*`` appear on ``/metrics`` once the engine runs
    (the ``EngineCollector`` at scrape time), ``/healthz`` reports the
    engine alive, and a shutdown/init cycle drops the old engine's
    gauges until the new one reports."""
    base, socks = reserve_ports(2)
    try:
        res = spawn_world(EAGER_WORKER, "engine", 2, tmp_path, extra_env={
            "HVD_TPU_METRICS_PORT": str(base)}, timeout=90)
    finally:
        for s in socks:
            s.close()
    assert int(res[0]["hits"][0]) > 0


def test_reinit_on_the_same_port_waits_for_rank0_store(tmp_path):
    """``init`` after ``shutdown`` on the world's own rendezvous port: a
    rank other than 0 leaves ``shutdown`` only once rank 0's store has
    closed, so three shutdown/init cycles form and reduce even when rank
    0 is slow to destroy its group; rank 1 waits about that long."""
    res = spawn_world(EAGER_WORKER, "reinit", 2, tmp_path, extra_env={
        "HVD_TEST_DESTROY_DELAY_S": "1.5"}, timeout=120)
    waits = res[1]["waits"]
    assert waits.shape == (3,)
    assert all(1.4 < w < 10.0 for w in waits), waits


def test_stalled_rank_autopsy_names_the_tensor_and_rank(tmp_path):
    """A tensor rank 1 never submits: rank 0's autopsy ``suspects`` name
    it and rank 1, and the stall shutdown fails the wait instead of
    hanging."""
    res = spawn_world(EAGER_WORKER, "stall", 2, tmp_path, extra_env={
        "HOROVOD_STALL_CHECK_TIME_SECONDS": "1",
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "4",
        "HVD_TPU_AUTOPSY_DIR": str(tmp_path / "autopsy")}, timeout=90)
    summary = json.loads(res[0]["summary"].tobytes())
    stuck = [s for s in summary["suspects"] if s["tensor"] == "stuck"]
    assert stuck and stuck[0]["missing_ranks"] == [1], summary["suspects"]
    assert stuck[0]["ready_ranks"] == [0]
