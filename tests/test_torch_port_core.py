"""The port's native core against the JAX package's, on the CPU.

Each package runs its own build of the same ``cpp/`` sources in worlds of
2 and 3 processes (``torch_port_core_worker.py``): every eager op over
every dtype, bf16 included, gives the same bytes. The ``torch.distributed``
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


@pytest.mark.parametrize("n", [2, 3])
def test_port_core_is_bit_equal_to_the_jax_core(jax_results, tmp_path, n):
    """Every allreduce op (sum, min, max, product, average, scaled,
    Adasum), grouped allreduce, ragged allgather, broadcast from every
    root, uneven alltoall and reducescatter over fp32/fp64/fp16/bf16/
    int32/int64/uint8/int8 (and bool), plus join: the same bytes."""
    port = launch_core_world("port", n, tmp_path)
    for r in range(n):
        a, b = jax_results[n][r], port[r]
        assert sorted(a) == sorted(b)
        differ = [k for k in a if not np.array_equal(a[k], b[k])]
        assert not differ, differ
        assert int(b["responses_executed"][0]) > 0


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
