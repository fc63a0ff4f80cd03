"""The port's chaos seams at their call sites, on the CPU, held against the
JAX package's: the KV client rides a blackout shorter than its retry
budget and surfaces a longer one; a partition refuses only requests across
its cut and heals when its window closes; the checkpoint writer's injected
``io_error`` surfaces at the next ``wait``; ``apply_injection`` on the tiny
flagship's gradients equals the JAX ``apply_injection`` on the same arrays;
a grad NaN skips exactly its step through ``GuardedStep``, the overlap
engine and the pipeline (JAX ``tests/test_integrity.py:199, :268``); and
the port's core in a two-rank world under a ``transport.recv`` delay and a
``transport.send`` bit_flip gives what the JAX core gives."""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import (build_core, launch_env_world,  # noqa: E402
                               spawn_world, worker_main)

GRAD_NAN_AT = 3
STEPS = 6
L, D = 4, 6


def toy():
    """Seeded layer-major parameters and STEPS batches of 8 rows."""
    rng = np.random.RandomState(5)
    params = {"w": (rng.randn(L, D, D) * 0.3).astype(np.float32),
              "b": (rng.randn(L, D) * 0.1).astype(np.float32)}
    batches = [(rng.randn(8, D).astype(np.float32),
                rng.randn(8, D).astype(np.float32)) for _ in range(STEPS)]
    return params, batches


# -- worker side (no JAX) ---------------------------------------------------------

def _w_guard_paths():
    """A world of 2 armed with a grad NaN at step GRAD_NAN_AT on every rank:
    the overlap engine (dp 2) and the pipeline (pp 2) each skip exactly
    that step; a clean run without its batch lands on the same bytes."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.train.pipeline import make_pipeline_train_step
    params, batches = toy()
    out = {"armed": np.array(chaos.grad_rules_armed())}

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    def mse(y, t):
        return torch.mean((y - t) ** 2)

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(params["w"]))
            self.b = torch.nn.Parameter(torch.tensor(params["b"]))

        def forward(self, x):
            for i in range(L):
                x = torch.tanh(x @ self.w[i] + self.b[i])
            return x

    def overlap(skip_at=None):
        mesh = hvd.build_mesh(dp=hvd.size())
        model = Stack()
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = hvd.make_overlap_train_step(
            lambda m, mb: mse(m(mb[0]), mb[1]), mesh, n_micro=2)
        r = hvd.rank()
        for i, (x, t) in enumerate(batches):
            if i != skip_at:
                step(model, opt, (torch.from_numpy(x[r::2]),
                                  torch.from_numpy(t[r::2])))
        step.flush()
        return step.skipped, {k: v.detach().numpy().copy()
                              for k, v in model.state_dict().items()}

    def pipeline(skip_at=None):
        mesh = hvd.build_mesh(dp=1, pp=2)
        step = make_pipeline_train_step(layer_fn, mse, n_layers=L,
                                        mesh=mesh, pp=2, n_micro=4,
                                        device="cpu")
        p = step.prepare_params(params)
        opt = torch.optim.Adam(p.parameters(), lr=0.05)
        for i, (x, t) in enumerate(batches):
            if i != skip_at:
                p, opt, _ = step(p, opt, (torch.from_numpy(x),
                                          torch.from_numpy(t)))
        step.flush()
        return step.skipped, {k: v.numpy() for k, v in
                              step.restore_params(p).items()}

    for name, fn in (("overlap", overlap), ("pipeline", pipeline)):
        chaos.install(rank=hvd.rank())
        skipped, faulted = fn()
        chaos.uninstall()
        ref_skipped, ref = fn(skip_at=GRAD_NAN_AT)
        out[f"{name}_skipped"] = np.array([skipped, ref_skipped])
        for k in faulted:
            out[f"{name}_faulted_{k}"] = faulted[k]
            out[f"{name}_ref_{k}"] = ref[k]
    return out


if __name__ == "__main__":
    sys.exit(worker_main({"guard_paths": _w_guard_paths}, sys.argv[1:]))


# -- the tests (JAX side in this process) ------------------------------------------

import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu import chaos as j_chaos  # noqa: E402

from horovod_tpu_torch import chaos as t_chaos  # noqa: E402

GRAD_PLAN = {"faults": [{"seam": "grad", "kind": "nan",
                         "start": GRAD_NAN_AT, "stop": GRAD_NAN_AT + 1}]}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("HVD_TPU_FAULT_PLAN", "HVD_TPU_FAULT_SEED",
                 "HVD_TPU_CHAOS_TRANSPORT"):
        monkeypatch.delenv(name, raising=False)
    j_chaos.uninstall()
    t_chaos.uninstall()
    yield
    j_chaos.uninstall()
    t_chaos.uninstall()


def _arm(monkeypatch, plan, rank=0):
    monkeypatch.setenv("HVD_TPU_FAULT_PLAN", json.dumps(plan))
    j_chaos.install(rank=rank)
    t_chaos.install(rank=rank)


KV = {"jax": "horovod_tpu.runner.http_kv",
      "port": "horovod_tpu_torch.runner.http_kv"}
CHAOS = {"jax": j_chaos, "port": t_chaos}


def _kv(pkg):
    import importlib
    return importlib.import_module(KV[pkg])


@pytest.mark.parametrize("pkg", sorted(KV))
def test_kv_blackout_rides_retries(monkeypatch, pkg):
    kv = _kv(pkg)
    srv = kv.KVStoreServer()
    srv.start()
    try:
        _arm(monkeypatch, {"faults": [{"seam": "kv.request",
                                       "kind": "blackout", "start": 1,
                                       "stop": 3}]})
        kv.kv_put("127.0.0.1", srv.port, "s", "k", b"v")   # invocation 0
        # invocations 1 and 2 black out; a retry reaches 3 and succeeds
        assert kv.kv_get("127.0.0.1", srv.port, "s", "k") == b"v"
        assert CHAOS[pkg].engine().injected_total == 2
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", sorted(KV))
def test_kv_blackout_longer_than_budget_surfaces(monkeypatch, pkg):
    from urllib.error import URLError
    kv = _kv(pkg)
    srv = kv.KVStoreServer()
    srv.start()
    try:
        _arm(monkeypatch, {"faults": [{"seam": "kv.request",
                                       "kind": "blackout"}]})
        with pytest.raises((OSError, URLError)):
            kv.kv_get("127.0.0.1", srv.port, "s", "k", timeout=1.0)
        assert CHAOS[pkg].engine().injected_total >= 2
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", sorted(KV))
def test_kv_partition_refuses_only_across_the_cut_and_heals(monkeypatch,
                                                             pkg):
    kv = _kv(pkg)
    srv = kv.KVStoreServer()
    srv.start()
    try:
        _arm(monkeypatch, {"faults": [
            {"seam": "kv.partition", "kind": "partition",
             "groups": [[0, 1], ["driver"]], "start": 1, "stop": 3}]})
        seen = []
        for peer in (1, "driver", "driver", "driver"):
            try:
                kv.kv_put("127.0.0.1", srv.port, "s", "k", b"v",
                          peer=peer, attempts=1)
                seen.append("ok")
            except OSError as e:
                seen.append("partition" in str(e))
        # a hop inside the left side is clean (invocation 0); the cut
        # refuses the two invocations of its window, then heals
        assert seen == ["ok", True, True, "ok"]
    finally:
        srv.stop()


def test_checkpoint_writer_surfaces_the_injected_io_error(monkeypatch):
    from horovod_tpu_torch.checkpoint.writer import AsyncWriter
    _arm(monkeypatch, {"faults": [{"seam": "checkpoint.write",
                                   "kind": "io_error", "count": 1}]})
    w = AsyncWriter()
    done = []
    w.submit(lambda: done.append(1))
    with pytest.raises(OSError, match="chaos"):
        w.wait()
    assert done == []  # the injected error preempted the job
    w.submit(lambda: done.append(2))  # count 1: the next job goes through
    w.wait()
    assert done == [2]
    w.close()


def _flagship_grads():
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models.transformer import forward_loss_spmd
    _, (model, tokens, targets) = entry(device="cpu", tiny=True)
    loss, aux = forward_loss_spmd(model, tokens, targets, None)
    (loss + 0.01 * aux).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code,factor", [(0, 0.0), (1, 0.0), (2, 0.0),
                                         (3, 8.0), (3, 0.3)])
def test_apply_injection_matches_jax(code, factor, dtype):
    import jax.numpy as jnp

    from horovod_tpu.train.guard import apply_injection as j_apply
    from horovod_tpu_torch.train.guard import apply_injection
    grads = _flagship_grads()
    tdt = getattr(torch, dtype)
    tg = {k: g.to(tdt) for k, g in grads.items()}
    # copies: the port's injection works in place on tg
    jg = {k: jnp.asarray(g.float().numpy().copy()).astype(dtype)
          for k, g in tg.items()}
    j_out = {k: np.asarray(v.astype(jnp.float32)) for k, v in
             j_apply(jg, jnp.asarray([code, factor], jnp.float32)).items()}
    t_out = apply_injection(tg, code, factor)
    assert t_out is tg
    for k in grads:
        a = j_out[k]
        b = t_out[k].float().numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6, atol=0,
                                   err_msg=k)
    if code == 1:
        assert all(torch.isnan(g).all() for g in t_out.values())


def _guarded_run(skip_at=None):
    from horovod_tpu_torch.train.guard import (GuardedStep, GuardSpec,
                                               guarded_apply)
    params, batches = toy()
    w = torch.nn.Parameter(torch.from_numpy(params["w"][0]))
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)

    def fn(model, optimizer, batch):
        optimizer.zero_grad()
        loss = torch.mean((torch.tanh(batch[0] @ model) - batch[1]) ** 2)
        loss.backward()
        return model, optimizer, loss.detach(), guarded_apply(
            optimizer, GuardSpec())

    step = GuardedStep(fn, GuardSpec(), canary=None)
    for i, (x, t) in enumerate(batches):
        if i != skip_at:
            step(w, opt, (torch.from_numpy(x), torch.from_numpy(t)))
    step.flush()
    return step, w.detach().numpy().copy()


def test_guarded_step_skips_exactly_the_faulted_step(monkeypatch):
    """A grad NaN at step 3 is one skipped step: the final parameters
    equal a clean run without batch 3, bit for bit; the skip lands in the
    flight ring and one skip does not escalate."""
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.metrics import anomaly
    _arm(monkeypatch, GRAD_PLAN)
    step, faulted = _guarded_run()
    assert step.skipped == 1 and np.all(np.isfinite(faulted))
    key = 'hvd_chaos_injected_total{kind="nan",seam="grad"}'
    from horovod_tpu_torch.metrics.registry import default_registry
    assert default_registry().snapshot()[key]["value"] >= 1
    t_chaos.uninstall()
    ref_step, ref = _guarded_run(skip_at=GRAD_NAN_AT)
    assert ref_step.skipped == 0
    np.testing.assert_array_equal(faulted, ref)
    assert any(e["kind"] == "guard_skip" and e.get("step") == GRAD_NAN_AT
               for e in recorder().events())
    assert not [f for f in anomaly.recent_findings()
                if f["kind"] == "grad_nonfinite" and f.get("step") ==
                GRAD_NAN_AT and f.get("consecutive") == 1]


def test_no_grad_rule_evaluates_nothing(monkeypatch):
    """With a plan but no grad rule for this rank, a step never touches
    the injection (no extra launch on the card)."""
    from horovod_tpu_torch.train import guard
    _arm(monkeypatch, {"faults": [{"seam": "grad", "kind": "inf",
                                   "rank": 5}]})

    def boom(*a, **k):
        raise AssertionError("apply_injection ran without a rule")

    monkeypatch.setattr(guard, "apply_injection", boom)
    step, w = _guarded_run()
    assert step.skipped == 0 and np.all(np.isfinite(w))


def test_guard_skip_is_exact_in_the_overlap_engine_and_the_pipeline(
        tmp_path):
    res = spawn_world(__file__, "guard_paths", 2, tmp_path,
                      extra_env={"HVD_TPU_FAULT_PLAN":
                                 json.dumps(GRAD_PLAN)},
                      timeout=150)
    for r in res:
        assert bool(r["armed"])
        for name in ("overlap", "pipeline"):
            assert r[f"{name}_skipped"].tolist() == [1, 0], name
            keys = [k for k in r if k.startswith(f"{name}_faulted_")]
            assert keys
            for k in keys:
                np.testing.assert_array_equal(
                    r[k], r[k.replace("_faulted_", "_ref_")], err_msg=k)
    for k in res[0]:
        if k.startswith("overlap_faulted_"):
            np.testing.assert_array_equal(res[0][k], res[1][k])


def test_transport_chaos_matches_the_jax_core(tmp_path):
    """A ``transport.recv`` delay (counted by the core) leaves the grouped
    allreduce equal to its host reference, and a ``transport.send``
    bit_flip is caught by the wire checksum on rank 0: the same counters in
    both packages, each rank's error of a class its core may surface there
    (in the JAX core rank 0's class is a race, ROADMAP queue 3 item 22; the
    port's names the checksum), and a checksum error the same text in
    both."""
    import torch_port_chaos_worker as w
    build_core()
    out = {}
    for pkg in ("jax", "port"):
        env = {"HVD_TPU_FAULT_PLAN": json.dumps(w.PLAN)}
        if pkg == "jax":
            from horovod_tpu.core import core_available
            if not core_available():
                # the JAX package's own build is absent: its binding over
                # the port's build of the same sources
                from horovod_tpu_torch.core import library_path
                env["HVD_TPU_CORE_LIB"] = library_path()
        d = tmp_path / pkg
        d.mkdir()
        launch_env_world([w.__file__, "--pkg", pkg, "--out", str(d)], 2, d,
                         env, name=pkg, timeout=120)
        out[pkg] = [json.load(open(d / f"{pkg}.rank{r}.json"))
                    for r in range(2)]
    for r in range(2):
        j, t = out["jax"][r], out["port"][r]
        for key in ("warm", "grouped", "grouped_equal", "chaos_injected",
                    "checksum_failures"):
            assert t[key] == j[key], (r, key)
        assert t["grouped_equal"]
        for pkg in ("jax", "port"):
            err = out[pkg][r]["error"]
            assert w.error_class(err) in w.ERROR_CLASSES[pkg][r], \
                (pkg, r, err)
        if w.error_class(t["error"]) == w.error_class(j["error"]) == \
                "checksum":
            assert t["error"] == j["error"], r
    assert out["port"][1]["chaos_injected"] == 4
    assert out["port"][0]["checksum_failures"] == 1


def test_port_rank0_names_the_checksum_in_every_run(tmp_path):
    """ROADMAP queue 3 item 22: after rank 1's corrupted frame, the port's
    rank 0 fails with the checksum message in each of three worlds, whether
    its collective thread was receiving from rank 1 or sending to it when
    the reader shut the socket (the JAX core names ``socket send failed``
    in the second case)."""
    import torch_port_chaos_worker as w
    build_core()
    errors = []
    for i in range(3):
        d = tmp_path / f"run{i}"
        d.mkdir()
        launch_env_world([w.__file__, "--pkg", "port", "--out", str(d)], 2,
                         d, {"HVD_TPU_FAULT_PLAN": json.dumps(w.PLAN)},
                         name="port", timeout=120)
        res = [json.load(open(d / f"port.rank{r}.json")) for r in range(2)]
        assert res[0]["checksum_failures"] == 1, (i, res)
        assert w.error_class(res[1]["error"]) in w.ERROR_CLASSES["port"][1]
        errors.append(res[0]["error"])
    assert [w.error_class(e) for e in errors] == ["checksum"] * 3, errors
    assert len(set(errors)) == 1, errors


def test_step_kill_and_grad_nan_healed_under_the_port_driver(tmp_path):
    """Three gloo ranks of the tiny flagship under the soak plan: every
    rank's guard skips the NaN step with its state bit-equal, the injected
    write error surfaces at its save and the next save commits, the
    blackout is ridden out, rank 1 is killed once and replaced in place;
    each process's chaos counters equal the plan's schedule and the
    replicas end bit-identical."""
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.runner.elastic import journal
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.hosts import HostInfo
    out = tmp_path / "soak"
    out.mkdir()
    cmd = worker.command(out, "--device", "cpu", "--tiny", "--steps", 6,
                         "--rows", 2, "--guard", "--ckpt-every", 2)
    rc, driver, _secs = worker.run_driver(
        FixedHosts([HostInfo("localhost", 3)]), cmd, str(out), min_np=2,
        max_np=3, reset_limit=3, timeout=100,
        env={"HVD_TPU_FAULT_PLAN": json.dumps(worker.soak_plan(out)),
             "HVD_TPU_GLOO_TIMEOUT_SECONDS": "60"})
    evs = worker.events(str(out))
    assert rc == 0, evs
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = {e["rank"]: e for e in evs if e["kind"] == "done"}
    skips = [e for e in evs if e["kind"] == "guard_skip"]
    ckpts = [e for e in evs if e["kind"] == "ckpt"]
    first = {b["pid"] for b in boots if b["generation"] == "0"}
    replacement = [b for b in boots if b["pid"] not in first]
    assert len(boots) == 4 and len(replacement) == 1, boots
    assert sorted(dones) == [0, 1, 2] and all(
        d["size"] == 3 and d["step"] == 6 for d in dones.values()), dones
    killed = first - {d["pid"] for d in dones.values()}
    assert len(killed) == 1
    ticks = [e for e in evs if e["kind"] == "tick" and e["pid"] in killed]
    assert ticks[-1]["step"] == 3 and ticks[-1]["rank"] == 1
    assert sorted(e["rank"] for e in skips) == [0, 1, 2]
    assert all(e["step"] == 3 and e["expected"] and e["same_state"]
               for e in skips), skips
    assert [(e["step"], e["ok"]) for e in ckpts] == [(2, False), (4, True),
                                                     (6, True)]
    assert "chaos" in ckpts[0]["error"]
    for r, d in dones.items():
        # the plan's schedule, per process: the blackout's two requests
        # each time it armed (a survivor renumbered in the heal arms
        # again), the NaN once a rank (the {rank} markers keep it off
        # the replacement), the write error on rank 0
        want = {"kv.request/blackout": 2 * d["chaos"]["armed"]}
        if d["pid"] in first:
            want["grad/nan"] = 1
        if r == 0:
            want["checkpoint.write/io_error"] = 1
        assert d["chaos"]["injected"] == want, (r, d["chaos"])
    assert len({d["digest"] for d in dones.values()}) == 1
    jstate = journal.load(os.path.join(str(out), "journal",
                                       journal.JOURNAL_NAME))
    assert jstate.world_gen == driver.final_generation
    assert "FAILURE" in {r["state"] for r in jstate.exits.values()}
