"""The port's replica canary, guard escalation and training-loop services
against the JAX package's, on the CPU: ``param_digest`` equals the JAX
digest for the same fp32 and bf16 values; ``divergent_ranks``, the tie and
the single-process no-op (``tests/test_integrity.py:354-440``); the
``grad_nonfinite`` escalation at the JAX ``GuardObserver``'s steps; the
warmup schedule's values; and, in a gloo world of 4 at ``{dp:2, tp:2}``,
digests equal across the dp replicas of each shard (and different across
tp), ``ReplicaCanary`` over the dp axis silent on equal replicas and
reporting a tie after one element moves, ``BroadcastGlobalVariables
Callback`` and ``MetricAverageCallback``.

The gloo ranks run ``python tests/test_torch_port_canary.py --worker
dp2tp2 --out DIR``, importing no JAX.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import worker_main  # noqa: E402


def _tiny_cfg():
    import dataclasses

    from horovod_tpu_torch.entry import _flagship_cfg
    return dataclasses.replace(_flagship_cfg(tiny=True), n_layers=2)


# -- the worker (torch only) ---------------------------------------------------

def _w_dp2tp2():
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.models import (Transformer, adamw, init_params,
                                          shard_params)
    from horovod_tpu_torch.train.callbacks import (
        BroadcastGlobalVariablesCallback, MetricAverageCallback)

    r = hvd.rank()
    cfg = _tiny_cfg()
    mesh = hvd.build_mesh(dp=2, tp=2)
    # every rank starts from other weights; tp ranks hold other blocks, so
    # each dp pair of replicas is made equal from its dp root
    model = Transformer(cfg, "cpu", mesh)
    model.load_state_dict(shard_params(
        init_params(np.random.RandomState(10 + r), cfg), cfg, mesh))
    res = {"before": np.array(hvd.param_digest(model))}
    dp = mesh.axis("dp")
    _bcast_axis(model, dp)
    res["digest"] = np.array(hvd.param_digest(model))
    canary = hvd.ReplicaCanary(every=1)
    res["clean_findings"] = np.array(len(canary.check(1, model, dp)))
    if r == 2:
        with torch.no_grad():
            model.layers["wq"].view(-1)[0] += 1e-3
    res["odd_findings"] = np.array(len(canary.check(2, model, dp)))
    reg = hvd.metrics_snapshot()["registry"]
    res["checks"] = np.array(reg["hvd_canary_checks_total"]["value"])
    res["divergence"] = np.array(
        reg.get("hvd_canary_divergence_total", {}).get("value", 0.0))
    res["mismatch_steps"] = np.array(
        [e["step"] for e in recorder().events()
         if e["kind"] == "canary_mismatch"], dtype=np.int64)

    # the world's services, on a model without a mesh
    whole = Transformer(cfg, "cpu")
    whole.load_state_dict(_full_sd(cfg, 20 + r))
    opt = adamw(whole.parameters())
    if r != 0:
        opt.param_groups[0]["lr"] = 0.5
    BroadcastGlobalVariablesCallback(0).on_train_begin(whole, opt)
    res["bcast_digest"] = np.array(hvd.param_digest(whole))
    res["bcast_lr"] = np.array(opt.param_groups[0]["lr"])
    logs = MetricAverageCallback().on_epoch_end(
        {"loss": float(r), "n": r + 1, "tag": f"rank{r}"})
    res["avg_loss"] = np.array(logs["loss"])
    res["avg_n"] = np.array(logs["n"])
    res["tag"] = np.array(logs["tag"] == f"rank{r}")
    return res


def _full_sd(cfg, seed):
    from horovod_tpu_torch.models import from_jax_params, init_params
    return from_jax_params(init_params(np.random.RandomState(seed), cfg))


def _bcast_axis(model, axis):
    """Broadcast a model's tensors from position 0 of ``axis``."""
    import torch.distributed as dist
    for t in model.state_dict().values():
        dist.broadcast(t, src=axis.ranks[0], group=axis.group)


if __name__ == "__main__":
    sys.exit(worker_main({"dp2tp2": _w_dp2tp2}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.train import callbacks as jax_callbacks  # noqa: E402
from horovod_tpu.train import guard as jax_guard  # noqa: E402

from horovod_tpu_torch.diagnostics.flight_recorder import recorder  # noqa: E402
from horovod_tpu_torch.metrics import anomaly  # noqa: E402
from horovod_tpu_torch.metrics.registry import default_registry  # noqa: E402
from horovod_tpu_torch.models import Transformer  # noqa: E402
from horovod_tpu_torch.train import callbacks  # noqa: E402
from horovod_tpu_torch.train.guard import (GuardedStep, GuardSpec,  # noqa: E402
                                           ReplicaCanary, divergent_ranks,
                                           param_digest)


@pytest.fixture(autouse=True)
def fresh_observability():
    default_registry().clear()
    recorder().clear()
    anomaly.reset()
    yield
    default_registry().clear()
    recorder().clear()
    anomaly.reset()


def _tree(rng):
    return {"w": rng.randn(8, 400).astype(np.float32),
            "b": rng.randn(8).astype(np.float32),
            "layers": [rng.randn(3, 5).astype(np.float32)], "n": 3}


def test_param_digest_equals_jax_fp32():
    tree = _tree(np.random.RandomState(3))
    want = jax_guard.param_digest(tree)
    assert param_digest(tree) == want
    as_torch = {"w": torch.from_numpy(tree["w"]),
                "b": torch.from_numpy(tree["b"]),
                "layers": [torch.from_numpy(tree["layers"][0])], "n": 3}
    assert param_digest(as_torch) == want
    moved = dict(as_torch, w=as_torch["w"].clone())
    moved["w"][0, 0] += 1e-6
    assert param_digest(moved) != want
    assert param_digest(as_torch) == want       # no hidden state


def test_param_digest_equals_jax_bf16():
    tree = _tree(np.random.RandomState(4))
    jtree = {k: (jnp.asarray(v).astype(jnp.bfloat16) if k != "n" else v)
             for k, v in tree.items() if k != "layers"}
    ttree = {k: (torch.from_numpy(v).to(torch.bfloat16) if k != "n" else v)
             for k, v in tree.items() if k != "layers"}
    assert param_digest(ttree) == jax_guard.param_digest(jtree)


def test_param_digest_of_a_model_is_its_parameter_tree():
    from __graft_entry__ import _flagship_cfg as jax_cfg
    from horovod_tpu.models import init_params as jax_init_params
    from horovod_tpu_torch.models import from_jax_params
    params = jax_init_params(np.random.RandomState(0), jax_cfg(tiny=True), 1)
    from horovod_tpu_torch.entry import _flagship_cfg
    model = Transformer(_flagship_cfg(tiny=True), device="cpu")
    model.load_state_dict(from_jax_params(params))
    assert param_digest(model) == jax_guard.param_digest(params)


def test_canary_majority_attribution():
    for digests in ([7, 7, 9], [9, 7, 7, 7], [7, 7, 9, 9, 7], [7, 7],
                    [7, 9], [7, 7, 9, 9], [1, 2, 3], [5]):
        assert divergent_ranks(digests) == \
            jax_guard.divergent_ranks(digests), digests
    assert divergent_ranks([7, 7, 9]) == [2]
    assert divergent_ranks([7, 7, 9, 9, 7]) == [2, 3]
    assert divergent_ranks([7, 9]) == []


def test_canary_unattributable_mismatch_still_counted(monkeypatch):
    """Digests that disagree with no strict majority convict nobody, but
    the mismatch is counted and flight-recorded."""
    import torch.distributed as dist

    from horovod_tpu_torch.common import basics
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "rank", lambda: 0)
    monkeypatch.setattr(basics, "backend", lambda: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)

    def gather(parts, mine, group=None):
        for p, v in zip(parts, (7, 9)):
            p.fill_(v)
    monkeypatch.setattr(dist, "all_gather", gather)
    findings = ReplicaCanary(every=1).check(4, {"w": np.ones(4)})
    assert findings == []
    snap = default_registry().snapshot()
    assert snap["hvd_canary_divergence_total"]["value"] == 1
    assert snap["hvd_canary_checks_total"]["value"] == 1
    assert any(e["kind"] == "canary_mismatch" and e["step"] == 4
               for e in recorder().events())


def test_canary_noop_without_world():
    c = ReplicaCanary(every=2)
    assert c.maybe_check(4, {"w": np.ones(4)}) == []
    assert c.maybe_check(3, {"w": np.ones(4)}) == []
    assert ReplicaCanary.from_env() is None


def test_grad_nonfinite_escalation_matches_jax(monkeypatch):
    """Every ``escalate_after``-th consecutive skip reports a
    ``grad_nonfinite`` finding, at the JAX ``GuardObserver``'s steps and
    counts; a good step resets the run."""
    monkeypatch.setenv("HVD_TPU_GUARD_ESCALATE", "2")
    oks = [True, False, False, False, False, True, False, False]
    jax_reported = []
    import horovod_tpu.metrics.anomaly as jax_anomaly
    monkeypatch.setattr(jax_anomaly, "report_finding",
                        lambda kind, **f: jax_reported.append((kind, f)))
    obs = jax_guard.GuardObserver(jax_guard.GuardSpec.from_env())
    for i, ok in enumerate(oks):
        obs.observe(i, ok)

    spec = GuardSpec.from_env()
    assert spec.escalate_after == 2
    it = iter(oks)
    step = GuardedStep(lambda m, o, b: (m, o, 0.0, next(it)), spec,
                       canary=None)
    for _ in oks:
        step(None, None, None)
    step.flush()
    got = [(f["kind"], {"step": f["step"], "consecutive": f["consecutive"]})
           for f in anomaly.recent_findings() if f["kind"] == "grad_nonfinite"]
    assert got == jax_reported and len(got) == 3
    assert step.skipped == obs.skipped == 6


def test_guarded_step_runs_the_canary_every_n(monkeypatch):
    seen = []

    class Spy(ReplicaCanary):
        def check(self, step, tree, axis=None):
            seen.append((step, tree, axis))
            return []

    step = GuardedStep(lambda m, o, b: (m, o, 0.0, True), GuardSpec(),
                       canary=Spy(every=2), canary_axis="dp-axis")
    for _ in range(5):
        step("model", None, None)
    assert seen == [(2, "model", "dp-axis"), (4, "model", "dp-axis")]
    monkeypatch.setenv("HVD_TPU_CANARY_EVERY", "3")
    assert GuardedStep(lambda *a: a, GuardSpec()).canary.every == 3


@pytest.mark.parametrize("world", [1, 4])
def test_warmup_schedule_equals_jax(monkeypatch, world):
    monkeypatch.setattr(jax_callbacks, "size", lambda: world)
    monkeypatch.setattr(callbacks, "size", lambda: world)
    kw = dict(warmup_epochs=2, steps_per_epoch=10)
    want = jax_callbacks.LearningRateWarmupCallback(0.1, **kw).schedule()
    cb = callbacks.LearningRateWarmupCallback(0.1, **kw)
    got = cb.schedule()
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([p], lr=7.0)
    sched = cb.scheduler(opt)
    for s in range(30):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(s)), rtol=1e-6)
        opt.step()
        sched.step()
    assert got(25) == pytest.approx(0.1 * world)


@pytest.fixture
def world_of_one(monkeypatch):
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    hvd.init()
    yield
    hvd.shutdown()


def test_services_in_a_world_of_one(world_of_one):
    """In a world of one the services change nothing (the JAX tests'
    single-process cases)."""
    cb = callbacks.MetricAverageCallback()
    assert cb.on_epoch_end({"loss": 1.5, "name": "x"}) == \
        {"loss": 1.5, "name": "x"}
    p = {"w": torch.ones(3)}
    out = callbacks.BroadcastGlobalVariablesCallback(0).on_train_begin(p)
    assert torch.equal(out["w"], torch.ones(3))


# ---------------------------------------- a {dp:2, tp:2} world of four


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    from test_torch_port_dp import spawn
    return spawn("dp2tp2", 4, tmp_path_factory.mktemp("dp2tp2"),
                 script=__file__)


def test_digests_agree_over_dp_and_differ_over_tp(world4):
    d = [int(r["digest"]) for r in world4]
    assert d[0] == d[2] and d[1] == d[3] and d[0] != d[1]
    assert len({int(r["before"]) for r in world4}) == 4


def test_canary_over_dp_silent_then_reports_the_tie(world4):
    for r, res in enumerate(world4):
        assert int(res["clean_findings"]) == 0
        assert int(res["odd_findings"]) == 0      # a tie convicts nobody
        assert float(res["checks"]) == 2.0
        hit = r in (0, 2)                          # rank 2's dp group
        assert float(res["divergence"]) == (1.0 if hit else 0.0)
        assert res["mismatch_steps"].tolist() == ([2] if hit else [])


def test_broadcast_and_metric_average_over_the_world(world4):
    assert len({int(r["bcast_digest"]) for r in world4}) == 1
    assert all(float(r["bcast_lr"]) == 1e-3 for r in world4)
    for res in world4:
        assert float(res["avg_loss"]) == 1.5
        assert float(res["avg_n"]) == 2.5
        assert bool(res["tag"])
