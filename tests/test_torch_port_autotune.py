"""The port's plan search against the JAX package's, on the CPU: the plan
space and its validation, the successive-halving controller, the CSV
trace, the fingerprint (equal to JAX's for the tiny flagship when both
list the same codecs), the plan cache's hygiene (a bad entry retunes,
never crashes), ``DistributedOptimizer(autotune=)``'s warm start, the
``HVD_TPU_AUTOTUNE_MESH`` default, and the two ``autotune=`` seams: the
overlap step (a world of one) and the pipeline step's parallelism search
(a gloo world of four). Searched steps are timed by an injected clock
that charges each plan a fixed cost, so no test depends on the box's
speed. Mirrors ``tests/test_autotune.py`` and the autotune part of
``tests/test_parallel_plan.py``.

The gloo world runs as ``python tests/test_torch_port_autotune.py
--worker ptune --out DIR``, importing no JAX.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import spawn_world, worker_main  # noqa: E402

if __name__ != "__main__":
    import logging

    import pytest
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.topology import MeshTopology, flat_topology
    from horovod_tpu_torch.parallel.plan import ParallelPlan
    from horovod_tpu_torch.train.autotune import (
        AutotuneController, AutotuneOptions, Plan, PlanCache,
        candidate_plans, invalidate_plan_cache, parallel_candidate_plans,
        plan_fingerprint, topology_key)

TUNE_L, TUNE_D = 8, 32


def tune_inputs():
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(TUNE_L, TUNE_D, TUNE_D) * 0.4).astype(
        np.float32)}
    x = rng.randn(64, TUNE_D).astype(np.float32)
    tgt = rng.randn(64, TUNE_D).astype(np.float32)
    return params, x, tgt


def plan_clock(costs, ctl_of):
    """A clock that a searched step reads twice (start, end): each end
    read advances it by the running plan's cost."""
    state = {"now": 0.0, "reads": 0}

    def clock():
        state["reads"] += 1
        if state["reads"] % 2 == 0:
            state["now"] += costs(ctl_of()._pending)
        return state["now"]
    return clock


# -- the worker (torch only) ---------------------------------------------------

def _w_ptune():
    """The parallelism search in a world of four: a warm cache locks with
    zero trials; a cached plan that cannot tile the batch retunes; a
    search locks the cheapest plan, then a second build locks it warm."""
    import tempfile

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.topology import (detect_topology,
                                                   flat_topology)
    from horovod_tpu_torch.parallel.plan import ParallelPlan
    from horovod_tpu_torch.train.autotune import (AutotuneOptions, PlanCache,
                                                  make_parallel_train_step,
                                                  plan_fingerprint,
                                                  topology_key)
    from horovod_tpu_torch.train.pipeline import make_pipeline_train_step

    params, x, tgt = tune_inputs()
    batch = (torch.from_numpy(x), torch.from_numpy(tgt))

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"])

    def mse(y, t):
        return ((y - t) ** 2).mean()

    def fresh():
        p = torch.nn.ParameterDict({k: torch.nn.Parameter(
            torch.from_numpy(v.copy())) for k, v in params.items()})
        return p, torch.optim.SGD(p.parameters(), lr=1e-2)

    out = {"rank": np.array(hvd.rank())}
    # every rank writes its own cache directory, with the same content
    base = tempfile.mkdtemp(prefix=f"ptune{hvd.rank()}_")
    topo = detect_topology(n=4)
    out["topo_flat"] = np.array(topo == flat_topology(4))
    fp = plan_fingerprint(fresh()[0], topology_key(topo, pp=0), 4)

    # (1) warm cache: zero trials
    warm_dir = os.path.join(base, "warm")
    want = ParallelPlan(dp=1, pp=4, schedule="interleaved", n_microbatches=8,
                        virtual_stages=2)
    PlanCache(warm_dir).store(fp, want)
    step = make_parallel_train_step(
        layer_fn, mse, n_layers=TUNE_L, device="cpu",
        autotune=AutotuneOptions(budget_steps=40, cache_dir=warm_dir))
    p, opt = fresh()
    _, _, loss = step(p, opt, batch)
    ctl = step.autotune
    out["warm_trials"] = np.array(ctl.trials)
    out["warm_from_cache"] = np.array(ctl.from_cache)
    out["warm_locked"] = np.array(ctl.locked_plan == want)
    out["warm_pinned"] = np.array(step.pin() is not None)
    out["warm_loss"] = np.array(float(loss))
    out["warm_changed"] = np.array(not np.array_equal(p["w"].detach().numpy(),
                                                      params["w"]))

    # (2) a cached plan that cannot tile the batch retunes
    stale_dir = os.path.join(base, "stale")
    stale = ParallelPlan(dp=2, pp=2, n_microbatches=48)
    PlanCache(stale_dir).store(fp, stale)
    plans = [ParallelPlan(dp=4, pp=1),
             ParallelPlan(dp=2, pp=2, n_microbatches=4)]
    costs = {plans[0]: 2.0, plans[1]: 1.0}
    holder = {}
    opts = AutotuneOptions(plans=plans, budget_steps=20, steps_per_trial=1,
                           cache_dir=stale_dir,
                           clock=plan_clock(costs.get,
                                            lambda: holder["s"].autotune))
    step = holder["s"] = make_parallel_train_step(
        layer_fn, mse, n_layers=TUNE_L, device="cpu", autotune=opts)
    p, opt = fresh()
    losses = []
    for _ in range(30):
        _, _, loss = step(p, opt, batch)
        losses.append(float(loss))
        if step.autotune.done:
            break
    ctl = step.autotune
    out["stale_done"] = np.array(ctl.done and not ctl.from_cache)
    out["stale_trials"] = np.array(ctl.trials)
    out["stale_locked"] = np.array(ctl.locked_plan == plans[1])
    out["stale_cached"] = np.array(PlanCache(stale_dir).load(fp) == plans[1])
    out["stale_losses"] = np.array(losses)

    # (3) search, then the same plan warm
    search_dir = os.path.join(base, "search")
    plans = [ParallelPlan(dp=4, pp=1),
             ParallelPlan(dp=2, pp=2, n_microbatches=4),
             ParallelPlan(dp=2, pp=2, schedule="gpipe", n_microbatches=4),
             ParallelPlan(dp=1, pp=4, schedule="interleaved",
                          n_microbatches=8, virtual_stages=2)]
    costs = dict(zip(plans, (4.0, 2.0, 3.0, 1.5)))
    opts = AutotuneOptions(plans=plans, budget_steps=60, steps_per_trial=1,
                           cache_dir=search_dir,
                           clock=plan_clock(costs.get,
                                            lambda: holder["s"].autotune))
    step = holder["s"] = make_parallel_train_step(
        layer_fn, mse, n_layers=TUNE_L, device="cpu", autotune=opts)
    p, opt = fresh()
    for _ in range(80):
        step(p, opt, batch)
        if step.autotune.done:
            break
    ctl = step.autotune
    out["search_locked"] = np.array(ctl.locked_plan == plans[3])
    out["search_steps"] = np.array(ctl.steps_used)
    out["search_trials"] = np.array(ctl.trials)
    # the pinned step trains on the locked layout from natural-order
    # parameters, as the search's wrapper did
    pinned = step.pin()
    lp = pinned.prepare_params({k: v.detach() for k, v in p.items()})
    dp = pinned.mesh.axis("dp")
    n = x.shape[0] // pinned.plan.dp
    rows = tuple(t[dp.index * n:(dp.index + 1) * n] for t in batch)
    _, _, loss = pinned(lp, torch.optim.SGD(lp.parameters(), lr=1e-2), rows)
    pinned.flush()
    out["pinned_loss"] = np.array(float(loss))
    warm = holder["s"] = make_parallel_train_step(
        layer_fn, mse, n_layers=TUNE_L, device="cpu", autotune=opts)
    p, opt = fresh()
    warm(p, opt, batch)
    out["search_warm"] = np.array(warm.autotune.from_cache
                                  and warm.autotune.trials == 0
                                  and warm.autotune.locked_plan == plans[3])
    # a pinned layout and the env default keep the searcher out
    pinned_step = make_pipeline_train_step(
        layer_fn, mse, n_layers=TUNE_L, device="cpu",
        plan=ParallelPlan(dp=2, pp=2, n_microbatches=4), mesh=pinned.mesh
        if pinned.plan.pp == 2 else None)
    out["plan_pins"] = np.array(type(pinned_step).__name__ ==
                                "PipelineTrainStep")
    return out


if __name__ == "__main__":
    sys.exit(worker_main({"ptune": _w_ptune}, sys.argv[1:]))


# -- Plan ----------------------------------------------------------------------

def test_plan_roundtrip_and_key():
    from horovod_tpu.train.autotune import Plan as JaxPlan
    p = Plan(1 << 20, "hier", "int8", 4096)
    assert Plan.from_dict(p.to_dict()) == p
    assert "hier/int8" in p.key
    assert p.to_dict() == JaxPlan(1 << 20, "hier", "int8", 4096).to_dict()
    assert p.key == JaxPlan(1 << 20, "hier", "int8", 4096).key


@pytest.mark.parametrize("kw", [
    dict(bucket_bytes=0),
    dict(bucket_bytes=1, algorithm="tree"),
    dict(bucket_bytes=1, codec="int4"),
    dict(bucket_bytes=1, algorithm="ring", codec="int8"),
    dict(bucket_bytes=1, small_floor=-1),
])
def test_plan_validation_rejects(kw):
    with pytest.raises(ValueError):
        Plan(**kw)


def test_candidate_plans_shape_and_equal_jax():
    from horovod_tpu.common.topology import MeshTopology as JaxTopology
    from horovod_tpu.train.autotune import candidate_plans as jax_candidates
    flat = candidate_plans(flat_topology(8))
    assert all(p.algorithm != "hier" for p in flat)
    hier = candidate_plans(MeshTopology(2, 4))
    assert any(p.algorithm == "hier" for p in hier)
    assert len(set(hier)) == len(hier)
    assert not any(p.algorithm == "psum" and p.codec == "none"
                   and p.small_floor > 0 for p in hier)
    base = Plan(123456, "ring", "none")
    assert candidate_plans(flat_topology(8), baseline=base)[0] == base
    for fp8 in (False, True):
        assert [p.key for p in candidate_plans(MeshTopology(2, 4),
                                               include_fp8=fp8)] == \
            [p.key for p in jax_candidates(JaxTopology(2, 4),
                                           include_fp8=fp8)]


# -- controller ----------------------------------------------------------------

def _drive(ctl, times):
    guard = 0
    while not ctl.done and guard < 10_000:
        ctl.end_step(times[ctl.begin_step()])
        guard += 1
    assert ctl.done, "controller never locked"


def test_controller_picks_fastest_plan():
    a, b, c = (Plan(1, "psum", "none"), Plan(2, "psum", "none"),
               Plan(3, "psum", "none"))
    ctl = AutotuneController([a, b, c], budget_steps=100, steps_per_trial=2)
    _drive(ctl, {a: 0.010, b: 0.004, c: 0.020})
    assert ctl.locked_plan == b
    assert ctl.best_seconds == pytest.approx(0.004)
    assert ctl.trials > 0 and ctl.steps_used <= 100
    assert not ctl.from_cache


def test_controller_warmup_steps_not_scored():
    a = Plan(1, "psum", "none")
    ctl = AutotuneController([a], budget_steps=10, steps_per_trial=2)
    ctl.begin_step()
    ctl.end_step(99.0)
    while not ctl.done:
        ctl.begin_step()
        ctl.end_step(0.005)
    assert ctl.best_seconds == pytest.approx(0.005)


def test_controller_budget_exhaustion_locks_best_scored():
    plans = [Plan(i + 1, "psum", "none") for i in range(10)]
    times = {p: 0.010 - 0.0005 * i for i, p in enumerate(plans)}
    ctl = AutotuneController(plans, budget_steps=6, steps_per_trial=2)
    _drive(ctl, times)
    assert ctl.locked_plan in plans[:2]
    assert ctl.steps_used <= 6


def test_controller_trims_to_budget_with_warning(caplog):
    plans = [Plan(i + 1, "psum", "none") for i in range(8)]
    with caplog.at_level(logging.WARNING):
        ctl = AutotuneController(plans, budget_steps=9, steps_per_trial=2)
    assert len(ctl._survivors) == 3
    assert any("dropping" in r.message for r in caplog.records)


def test_controller_csv_trace(tmp_path):
    a, b = Plan(1, "psum", "none"), Plan(2, "ring", "none")
    log_path = str(tmp_path / "trace.csv")
    ctl = AutotuneController([a, b], budget_steps=50, steps_per_trial=2,
                             log_path=log_path)
    _drive(ctl, {a: 0.002, b: 0.009})
    lines = open(log_path).read().strip().splitlines()
    assert lines[0] == ("round,bucket_bytes,algorithm,codec,small_floor,"
                        "plan,step_s,final")
    assert lines[-1].endswith(",1")
    assert any(",ring," in ln for ln in lines)


def test_csv_trace_rotates_old_schema(tmp_path):
    log_path = str(tmp_path / "trace.csv")
    with open(log_path, "w") as f:
        f.write("round,bucket_bytes,algorithm,codec,small_floor,"
                "step_s,final\n0,1,psum,none,0,0.001000,1\n")
    a, b = Plan(1, "psum", "none"), Plan(2, "psum", "none")
    ctl = AutotuneController([a, b], budget_steps=50, steps_per_trial=1,
                             log_path=log_path)
    _drive(ctl, {a: 0.002, b: 0.009})
    lines = open(log_path).read().strip().splitlines()
    assert lines[0] == ("round,bucket_bytes,algorithm,codec,"
                        "small_floor,plan,step_s,final")
    assert all(ln.count(",") == 7 for ln in lines)
    assert "0.001000" in open(log_path + ".v1").read()


def test_controller_records_metrics():
    from horovod_tpu_torch.metrics.registry import default_registry
    a, b = Plan(1, "psum", "none"), Plan(2, "psum", "int8")
    reg = default_registry()
    trials = reg.counter("hvd_autotune_trials_total",
                         help="scored mesh-autotune trial steps")
    before = trials.value
    ctl = AutotuneController([a, b], budget_steps=20, steps_per_trial=2)
    _drive(ctl, {a: 0.004, b: 0.002})
    assert trials.value - before == ctl.trials
    snap = reg.snapshot()
    assert snap["hvd_autotune_locked"]["value"] == 1.0
    assert snap['hvd_autotune_plan{algorithm="psum",codec="int8"}'][
        "value"] == 1.0
    assert snap['hvd_autotune_plan{algorithm="psum",codec="none"}'][
        "value"] == 0.0
    assert snap["hvd_autotune_best_step_seconds"]["value"] == \
        pytest.approx(0.002)


# -- fingerprint ---------------------------------------------------------------

def test_fingerprint_sensitivity():
    tree = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    fp = plan_fingerprint(tree, {"dp": 8}, 8)
    assert fp == plan_fingerprint(tree, {"dp": 8}, 8)
    assert fp != plan_fingerprint(tree, {"dp": 4}, 4)
    assert fp != plan_fingerprint(tree, {"dp": 4, "tp": 2}, 4)
    assert fp != plan_fingerprint({"w": torch.zeros(4, 5),
                                   "b": torch.zeros(4)}, {"dp": 8}, 8)
    assert fp != plan_fingerprint({"w": torch.zeros(4, 4,
                                                    dtype=torch.bfloat16),
                                   "b": torch.zeros(4)}, {"dp": 8}, 8)


def test_fingerprint_of_the_tiny_flagship_equals_jax():
    """The same document in both packages: the JAX parameter tree and the
    port's model (its parameters in JAX flatten order) fingerprint alike
    at every topology key, as long as both list the same codecs."""
    from horovod_tpu.common.topology import flat_topology as jax_flat
    from horovod_tpu.models import init_params as jax_init
    from horovod_tpu.train import autotune as jat
    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.train import autotune as tat
    from __graft_entry__ import _flagship_cfg as jax_cfg
    assert tat._codecs_available() == jat._codecs_available()
    tree = jax_init(np.random.RandomState(0), jax_cfg(tiny=True), 1)
    model = Transformer(_flagship_cfg(tiny=True), "cpu")
    for world, pp in ((1, 1), (8, 1), (8, 0), (8, 4)):
        assert plan_fingerprint(model, topology_key(flat_topology(world),
                                                    pp), world) == \
            jat.plan_fingerprint(tree, jat.topology_key(jax_flat(world), pp),
                                 world)
    assert plan_fingerprint(model, {"dp": 8}, 8) != plan_fingerprint(
        Transformer(_flagship_cfg(tiny=False), "meta"), {"dp": 8}, 8)


def test_topology_key_pp_dimension():
    topo = flat_topology(8)
    tree = {"w": torch.zeros(4, 4)}
    fps = {plan_fingerprint(tree, topology_key(topo, pp=p), 8)
           for p in (1, 0, 4)}
    assert len(fps) == 3


# -- plan cache hygiene --------------------------------------------------------

def test_cache_store_load_roundtrip(tmp_path):
    cache = PlanCache(str(tmp_path))
    plan = Plan(1 << 20, "hier", "int8", 4096)
    path = cache.store("f" * 64, plan, meta={"trials": 7})
    assert path and os.path.exists(path)
    assert cache.load("f" * 64) == plan
    assert cache.load("0" * 64) is None


def test_cache_roundtrips_parallel_plan_and_loads_jax_entries(tmp_path):
    from horovod_tpu.parallel.plan import ParallelPlan as JaxParallel
    from horovod_tpu.train.autotune import Plan as JaxPlan
    from horovod_tpu.train.autotune import PlanCache as JaxCache
    cache = PlanCache(str(tmp_path))
    plan = ParallelPlan(dp=2, pp=4, schedule="interleaved", n_microbatches=8,
                        virtual_stages=2, comms=Plan(1 << 20, "psum", "int8"))
    assert cache.store("a" * 64, plan)
    assert cache.load("a" * 64) == plan
    cache.store("b" * 64, Plan(4096, "ring", "none"))
    assert cache.load("b" * 64) == Plan(4096, "ring", "none")
    JaxCache(str(tmp_path)).store("c" * 64, JaxParallel(
        dp=2, pp=2, n_microbatches=4, comms=JaxPlan(4096, "psum", "int8")))
    assert cache.load("c" * 64) == ParallelPlan(
        dp=2, pp=2, n_microbatches=4, comms=Plan(4096, "psum", "int8"))
    assert JaxCache(str(tmp_path)).load("a" * 64).key == plan.key


def test_cache_truncated_json_retunes(tmp_path, caplog):
    cache = PlanCache(str(tmp_path))
    cache.store("a" * 64, Plan(1, "psum", "none"))
    with open(cache.path("a" * 64), "w") as f:
        f.write('{"version": 1, "plan": {"bucket')
    with caplog.at_level(logging.WARNING):
        assert cache.load("a" * 64) is None
    assert any("retuning" in r.message for r in caplog.records)


def test_cache_fingerprint_mismatch_retunes(tmp_path, caplog):
    cache = PlanCache(str(tmp_path))
    cache.store("b" * 64, Plan(1, "psum", "none"))
    os.replace(cache.path("b" * 64), cache.path("c" * 64))
    with caplog.at_level(logging.WARNING):
        assert cache.load("c" * 64) is None
    assert any("mismatch" in r.message for r in caplog.records)


def test_cache_wrong_version_retunes(tmp_path):
    cache = PlanCache(str(tmp_path))
    with open(cache.path("d" * 64), "w") as f:
        json.dump({"version": 999, "fingerprint": "d" * 64,
                   "plan": {"bucket_bytes": 1}}, f)
    assert cache.load("d" * 64) is None


def test_cache_invalid_plan_retunes(tmp_path):
    cache = PlanCache(str(tmp_path))
    with open(cache.path("e" * 64), "w") as f:
        json.dump({"version": 2, "fingerprint": "e" * 64,
                   "plan": {"bucket_bytes": 1, "algorithm": "warp"}}, f)
    assert cache.load("e" * 64) is None


def test_cache_unwritable_dir_degrades(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where the cache dir should be")
    assert PlanCache(str(target)).store("f" * 64,
                                        Plan(1, "psum", "none")) is None


def test_controller_try_cache_locks_with_zero_trials(tmp_path):
    cache = PlanCache(str(tmp_path))
    plan = Plan(7, "ring", "none")
    cache.store("9" * 64, plan)
    ctl = AutotuneController([Plan(1, "psum", "none")], budget_steps=10,
                             cache=cache, fingerprint="9" * 64)
    assert ctl.try_cache()
    assert ctl.locked_plan == plan and ctl.from_cache and ctl.trials == 0
    assert ctl.begin_step() == plan
    ctl.end_step(1.0)
    assert ctl.trials == 0


def test_invalidate_plan_cache(tmp_path):
    cache = PlanCache(str(tmp_path))
    for c in "ab":
        cache.store(c * 64, Plan(1, "psum", "none"))
    assert cache.invalidate("a" * 64) == 1
    assert invalidate_plan_cache(str(tmp_path)) == 1
    assert cache.load("b" * 64) is None
    assert invalidate_plan_cache("") == 0


# -- the parallel plan space -----------------------------------------------------

def test_parallel_candidate_plans_shape_and_equal_jax():
    from horovod_tpu.train.autotune import \
        parallel_candidate_plans as jax_parallel
    plans = parallel_candidate_plans(8, 8)
    assert plans[0] == ParallelPlan(dp=8, pp=1)
    assert len({p.key for p in plans}) == len(plans)
    assert any(p.pp == 4 and p.schedule == "interleaved" for p in plans)
    assert any(p.comms is not None and p.comms.codec == "int8"
               for p in plans)
    assert all(8 % p.pp == 0 and 8 % p.total_stages == 0 for p in plans)
    assert all(p.pp <= 4 for p in parallel_candidate_plans(8, 4))
    for world, layers in ((8, 8), (4, 8), (8, 4), (2, 6)):
        assert [p.to_dict() for p in parallel_candidate_plans(world,
                                                              layers)] == \
            [p.to_dict() for p in jax_parallel(world, layers)]


# -- a world of one: the seams ---------------------------------------------------

@pytest.fixture
def world1(monkeypatch, tmp_path):
    from horovod_tpu_torch.common.config import reset_config
    hvd.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK",
              "HVD_TPU_AUTOTUNE_MESH", "HVD_TPU_AUTOTUNE_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    hvd.init()
    yield
    hvd.shutdown()
    reset_config()


def _linear_params():
    return {"b": torch.zeros(4), "w": torch.ones(4, 4)}


def test_distributed_optimizer_autotune_warm_start(world1, tmp_path,
                                                   monkeypatch):
    """A cached plan for these parameters at this world gives the
    optimizer its bucket bytes and, wrapped in error feedback, its int8
    codec: the update is the quantized gradient times -lr."""
    from horovod_tpu_torch.common.config import reset_config
    from horovod_tpu_torch.metrics.registry import default_registry
    params = {k: torch.nn.Parameter(v) for k, v in _linear_params().items()}
    fp = plan_fingerprint(params, topology_key(flat_topology(1)), 1)
    PlanCache(str(tmp_path)).store(fp, Plan(4096, "psum", "int8"))
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_CACHE_DIR", str(tmp_path))
    reset_config()
    hits = default_registry().counter(
        "hvd_autotune_cache_hits_total",
        help="runs that started from a cached tuned plan with zero search "
             "trials")
    before = hits.value
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params.values(), lr=0.1),
        named_parameters=params.items(), autotune=True)
    assert hits.value == before + 1
    assert opt._hvd_ef and opt._hvd_codec.name == "int8"
    params["w"].grad = torch.full((4, 4), 0.5)
    params["b"].grad = torch.ones(4)
    opt.step()
    assert (params["w"].detach() - 1.0 + 0.05).abs().max() < 0.01


def test_distributed_optimizer_autotune_miss_keeps_settings(world1, tmp_path,
                                                            monkeypatch):
    from horovod_tpu_torch.common.config import reset_config
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_CACHE_DIR", str(tmp_path))
    reset_config()
    w = torch.nn.Parameter(torch.ones(3, 3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   named_parameters=[("w", w)],
                                   autotune=True)
    assert not opt._hvd_ef and opt._hvd_codec is hvd.Compression.none
    w.grad = torch.full((3, 3), 0.5)
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), 0.95, rtol=1e-6)


def test_distributed_optimizer_autotune_rejects_adasum(world1):
    w = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(ValueError, match="standard sync path"):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 op=hvd.Adasum, autotune=True)


def _overlap_model():
    rng = np.random.RandomState(0)
    model = torch.nn.ParameterDict({f"w{i}": torch.nn.Parameter(
        torch.from_numpy((rng.randn(16, 16) / 4).astype(np.float32)))
        for i in range(4)})
    x = torch.from_numpy(rng.randn(16, 16).astype(np.float32))
    y = torch.from_numpy(rng.randn(16, 16).astype(np.float32))

    def loss_fn(m, b):
        h = b[0]
        for i in range(4):
            h = torch.tanh(h @ m[f"w{i}"])
        return ((h - b[1]) ** 2).mean()
    return model, loss_fn, (x, y)


def test_autotune_mesh_env_enables_search_by_default(world1, monkeypatch):
    """``HVD_TPU_AUTOTUNE_MESH=1`` makes both factories search without
    touching call sites; a candidate's own build pins autotune off (no
    recursion), explicit ``autotune=False`` or ``plan=`` wins, and the
    env default skips Adasum instead of raising."""
    from horovod_tpu_torch.common.config import reset_config
    from horovod_tpu_torch.train.autotune import (AutotunedStep,
                                                  ParallelAutotunedStep)
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_MESH", "1")
    reset_config()
    mesh = hvd.build_mesh(dp=-1)
    model, loss_fn, batch = _overlap_model()
    step = hvd.make_overlap_train_step(loss_fn, mesh, guard=False)
    assert isinstance(step, AutotunedStep)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step(model, opt, batch)
    assert step.autotune is not None
    assert not isinstance(hvd.make_overlap_train_step(
        loss_fn, mesh, autotune=False), AutotunedStep)
    w = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(NotImplementedError, match="Adasum"):
        # the env default does not raise for Adasum's missing seam; the
        # port's Adasum itself is not there yet
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1), op=hvd.Adasum)
    pstep = hvd.make_pipeline_train_step(lambda p, x: x,
                                         lambda y, t: y.sum(), n_layers=2,
                                         device="cpu")
    assert isinstance(pstep, ParallelAutotunedStep)
    pinned = hvd.make_pipeline_train_step(
        lambda p, x: x, lambda y, t: y.sum(), n_layers=2, device="cpu",
        plan=ParallelPlan(dp=1, pp=1), mesh=mesh)
    assert not isinstance(pinned, ParallelAutotunedStep)


def test_overlap_autotune_converges_and_warm_cache_skips_search(world1,
                                                                tmp_path):
    """``make_overlap_train_step(..., autotune=...)`` over three plans, each
    step charged its plan's cost by the clock: the search locks the
    cheapest within its budget, trains all along (the loss falls), writes
    the cache, and a second build locks the same plan with zero trials;
    the trial and lock land on the registry and the CSV trace."""
    mesh = hvd.build_mesh(dp=-1)
    model, loss_fn, batch = _overlap_model()
    plans = [Plan(1 << 20, "psum", "none"), Plan(4096, "psum", "int8"),
             Plan(1 << 20, "ring", "none")]
    costs = dict(zip(plans, (3.0, 1.0, 2.0)))
    holder = {}
    opts = AutotuneOptions(plans=plans, budget_steps=12, steps_per_trial=2,
                           cache_dir=str(tmp_path / "cache"),
                           log_path=str(tmp_path / "trace.csv"),
                           clock=plan_clock(costs.get,
                                            lambda: holder["s"].autotune))
    step = holder["s"] = hvd.make_overlap_train_step(
        loss_fn, mesh, n_micro=2, autotune=opts, guard=False)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    losses = []
    for _ in range(14):
        _, _, loss = step(model, opt, batch)
        losses.append(float(loss))
    ctl = step.autotune
    assert ctl.done and ctl.steps_used <= 12 and ctl.trials > 0
    assert ctl.locked_plan == plans[1] and not ctl.from_cache
    assert ctl.best_seconds == pytest.approx(1.0)
    assert losses[-1] < losses[0]
    rows = open(tmp_path / "trace.csv").read().strip().splitlines()
    assert rows[-1].endswith(",1") and "psum/int8" in rows[-1]
    warm = holder["s"] = hvd.make_overlap_train_step(
        loss_fn, mesh, n_micro=2, autotune=opts, guard=False)
    warm(model, opt, batch)
    assert warm.autotune.from_cache and warm.autotune.trials == 0
    assert warm.autotune.locked_plan == plans[1]


# -- the parallelism search in a gloo world of four ------------------------------

@pytest.fixture(scope="module")
def ptune(tmp_path_factory):
    return spawn_world(__file__, "ptune", 4, tmp_path_factory.mktemp("pt"),
                       timeout=240)


def test_parallel_autotune_warm_cache_zero_trials(ptune):
    """A cached parallelism plan locks on the first call with zero trials,
    the step trains on it, and ``pin()`` gives the plan's own step."""
    for res in ptune:
        assert res["topo_flat"]
        assert int(res["warm_trials"]) == 0 and res["warm_from_cache"]
        assert res["warm_locked"] and res["warm_pinned"]
        assert np.isfinite(res["warm_loss"]) and res["warm_changed"]
        assert res["warm_loss"] == ptune[0]["warm_loss"]


def test_parallel_autotune_stale_cached_plan_retunes(ptune):
    """A cached plan that cannot tile this batch (the fingerprint covers
    the tree and world, not the batch) is passed over with a search, and
    the cache then holds the plan that won."""
    for res in ptune:
        assert res["stale_done"] and int(res["stale_trials"]) > 0
        assert res["stale_locked"] and res["stale_cached"]
        np.testing.assert_array_equal(res["stale_losses"],
                                      ptune[0]["stale_losses"])
        assert res["stale_losses"][-1] < res["stale_losses"][0]


def test_parallel_autotune_converges_and_warm_cache_skips_search(ptune):
    """Over four layouts (pure dp, 1F1B and GPipe at pp 2, interleaved at
    pp 4) the search locks the cheapest within its budget on every rank;
    the pinned step trains; a second build locks it warm with zero trials;
    an explicit plan keeps the searcher out."""
    for res in ptune:
        assert res["search_locked"] and int(res["search_steps"]) <= 60
        assert int(res["search_trials"]) > 0
        assert np.isfinite(res["pinned_loss"])
        assert res["search_warm"] and res["plan_pins"]
