"""The port's schedule tables and parallelism plan against the JAX
package's, on the CPU, in one process: ``interleaved_tables``,
``schedule_ticks``, ``bubble_fraction``, ``stage_layout_permutation``
and ``ParallelPlan`` (validation, ``key``, ``to_dict``) equal JAX's over
a grid of (S, v, M), and a plan written by either package loads in the
other; the port's own tick schedules (GPipe, 1F1B, interleaved) are
valid, and 1F1B holds at most ``S − s`` microbatches on stage ``s``;
``compile_step_with_plan`` binds a step to its mesh."""

import numpy as np
import pytest

from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu.parallel.plan import ParallelPlan as JaxPlan
from horovod_tpu.train.autotune import Plan as JaxCommPlan
from horovod_tpu.train.pipeline import \
    stage_layout_permutation as jax_permutation

from horovod_tpu_torch.parallel import pipeline as tpipe
from horovod_tpu_torch.parallel.plan import (ParallelPlan,
                                             compile_step_with_plan,
                                             plan_from_dict)
from horovod_tpu_torch.train.autotune import Plan
from horovod_tpu_torch.train.pipeline import stage_layout_permutation

GRID = [(S, v, M) for S in (2, 3, 4) for v in (1, 2, 3) for M in
        (1, 2, 3, 4, 5, 8)]


@pytest.mark.parametrize("S,v,M", GRID)
def test_interleaved_tables_equal_jax(S, v, M):
    want = jpipe.interleaved_tables(S, v, M)
    got = tpipe.interleaved_tables(S, v, M)
    assert got["ticks"] == want["ticks"]
    assert got["rings"] == want["rings"]
    assert got["bubble_fraction"] == want["bubble_fraction"]
    assert sorted(got["tables"]) == sorted(want["tables"])
    for k, a in want["tables"].items():
        np.testing.assert_array_equal(got["tables"][k], np.asarray(a),
                                      err_msg=k)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_ticks_and_bubble_equal_jax(schedule):
    for S, v, M in GRID:
        v = v if schedule == "interleaved" else 1
        assert tpipe.schedule_ticks(schedule, S, M, v) == \
            jpipe.schedule_ticks(schedule, S, M, v)
        assert tpipe.bubble_fraction(schedule, S, M, v) == \
            jpipe.bubble_fraction(schedule, S, M, v)
    with pytest.raises(ValueError):
        tpipe.schedule_ticks("pipedream", 2, 4)


def test_stage_layout_permutation_equals_jax():
    for L in (4, 8, 12, 24):
        for pp in (1, 2, 3, 4):
            for v in (1, 2, 3):
                if L % (pp * v):
                    with pytest.raises(ValueError):
                        stage_layout_permutation(L, pp, v)
                    continue
                np.testing.assert_array_equal(
                    stage_layout_permutation(L, pp, v),
                    jax_permutation(L, pp, v))
    assert stage_layout_permutation(8, pp=2, virtual_stages=2).tolist() \
        == [0, 1, 4, 5, 2, 3, 6, 7]


PLANS = [dict(dp=8, pp=1), dict(dp=2, pp=4, n_microbatches=8),
         dict(dp=4, pp=2, schedule="gpipe", n_microbatches=4),
         dict(dp=2, pp=4, schedule="interleaved", n_microbatches=8,
              virtual_stages=2),
         dict(dp=2, pp=2, n_microbatches=4, comms=(1 << 20, "psum", "int8")),
         dict(dp=1, pp=2, schedule="interleaved", n_microbatches=4,
              virtual_stages=2, comms=(4096, "ring", "none", 32768))]


def _both(kw):
    kw = dict(kw)
    comms = kw.pop("comms", None)
    return (ParallelPlan(**kw, comms=Plan(*comms) if comms else None),
            JaxPlan(**kw, comms=JaxCommPlan(*comms) if comms else None))


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items() if k != "comms"))
def test_parallel_plan_equals_jax(kw):
    """Same key, dict, bubble, world and comm facade; each package's dict
    loads in the other and round-trips."""
    mine, theirs = _both(kw)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.key == theirs.key
    assert mine.bubble_fraction() == theirs.bubble_fraction()
    assert (mine.world, mine.total_stages) == (theirs.world,
                                               theirs.total_stages)
    assert (mine.bucket_bytes, mine.algorithm, mine.codec,
            mine.small_floor) == (theirs.bucket_bytes, theirs.algorithm,
                                  theirs.codec, theirs.small_floor)
    assert plan_from_dict(theirs.to_dict()) == mine
    assert ParallelPlan.from_dict(mine.to_dict()) == mine
    assert JaxPlan.from_dict(mine.to_dict()) == theirs


@pytest.mark.parametrize("kw", [
    dict(dp=0), dict(pp=0), dict(schedule="pipedream"),
    dict(pp=2, n_microbatches=1), dict(virtual_stages=2, schedule="1f1b"),
    dict(n_microbatches=0), dict(comms="int8")])
def test_parallel_plan_validation_rejects(kw):
    base = dict(dp=2, pp=2, n_microbatches=4)
    base.update(kw)
    with pytest.raises(ValueError):
        ParallelPlan(**base)


def test_plan_from_dict_dispatch_and_validate_for():
    comm = Plan(4096, "ring", "none")
    par = ParallelPlan(dp=4, pp=2, n_microbatches=4, comms=comm)
    assert plan_from_dict(comm.to_dict()) == comm
    assert plan_from_dict(par.to_dict()) == par
    par.validate_for(8, n_layers=8, batch_per_replica=8)
    for args in ((4,), (8, 5), (8, 8, 6)):
        with pytest.raises(ValueError):
            par.validate_for(*args)


def _check_schedule(sch):
    """Every unit once, forwards after their predecessor's, backwards
    after their successor's (the last stage's in its forward's tick)."""
    S, v, M = sch.S, sch.v, sch.M
    V = S * v
    ef, eb = {}, {}
    for t in range(sch.ticks):
        for d in range(S):
            if sch.f[t][d] is not None:
                j, m = sch.f[t][d]
                q = j * S + d
                assert (q, m) not in ef
                if q > 0:
                    assert ef[(q - 1, m)] < t
                ef[(q, m)] = t
            if sch.b[t][d] is not None:
                j, m = sch.b[t][d]
                q = j * S + d
                assert (q, m) not in eb and ef[(q, m)] <= t
                if q < V - 1:
                    assert eb[(q + 1, m)] < t
                eb[(q, m)] = t
    assert len(ef) == V * M and len(eb) == V * M


@pytest.mark.parametrize("S,M", [(2, 1), (2, 4), (3, 5), (4, 8), (4, 3)])
def test_port_schedules_are_valid(S, M):
    """The executor's tick tables: each a valid schedule; GPipe all
    forwards before its split, 1F1B at most ``S − s`` graphs on stage
    ``s`` (Megatron's bound), interleaved the JAX tables."""
    g = tpipe.gpipe_schedule(S, M)
    _check_schedule(g)
    assert all(u is None for t in range(g.split) for u in g.b[t])
    assert all(u is None for t in range(g.split, g.ticks) for u in g.f[t])
    assert g.in_flight(0) == M
    one = tpipe.one_f_one_b_schedule(S, M)
    _check_schedule(one)
    for s in range(S):
        assert one.in_flight(s) <= min(S - s, M), (s, one.in_flight(s))
    for v in (1, 2):
        inter = tpipe.interleaved_schedule(S, v, M)
        _check_schedule(inter)
        assert inter.ticks == jpipe.interleaved_tables(S, v, M)["ticks"]


def test_compile_seam_binds_plan_to_mesh():
    class Mesh:
        shape = {"dp": 2, "pp": 2, "ep": 1, "sp": 1, "tp": 1}

    plan = ParallelPlan(dp=2, pp=2, n_microbatches=4)
    fn = compile_step_with_plan(lambda x: x + 1, Mesh(), plan)
    assert fn(1) == 2 and fn.plan is plan
    with pytest.raises(ValueError, match="devices"):
        compile_step_with_plan(lambda x: x, Mesh(),
                               ParallelPlan(dp=8, pp=1))
    with pytest.raises(ValueError, match="pp axis"):
        compile_step_with_plan(lambda x: x, Mesh(),
                               ParallelPlan(dp=1, pp=4, n_microbatches=4))
    assert compile_step_with_plan(lambda: 3, None)() == 3


def test_pipeline_gauges_under_the_jax_names():
    """The locked layout and the measured bubble on the registry, as the
    JAX ``hvd_pipeline_*`` gauges: one schedule series reads 1."""
    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.train.pipeline import (_pipeline_metrics,
                                                  record_measured_bubble)
    plan = ParallelPlan(dp=2, pp=4, schedule="interleaved",
                        n_microbatches=8, virtual_stages=2)
    _pipeline_metrics(plan)
    record_measured_bubble(1.7)
    snap = default_registry().snapshot()
    assert snap["hvd_pipeline_stages"]["value"] == 4.0
    assert snap["hvd_pipeline_virtual_stages"]["value"] == 2.0
    assert snap["hvd_pipeline_microbatches"]["value"] == 8.0
    assert snap["hvd_pipeline_bubble_fraction"]["value"] == \
        plan.bubble_fraction()
    assert snap["hvd_pipeline_bubble_fraction_measured"]["value"] == 1.0
    assert [snap[f'hvd_pipeline_schedule{{schedule="{s}"}}']["value"]
            for s in ("gpipe", "1f1b", "interleaved")] == [0.0, 0.0, 1.0]
