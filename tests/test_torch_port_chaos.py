"""The port's chaos plane against the JAX package's, on the CPU: every plan
document the JAX battery accepts or rejects (``tests/test_chaos.py:34-164``,
``tests/test_integrity.py:101-141``) gets the same verdict and the same
rules from both ``parse_plan``s; seeded plans give the same fire schedule
over 2,000 invocations and the same compiled transport spec on every rank;
and the two engines agree on markers (``{rank}`` included), rank filters,
step indexing, the grad seam's codes, and the metric and flight names."""

import dataclasses
import json
import os

import pytest

from horovod_tpu import chaos as j_chaos
from horovod_tpu.chaos import plan as j_plan
from horovod_tpu.diagnostics import flight_recorder as j_flight
from horovod_tpu.metrics import registry as j_reg

from horovod_tpu_torch import chaos as t_chaos
from horovod_tpu_torch.chaos import plan as t_plan
from horovod_tpu_torch.diagnostics import flight_recorder as t_flight
from horovod_tpu_torch.metrics import registry as t_reg

PKGS = {"jax": (j_chaos, j_plan, j_flight, j_reg),
        "port": (t_chaos, t_plan, t_flight, t_reg)}


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


def _f(**rule):
    return {"faults": [rule]}


# every document of the JAX plan battery, as (doc, accepted)
DOCS = [
    ('{"faults": [{"seam": "kv.request", "kind": "error"}]}', True),
    ('{"faults": [{"seam": "kv.reqest", "kind": "error"}]}', False),
    ('{"faults": [{"seam": "kv.request", "kind": "kill"}]}', False),
    ('{"faults": [{"seam": "step", "kind": "kill", "when": 3}]}', False),
    ('{"faults": [], "fualts": []}', False),
    ('{"faults": [', False),
    ('[1, 2]', False),
    ('{"faults": {"seam": "step"}}', False),
    ('{"seed": "x", "faults": []}', False),
    (_f(seam="step", kind="stall", start=5, stop=5), False),
    (_f(seam="step", kind="stall", start=-1), False),
    (_f(seam="kv.request", kind="delay"), False),
    (_f(seam="checkpoint.write", kind="slow_fsync"), False),
    (_f(seam="step", kind="stall"), False),
    (_f(seam="transport.recv", kind="drop", marker="/tmp/x"), False),
    (_f(seam="kv.request", kind="error", probability=0.0), False),
    (_f(seam="kv.request", kind="error", probability=-0.5), False),
    (_f(seam="kv.request", kind="error", probability=1.5), False),
    (_f(seam="kv.request", kind="error", count=-1), False),
    (_f(seam="step", kind="kill", rank=True), False),
    (_f(seam="step", kind="kill", rank=["a"]), False),
    (_f(seam="step", kind="kill", rank="all"), False),
    (_f(seam="step", kind="kill", start="x"), False),
    ({"faults": [
        {"seam": "kv.request", "kind": "blackout", "start": 0, "stop": 10},
        {"seam": "kv.request", "kind": "blackout", "start": 5,
         "stop": 15}]}, False),
    ({"faults": [
        {"seam": "kv.request", "kind": "blackout", "start": 0, "stop": 5},
        {"seam": "kv.request", "kind": "blackout", "start": 5,
         "stop": 9}]}, True),
    ({"faults": [
        {"seam": "kv.request", "kind": "blackout", "start": 0, "stop": 5},
        {"seam": "kv.request", "kind": "delay", "start": 0, "stop": 5,
         "delay_ms": 1}]}, True),
    ({"faults": [
        {"seam": "step", "kind": "kill", "rank": 0, "start": 3},
        {"seam": "step", "kind": "kill", "rank": [1, 2], "start": 3}]},
     True),
    ({"faults": [
        {"seam": "transport.recv", "kind": "delay", "peer": 0,
         "delay_ms": 1},
        {"seam": "transport.recv", "kind": "delay", "peer": 1,
         "delay_ms": 1}]}, True),
    (_f(seam="step", kind="stall", rank=[1, 3], stall_s=0.001), True),
    ({"seed": 11, "faults": [
        {"seam": "kv.request", "kind": "error", "probability": 0.4,
         "start": 0, "stop": 400}]}, True),
    # bit_flip and grad (tests/test_integrity.py:101-141)
    (_f(seam="transport.send", kind="bit_flip", rank=1, peer=0, count=1,
        min_bytes=1024), True),
    (_f(seam="transport.send", kind="drop", min_bytes=64), False),
    (_f(seam="transport.send", kind="bit_flip", min_bytes=-1), False),
    (_f(seam="grad", kind="nan", rank=0, start=3), True),
    (_f(seam="grad", kind="scale", rank=0), False),
    (_f(seam="grad", kind="scale", factor=1.0), False),
    (_f(seam="grad", kind="scale", factor=8.0, start=2, stop=4), True),
    (_f(seam="step", kind="stall", stall_s=1, factor=2.0), False),
    (_f(seam="grad", kind="flip"), False),
    # partitions
    (_f(seam="kv.partition", kind="partition",
        groups=[[0, 1], ["driver", 2]]), True),
    (_f(seam="kv.partition", kind="partition"), False),
    (_f(seam="kv.partition", kind="partition", groups=[[0], [0, 1]]), False),
    (_f(seam="kv.partition", kind="partition", groups=[[0]]), False),
    (_f(seam="kv.partition", kind="partition", groups=[[0], []]), False),
    (_f(seam="kv.partition", kind="partition", groups=[[0], ["x"]]), False),
    (_f(seam="kv.request", kind="error", groups=[[0], [1]]), False),
    ({"faults": [
        {"seam": "kv.partition", "kind": "partition",
         "groups": [[0], [1]]},
        {"seam": "kv.partition", "kind": "partition",
         "groups": [[2], [3]]}]}, True),
    ({"faults": [
        {"seam": "kv.partition", "kind": "partition",
         "groups": [[0], [1]]},
        {"seam": "kv.partition", "kind": "partition",
         "groups": [[1], [2]]}]}, False),
    # the rest of the catalog
    (_f(seam="preemption", kind="notice", rank=2, marker="/tmp/m"), True),
    (_f(seam="serving.request", kind="shed"), True),
    (_f(seam="serving.request", kind="delay", delay_ms=400, rank=0), True),
    (_f(seam="serving.kv", kind="starve", start=1, count=3), True),
    (_f(seam="driver", kind="stall", start=4, stop=5, stall_s=4.0), True),
    (_f(seam="driver", kind="exit", exit_code=7), True),
    (_f(seam="checkpoint.write", kind="io_error", rank=0, count=1), True),
]


def _verdict(plan_mod, doc, seed=None):
    raw = doc if isinstance(doc, str) else json.dumps(doc)
    try:
        p = plan_mod.parse_plan(raw, seed_override=seed)
    except plan_mod.FaultPlanError as e:
        return "rejected", str(e)
    return "accepted", (p.seed, [dataclasses.asdict(r) for r in p.rules])


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_plan_verdicts_match(i):
    doc, accepted = DOCS[i]
    jv, tv = _verdict(j_plan, doc), _verdict(t_plan, doc)
    assert jv == tv
    assert (jv[0] == "accepted") == accepted, jv


def test_catalog_and_codes_match():
    assert t_plan.SEAMS == j_plan.SEAMS and len(t_plan.SEAMS) == 11
    assert t_chaos.GRAD_CODES == j_chaos.GRAD_CODES
    assert t_chaos.TRANSPORT_ENV == j_chaos.TRANSPORT_ENV
    assert set(t_chaos.__all__) == set(j_chaos.__all__)


SCHEDULE_PLANS = [
    {"seed": 11, "faults": [
        {"seam": "kv.request", "kind": "error", "probability": 0.4,
         "start": 0, "stop": 1500}]},
    {"seed": 3, "faults": [
        {"seam": "step", "kind": "stall", "rank": [0, 2],
         "probability": 0.05, "stall_s": 1.0},
        {"seam": "grad", "kind": "nan", "rank": 1, "start": 100,
         "stop": 900, "probability": 0.5},
        {"seam": "serving.request", "kind": "shed", "probability": 0.25}]},
    {"seed": 0, "faults": [
        {"seam": "checkpoint.write", "kind": "io_error", "start": 7,
         "stop": 9},
        {"seam": "preemption", "kind": "notice", "rank": 3,
         "probability": 0.001}]},
]


@pytest.mark.parametrize("pi", range(len(SCHEDULE_PLANS)))
@pytest.mark.parametrize("seed", [None, 1, 12345])
def test_fire_schedules_match(pi, seed):
    """``decides_fire`` is the same pure function of (seed, rule, index):
    the same plan gives the same schedule in both packages, rank by
    rank, over 2,000 invocations."""
    raw = json.dumps(SCHEDULE_PLANS[pi])
    jp = j_plan.parse_plan(raw, seed_override=seed)
    tp = t_plan.parse_plan(raw, seed_override=seed)
    fired = 0
    for rank in range(4):
        for seam in j_plan.SEAMS:
            jr, tr = jp.rules_for(seam, rank), tp.rules_for(seam, rank)
            assert [r.index for r in jr] == [r.index for r in tr]
            for a, b in zip(jr, tr):
                js = [i for i in range(2000) if a.decides_fire(jp.seed, i)]
                ts = [i for i in range(2000) if b.decides_fire(tp.seed, i)]
                assert js == ts, (seam, rank)
                fired += len(js)
    assert fired > 0


TRANSPORT_PLANS = [
    {"faults": [
        {"seam": "transport.recv", "kind": "delay", "rank": 1, "peer": 0,
         "start": 10, "count": 5, "delay_ms": 25},
        {"seam": "transport.send", "kind": "close", "rank": 0, "start": 7}]},
    {"faults": [{"seam": "transport.recv", "kind": "drop", "start": 4,
                 "stop": 9}]},
    {"faults": [
        {"seam": "transport.send", "kind": "bit_flip", "rank": 1, "peer": 0,
         "count": 1, "min_bytes": 1024},
        {"seam": "transport.recv", "kind": "delay", "delay_ms": 2.5,
         "start": 3, "stop": 40, "count": 10}]},
    {"faults": [{"seam": "transport.recv", "kind": "drop",
                 "probability": 0.5}]},
]


@pytest.mark.parametrize("pi", range(len(TRANSPORT_PLANS)))
def test_transport_specs_match(pi):
    raw = json.dumps(TRANSPORT_PLANS[pi])
    jp, tp = j_plan.parse_plan(raw), t_plan.parse_plan(raw)
    for rank in range(3):
        try:
            js = j_plan.compile_transport_spec(jp, rank)
        except j_plan.FaultPlanError as e:
            with pytest.raises(t_plan.FaultPlanError) as te:
                t_plan.compile_transport_spec(tp, rank)
            assert str(te.value) == str(e)
            continue
        assert t_plan.compile_transport_spec(tp, rank) == js


def _both(monkeypatch, plan, rank=0):
    monkeypatch.setenv("HVD_TPU_FAULT_PLAN", json.dumps(plan))
    return {k: (m[0], m[0].install(rank=rank)) for k, m in PKGS.items()}


def _fire(mod, seam, **kw):
    try:
        return ("ok", [tuple(x) for x in mod.fire(seam, **kw)])
    except OSError as e:
        return (type(e).__name__, str(e))


def test_engines_agree_on_seams_windows_and_ranks(monkeypatch):
    plan = {"faults": [
        {"seam": "kv.request", "kind": "blackout", "start": 1, "stop": 3},
        {"seam": "checkpoint.write", "kind": "io_error", "count": 1},
        {"seam": "kv.request", "kind": "error", "rank": 1, "start": 5,
         "stop": 6},
        {"seam": "kv.partition", "kind": "partition",
         "groups": [[0], ["driver"]], "start": 0, "stop": 2}]}
    for rank in (0, 1):
        both = _both(monkeypatch, plan, rank)
        runs = {}
        for k, (mod, eng) in both.items():
            assert eng is not None and eng.rank == rank
            seq = [_fire(mod, "kv.request") for _ in range(7)]
            seq += [_fire(mod, "checkpoint.write") for _ in range(2)]
            seq += [_fire(mod, "kv.partition", peer=p)
                    for p in ("driver", 1, "driver", "driver")]
            runs[k] = seq
        assert runs["jax"] == runs["port"]
        assert runs["port"][1][0] == "ConnectionRefusedError"
        assert runs["port"][7][0] == "OSError"
        assert (runs["port"][5][0] == "ConnectionResetError") == (rank == 1)
        assert (runs["port"][9][0] == "ConnectionRefusedError") == (rank == 0)


def test_step_indexing_and_grad_codes_match(monkeypatch):
    plan = {"faults": [
        {"seam": "step", "kind": "stall", "start": 3, "stop": 4,
         "stall_s": 0.001},
        {"seam": "grad", "kind": "scale", "rank": 0, "start": 2, "stop": 4,
         "factor": 8.0},
        {"seam": "grad", "kind": "nan", "rank": 0, "start": 7, "stop": 8},
        {"seam": "grad", "kind": "inf", "rank": 1, "start": 0}]}
    for rank in (0, 1, 2):
        both = _both(monkeypatch, plan, rank)
        out = {}
        for k, (mod, _eng) in both.items():
            out[k] = ([tuple(x) for s in (0, 3, 4, 3)
                       for x in mod.step_tick(s)],
                      mod.grad_rules_armed(),
                      [mod.grad_injection(s) for s in range(9)])
        assert out["jax"] == out["port"]
    assert out["port"][1] is False  # rank 2: no grad rule
    both = _both(monkeypatch, plan, 0)
    assert [t_chaos.grad_injection(s) for s in range(9)] == \
        [(0, 0.0), (0, 0.0), (3, 8.0), (3, 8.0), (0, 0.0), (0, 0.0),
         (0, 0.0), (1, 0.0), (0, 0.0)]


def test_markers_and_rank_template_match(tmp_path, monkeypatch):
    """A ``{rank}`` marker fires once per rank across re-installs (a
    replacement process), in both packages."""
    for k in PKGS:
        d = tmp_path / k
        d.mkdir()
        plan = {"faults": [
            {"seam": "kv.request", "kind": "error", "rank": [0, 1],
             "marker": str(d / "m{rank}")}]}
        mod = PKGS[k][0]
        seq = []
        for rank in (0, 1, 0, 1, 2):
            _both(monkeypatch, plan, rank)  # both armed: same env
            mod.uninstall()
            mod.install(rank=rank)
            seq.append(_fire(mod, "kv.request")[0])
        assert seq == ["ConnectionResetError", "ConnectionResetError",
                       "ok", "ok", "ok"], (k, seq)
        assert sorted(os.listdir(d)) == ["m0", "m1"]


def test_metric_and_flight_names_match(monkeypatch):
    plan = {"faults": [{"seam": "kv.request", "kind": "delay",
                        "delay_ms": 1, "count": 1}]}
    key = 'hvd_chaos_injected_total{kind="delay",seam="kv.request"}'
    before = {k: m[3].default_registry().snapshot().get(key, {})
              .get("value", 0) for k, m in PKGS.items()}
    both = _both(monkeypatch, plan, 0)
    events = {}
    for k, (mod, _eng) in both.items():
        mod.fire("kv.request")
        mod.fire("kv.request")
        snap = PKGS[k][3].default_registry().snapshot()
        assert snap[key]["value"] == before[k] + 1, k
        evs = [e for e in PKGS[k][2].recorder().events()
               if e["kind"] in ("chaos_armed", "fault_injected")]
        events[k] = [{f: e.get(f) for f in
                      ("kind", "seam", "fault", "rule", "invocation",
                       "rank", "seed", "rules", "transport_spec")}
                     for e in evs[-2:]]
    assert events["jax"] == events["port"]
    assert [e["kind"] for e in events["port"]] == ["chaos_armed",
                                                   "fault_injected"]


def test_install_env_contract_matches(tmp_path, monkeypatch):
    """No plan: dead seams and no transport env; a file plan with a seed
    override; a bad seed or an unreadable file raises alike; the
    transport env follows the rank and is cleared with no rule."""
    for k, (mod, plan_mod, _f, _r) in PKGS.items():
        monkeypatch.delenv("HVD_TPU_FAULT_PLAN", raising=False)
        assert mod.install() is None and not mod.active()
        assert mod.fire("kv.request") == () and mod.step_tick(5) == ()
        f = tmp_path / "plan.json"
        f.write_text(json.dumps({"seed": 3, "faults": [
            {"seam": "transport.recv", "kind": "delay", "rank": 1,
             "peer": 0, "start": 10, "count": 5, "delay_ms": 25}]}))
        monkeypatch.setenv("HVD_TPU_FAULT_PLAN", str(f))
        monkeypatch.setenv("HVD_TPU_FAULT_SEED", "99")
        eng = mod.install(rank=1)
        assert eng.plan.seed == 99
        assert os.environ[mod.TRANSPORT_ENV] == \
            "dir=recv:kind=delay:peer=0:after=10:count=5:ms=25"
        assert mod.install(rank=1) is eng
        mod.install(rank=2)
        assert mod.TRANSPORT_ENV not in os.environ
        monkeypatch.setenv("HVD_TPU_FAULT_SEED", "notanint")
        with pytest.raises(plan_mod.FaultPlanError, match="FAULT_SEED"):
            mod.install(rank=0)
        monkeypatch.setenv("HVD_TPU_FAULT_SEED", "")
        monkeypatch.setenv("HVD_TPU_FAULT_PLAN", str(tmp_path / "no.json"))
        with pytest.raises(plan_mod.FaultPlanError, match="unreadable"):
            mod.install(rank=0)
        mod.uninstall()
