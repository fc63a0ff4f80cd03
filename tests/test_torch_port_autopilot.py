"""The port's autopilot against the JAX package's, on the CPU: every policy
document the JAX battery (``tests/test_autopilot.py:61-190``) accepts or
rejects gets the same verdict and the same policies from both parsers, and
``default_policies`` are equal; one finding stream under a fixed clock fed
to both engines gives identical decision records (policy, action, outcome,
reason, gate inputs) in ``observe`` and in ``act``; the
``actions_rank<r>.jsonl`` log and ``history --actions`` read alike across
the packages; the autopsy carries the decisions and the driver outage; and
an action published to the KV ``action/`` scope is picked up by the port's
driver."""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import pytest

from horovod_tpu import autopilot as j_ap
from horovod_tpu.autopilot import engine as j_engine
from horovod_tpu.autopilot import policy as j_policy
from horovod_tpu.metrics import __main__ as j_cli
from horovod_tpu.metrics import anomaly as j_anomaly
from horovod_tpu.metrics import registry as j_reg
from horovod_tpu.metrics import timeseries as j_ts

from horovod_tpu_torch import autopilot as t_ap
from horovod_tpu_torch.autopilot import actions as t_actions
from horovod_tpu_torch.autopilot import engine as t_engine
from horovod_tpu_torch.autopilot import policy as t_policy
from horovod_tpu_torch.metrics import __main__ as t_cli
from horovod_tpu_torch.metrics import anomaly as t_anomaly
from horovod_tpu_torch.metrics import registry as t_reg
from horovod_tpu_torch.metrics import timeseries as t_ts

PKGS = {"jax": (j_ap, j_engine, j_policy, j_reg, j_ts),
        "port": (t_ap, t_engine, t_policy, t_reg, t_ts)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("HVD_TPU_AUTOPILOT", "HVD_TPU_AUTOPILOT_POLICY",
                 "HVD_TPU_OBS_DIR", "HVD_ELASTIC_KV",
                 "HVD_TPU_AUTOTUNE_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    # manufactured findings must not arm device-trace captures
    monkeypatch.setenv("HVD_TPU_PROFILE_ON_ANOMALY", "0")
    for ap, _e, _p, _r, ts in PKGS.values():
        ap.reset()
        ts.reset()
    j_anomaly.reset()
    t_anomaly.reset()
    yield
    for ap, _e, _p, _r, ts in PKGS.values():
        ap.reset()
        ts.reset()
    j_anomaly.reset()
    t_anomaly.reset()


def _p(**kw):
    return {"policies": [dict({"name": "p", "finding": "x",
                               "action": "retune"}, **kw)]}


DOCS = [
    ({"policies": [{"name": "p", "finding": "persistent_straggler",
                    "action": "drain_and_replace"}]}, True),
    (_p(cooldwn_s=1), False),
    ({"policies": [], "polices": []}, False),
    (_p(action="reboot_planet"), False),
    ({"policies": [{"name": "p", "finding": "a", "action": "retune"},
                   {"name": "p", "finding": "b",
                    "action": "freeze_alert"}]}, False),
    (_p(cooldown_s=-1), False),
    (_p(hysteresis=0), False),
    (_p(max_actions=0), False),
    (_p(window_s=0), False),
    (_p(horizon_steps=0), False),
    (_p(max_margin_frac=1.5), False),
    (_p(cooldown_s="soon"), False),
    (_p(max_remesh_p50_s=-2), False),
    (_p(key_field=""), False),
    (_p(name=""), False),
    (_p(finding=3), False),
    ('{"policies": [', False),
    ("[]", False),
    ({"policies": {"name": "p"}}, False),
    ({"policies": ["p"]}, False),
    (_p(cooldown_s=0, hysteresis=2, max_actions=5, window_s=60,
        key_field="function", horizon_steps=10, max_remesh_p50_s=3.5,
        max_margin_frac=0.25), True),
    ({"policies": [{"name": n, "finding": "k", "action": a}
                   for n, a in (("a", "commit_restart"),
                                ("b", "quarantine_rank"),
                                ("c", "rollback_restore"),
                                ("d", "scale_out"),
                                ("e", "promote_rollout"),
                                ("f", "rollback_rollout"))]}, True),
]


def _verdict(policy_mod, doc):
    raw = doc if isinstance(doc, str) else json.dumps(doc)
    try:
        ps = policy_mod.parse_policies(raw)
    except policy_mod.AutopilotError as e:
        return "rejected", str(e)
    return "accepted", [dataclasses.asdict(p) for p in ps]


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_policy_verdicts_match(i):
    doc, accepted = DOCS[i]
    jv, tv = _verdict(j_policy, doc), _verdict(t_policy, doc)
    assert jv == tv
    assert (jv[0] == "accepted") == accepted, jv


def test_catalog_defaults_and_modes_match(monkeypatch):
    assert t_policy.ACTIONS == j_policy.ACTIONS
    assert t_policy.MODES == j_policy.MODES
    assert [dataclasses.asdict(p) for p in t_policy.default_policies()] \
        == [dataclasses.asdict(p) for p in j_policy.default_policies()]
    assert len(t_policy.default_policies()) == len(t_policy.ACTIONS) == 9
    for value in (None, "act", "bogus", "OBSERVE", "off"):
        if value is None:
            monkeypatch.delenv("HVD_TPU_AUTOPILOT", raising=False)
        else:
            monkeypatch.setenv("HVD_TPU_AUTOPILOT", value)
        assert t_ap.mode() == j_ap.mode()
    assert t_ap.default_engine() is None  # off
    monkeypatch.setenv("HVD_TPU_AUTOPILOT", "observe")
    monkeypatch.setenv("HVD_TPU_AUTOPILOT_POLICY", '{"policies": [')
    for ap in (j_ap, t_ap):
        ap.reset()
        assert ap.default_engine() is None       # the quiet path
        with pytest.raises(ValueError):
            ap.ensure_engine()                   # init's loud path


class _Clock:
    """A fixed clock for both engines: monotonic and wall time advance
    only when the test says so."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


_TRACE = ("ts", "trace", "span", "parent", "traceparent")


def _strip(d):
    return {k: v for k, v in d.items() if k not in _TRACE}


def _stream():
    """(clock advance s, finding, hbm gauges or None, remesh totals or
    None): every default policy's gates — straggler with and without
    re-mesh evidence, cooldown, budget, hbm margin, hysteresis per key,
    both rollout verdicts — and a kind no policy takes."""
    strag = {"kind": "persistent_straggler", "rank": 2,
             "win_step_time": 1.2, "fleet_mean": 0.2, "windows": 3,
             "step": 40}
    small = dict(strag, win_step_time=0.21)
    return [
        (0, strag, None, None),
        (1, strag, None, None),                        # cooldown
        (301, strag, None, None),                      # fires again
        (301, strag, None, None),                      # budget
        (0, {"kind": "hbm_growth", "growth_ratio": 1.4}, None, None),
        (0, {"kind": "hbm_growth"}, (8e9, 16e9), None),
        (0, {"kind": "hbm_growth"}, (1e9, 16e9), None),
        (0, {"kind": "recompile_storm", "function": "a", "compiles": 5},
         None, None),
        (0, {"kind": "recompile_storm", "function": "b", "compiles": 5},
         None, None),
        (0, {"kind": "recompile_storm", "function": "a", "compiles": 6},
         None, None),
        (0, {"kind": "world_changed", "old_size": 4, "new_size": 3},
         None, None),
        (0, {"kind": "replica_divergence", "rank": 1, "step": 9,
             "digest": 7, "majority": 3, "world": 3}, None, None),
        (0, {"kind": "grad_nonfinite", "step": 11, "consecutive": 3},
         None, None),
        (0, {"kind": "slo_breach", "p99_s": 0.4, "slo_s": 0.2}, None,
         None),
        (0, {"kind": "rollout_verdict", "verdict": "promote",
             "rollout_id": "r1", "candidate": 2, "incumbent": 1}, None,
         None),
        (0.5, {"kind": "rollout_verdict", "verdict": "promote",
               "rollout_id": "r1"}, None, None),
        (2, {"kind": "rollout_verdict", "verdict": "rollback",
             "rollout_id": "r1", "reason": "p99"}, None, None),
        (0, {"kind": "nobody_subscribes"}, None, None),
        (3600, small, None, (35.0, 40.0, 45.0)),       # slo: p50 40 s
        (400, strag, None, None),                      # worth a re-mesh
    ]


def _run_stream(pkg, mode, monkeypatch):
    ap, engine_mod, policy_mod, reg_mod, ts = PKGS[pkg]
    ts.reset()  # no re-mesh history from an earlier stream
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    reg = reg_mod.Registry()
    eng = engine_mod.PolicyEngine(policies=policy_mod.default_policies(),
                                  registry=reg, mode=mode, rank=0)
    out = []
    for dt, finding, hbm, remesh in _stream():
        clock.t += dt
        if hbm is not None:
            reg.gauge("hvd_hbm_oom_margin_bytes", agg="min").set(hbm[0])
            reg.gauge("hvd_hbm_limit_bytes", agg="min").set(hbm[1])
        for total in remesh or ():
            ts.record_point({"remesh": {"rendezvous": total},
                             "remesh_total_s": total, "complete": True})
        out.append([_strip(d) for d in eng.on_finding(dict(finding))])
    counters = {k: v["value"] for k, v in reg.snapshot().items()
                if k.startswith("hvd_autopilot")}
    return out, counters


@pytest.mark.parametrize("mode", ["observe", "act"])
def test_engines_decide_alike_on_one_stream(mode, monkeypatch):
    runs = {pkg: _run_stream(pkg, mode, monkeypatch) for pkg in PKGS}
    assert runs["port"] == runs["jax"]
    decisions = [d for ds in runs["port"][0] for d in ds]
    want = "fired" if mode == "act" else "dry_run"
    outcomes = [(d["policy"], d["outcome"], d.get("reason"))
                for d in decisions]
    assert outcomes[:4] == [("straggler-drain", want, None),
                            ("straggler-drain", "suppressed", "cooldown"),
                            ("straggler-drain", want, None),
                            ("straggler-drain", "suppressed", "budget")]
    assert ("hbm-planned-restart", "suppressed", "slo") in outcomes
    assert ("rollout-rollback", "suppressed", "slo") in outcomes
    assert ("rollout-promote", "suppressed", "cooldown") in outcomes
    assert outcomes[-2] == ("straggler-drain", "suppressed", "slo")
    assert decisions[-2]["gate"]["remesh_p50_s"] == 40.0
    assert {d["policy"] for d in decisions} == {
        p.name for p in t_policy.default_policies()}
    assert runs["port"][1]['hvd_autopilot_mode'] == \
        {"observe": 1.0, "act": 2.0}[mode]


def test_observe_and_act_streams_differ_only_in_outcome(monkeypatch):
    streams = {m: _run_stream("port", m, monkeypatch)[0]
               for m in ("observe", "act")}

    def norm(ds):
        return [[{k: v for k, v in d.items() if k not in ("outcome",
                                                          "mode")}
                 for d in step] for step in ds]
    assert norm(streams["observe"]) == norm(streams["act"])


def test_actions_log_and_history_read_alike(tmp_path, monkeypatch):
    """Both engines write ``actions_rank0.jsonl``; each CLI renders both
    packages' logs to the same text."""
    texts = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.setenv("HVD_TPU_OBS_DIR", str(d))
        _ap, engine_mod, policy_mod, reg_mod, _ts = PKGS[pkg]
        eng = engine_mod.PolicyEngine(
            policies=[policy_mod.Policy(name="audit-me", finding="k",
                                        action="freeze_alert",
                                        cooldown_s=3600.0)],
            registry=reg_mod.Registry(), mode="observe", rank=0)
        eng.on_finding({"kind": "k", "function": "f"})
        eng.on_finding({"kind": "k", "function": "f"})
        rows = [json.loads(line) for line in
                (d / "actions_rank0.jsonl").read_text().splitlines()]
        assert [r["outcome"] for r in rows] == ["dry_run", "suppressed"]
    for cli_name, cli in (("jax", j_cli), ("port", t_cli)):
        for pkg in PKGS:
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = cli.main(["history", "--dir", str(tmp_path / pkg),
                               "--actions"])
            assert rc == 0
            texts[(cli_name, pkg)] = buf.getvalue()
    out = texts[("port", "port")]
    assert "audit-me" in out and "2 decision(s)" in out
    norm = {k: "\n".join(line for line in v.splitlines()
                         if "audit-me" not in line)
            for k, v in texts.items()}
    assert len(set(norm.values())) == 1, texts
    empty = tmp_path / "empty"
    empty.mkdir()
    assert t_cli.main(["history", "--dir", str(empty), "--actions"]) == 1


def test_autopsy_carries_actions_and_driver_outage(tmp_path, monkeypatch):
    from horovod_tpu_torch.diagnostics.autopsy import write_autopsy
    from horovod_tpu_torch.elastic import outage
    monkeypatch.setenv("HVD_TPU_AUTOPILOT", "observe")
    monkeypatch.setenv("HVD_TPU_AUTOPILOT_POLICY", json.dumps(
        {"policies": [{"name": "aut", "finding": "k",
                       "action": "freeze_alert"}]}))
    monkeypatch.setenv("HVD_ELASTIC_KV", "127.0.0.1:1")
    t_ap.ensure_engine()
    t_ap.on_finding({"kind": "k"})
    outage.reset()
    try:
        outage.note_failure()
        assert outage.active()
        bundle = write_autopsy(str(tmp_path / "b"), reason="test",
                               fetch_peers=False)
    finally:
        outage.reset()
    summary = json.load(open(os.path.join(bundle, next(
        f for f in os.listdir(bundle) if f.startswith("summary_rank")))))
    assert summary["actions"][-1]["policy"] == "aut"
    assert summary["actions"][-1]["outcome"] == "dry_run"
    out = summary["driver_outage"]
    assert set(out) == {"age_s", "grace_s", "exceeded"}
    assert out["exceeded"] is False and out["age_s"] >= 0
    # no outage, no autopilot decision: the JAX package's empty values
    t_ap.reset()
    bundle = write_autopsy(str(tmp_path / "c"), reason="test",
                           fetch_peers=False)
    summary = json.load(open(os.path.join(bundle, next(
        f for f in os.listdir(bundle) if f.startswith("summary_rank")))))
    assert summary["actions"] == [] and summary["driver_outage"] is None


def test_local_actions_run_their_hooks(tmp_path, monkeypatch):
    """freeze, rollback, scale_out, the two rollout hooks and retune
    (which invalidates the port's plan cache)."""
    from horovod_tpu_torch.common.config import reset_config
    cache = tmp_path / "plans"
    cache.mkdir()
    (cache / "plan_abc.json").write_text("{}")
    (cache / "keep.txt").write_text("x")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_CACHE_DIR", str(cache))
    reset_config()
    ran = []
    t_actions.register_retune_hook(lambda: ran.append("retune"))
    t_actions.register_rollback_hook(lambda: ran.append("rollback"))
    t_actions.register_scale_out_hook(lambda: ran.append("scale_out"))
    t_actions.register_promote_rollout_hook(
        lambda f: ran.append(("promote", f["rollout_id"])))
    t_actions.register_rollback_rollout_hook(
        lambda f: ran.append(("rollback_rollout", f["rollout_id"])))
    assert t_actions.retune() == 1
    assert not (cache / "plan_abc.json").exists()
    assert (cache / "keep.txt").exists()
    assert t_actions.rollback() == 1 and t_actions.scale_out() == 1
    assert t_actions.promote_rollout(finding={"rollout_id": "r"}) == 1
    assert t_actions.rollback_rollout(finding={"rollout_id": "r"}) == 1
    t_actions.freeze("hot_fn")
    assert "hot_fn" in t_actions.frozen_functions()
    assert ran == ["retune", "rollback", "scale_out", ("promote", "r"),
                   ("rollback_rollout", "r")]
    reset_config()


def test_fleet_registers_its_scale_out_hook():
    from horovod_tpu_torch.serving.fleet import ReplicaFleet
    fleet = ReplicaFleet.__new__(ReplicaFleet)
    grown = []
    fleet.scale_out = lambda n=1: grown.append(n)
    ReplicaFleet.register_autopilot_hook(fleet)
    assert t_actions.scale_out() == 1 and grown == [1]


class _Alive:
    def is_alive(self):
        return True


class _Slot:
    def __init__(self, hostname):
        self.hostname = hostname


def test_published_action_reaches_the_port_driver(monkeypatch):
    """A fired ``drain_and_replace`` publishes ``action/<rank>-<seq>``
    with the JAX package's fields; the port's driver scans it into a
    drain of the named rank, and burns what it must."""
    from horovod_tpu.autopilot import actions as j_actions
    from horovod_tpu_torch.runner import kv_relay
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.elastic.driver import (ElasticDriver,
                                                         _GenRuntime)
    from horovod_tpu_torch.runner.hosts import HostInfo
    driver = ElasticDriver(FixedHosts([HostInfo("localhost", 3)]),
                           ["true"], min_np=1)
    try:
        monkeypatch.setenv("HVD_ELASTIC_KV",
                           f"127.0.0.1:{driver._kv.port}")
        monkeypatch.setenv("HVD_ELASTIC_GENERATION", "0")
        monkeypatch.setenv("HOROVOD_RANK", "0")
        kv_relay.reset()
        pol = t_policy.Policy(name="straggler-drain",
                              finding="persistent_straggler",
                              action="drain_and_replace")
        assert t_actions._request_driver_action(
            "drain", 2, pol, {"finding": "persistent_straggler"})
        jpol = j_policy.Policy(**dataclasses.asdict(pol))
        monkeypatch.setenv("HOROVOD_RANK", "1")  # another key: "1-1"
        assert j_actions._request_driver_action(
            "restart", 1, jpol, {"finding": "hbm_growth"})
        docs = [json.loads(v) for v in driver._kv.scope("action").values()]
        assert sorted(d["action"] for d in docs) == ["drain", "restart"]
        assert {frozenset(d) for d in docs} == {frozenset(docs[0])}
        driver._kv.put("action", "0-9", b"not json")
        g = _GenRuntime([], 0, "127.0.0.1", 0)
        for r in (0, 1, 2):
            key = (0, r)
            g.essential_keys.append(key)
            g.current_rank[key] = r
            g.slot_by_key[key] = _Slot("localhost")
            g.threads[key] = _Alive()
        groups = driver._scan_action_requests(g)
        drains, dmeta, _ = groups["drain"]
        restarts, rmeta, _ = groups["restart"]
        assert {g.current_rank[k] for k in drains} == {2}
        assert dmeta[0]["policy"] == "straggler-drain"
        assert dmeta[0]["source"] == "autopilot"
        assert {g.current_rank[k] for k in restarts} == {1}
        assert {t[1] for t in g.handled_tokens} == {"0-9"}
    finally:
        driver._kv.stop()
        kv_relay.reset()
