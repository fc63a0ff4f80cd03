"""The port's fleet fan-in tree and metrics CLI against the JAX package's,
on the CPU: ``parent_of``, ``children_of`` and ``tree_depth`` for worlds of
1-64 and arities 2-8; ``subtree_doc``, ``ingest``, staleness, mismatched
histogram bounds, ``fleet_snapshot`` and ``render_fleet`` on the same
snapshots (``tests/test_fleet.py:27-357``), with wall-clock fields
compared for presence and type; pushes over the exporter's HTTP plane;
``AnomalyEngine.observe_fleet`` giving the same findings on a seeded
sequence of windows; and the ``metrics`` CLI's ``parse_prometheus``,
``render_top``, ``top`` and ``history`` tables giving equal text.
"""

import io
import json
import os
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from horovod_tpu.metrics import __main__ as j_cli
from horovod_tpu.metrics import anomaly as j_anomaly
from horovod_tpu.metrics import exporter as j_exp
from horovod_tpu.metrics import fleet as j_fleet
from horovod_tpu.metrics import registry as j_reg

from horovod_tpu_torch.metrics import __main__ as t_cli
from horovod_tpu_torch.metrics import anomaly as t_anomaly
from horovod_tpu_torch.metrics import exporter as t_exp
from horovod_tpu_torch.metrics import fleet as t_fleet
from horovod_tpu_torch.metrics import registry as t_reg
from horovod_tpu_torch.metrics import goodput as t_goodput

PKGS = {"j": (j_fleet, j_reg), "t": (t_fleet, t_reg)}


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """No goodput window in either package (the JAX ledger of earlier
    tests of this process is set aside and put back after)."""
    from horovod_tpu.metrics import goodput as j_goodput
    for name in ("HVD_TPU_PEER_HOSTS", "HVD_TPU_FLEET_ARITY",
                 "HVD_TPU_FLEET_PUSH_SECONDS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(j_goodput, "_LEDGER", None)
    from horovod_tpu_torch import profiling as t_profiling
    t_goodput.reset()
    t_anomaly.reset()
    yield
    t_goodput.reset()
    t_anomaly.reset()
    t_profiling.reset()  # a finding may have armed a capture


def _strip_ts(doc):
    """Wall-clock fields as their type names, recursively."""
    if isinstance(doc, dict):
        return {k: (type(v).__name__ if k == "ts" else _strip_ts(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_strip_ts(v) for v in doc]
    return doc


# -- topology ---------------------------------------------------------------

def test_tree_topology_equals_jax():
    for size in range(1, 65):
        for arity in range(2, 9):
            assert t_fleet.tree_depth(size, arity) == \
                j_fleet.tree_depth(size, arity)
            for r in range(size):
                assert t_fleet.parent_of(r, arity) == \
                    j_fleet.parent_of(r, arity)
                assert t_fleet.children_of(r, size, arity) == \
                    j_fleet.children_of(r, size, arity)
    assert t_fleet.tree_depth(4, 2) == 2
    assert t_fleet.children_of(1, 4, 2) == [3]


def test_rank_endpoint_equals_jax(monkeypatch):
    for hosts in ("", "hostA,hostA,hostB,hostB", "h0,h0", "h0,,h1"):
        monkeypatch.setenv("HVD_TPU_PEER_HOSTS", hosts)
        for r in range(6):
            assert t_fleet.rank_endpoint(r, 9090) == \
                j_fleet.rank_endpoint(r, 9090)
    monkeypatch.setenv("HVD_TPU_FLEET_ARITY", "3")
    monkeypatch.setenv("HVD_TPU_FLEET_PUSH_SECONDS", "0.01")
    assert t_fleet.tree_arity() == j_fleet.tree_arity() == 3
    assert t_fleet.push_interval_s() == j_fleet.push_interval_s() == 0.05
    assert t_fleet.fleet_enabled() is j_fleet.fleet_enabled() is True


def test_cross_host_without_peer_hosts_disables_push(monkeypatch):
    blind = t_fleet.FleetAggregator(rank=1, size=4, base_port=1,
                                    registry=t_reg.Registry(),
                                    push_interval=60.0, cross_size=2)
    assert not blind.routable
    blind.flush()
    assert blind._push_failures == 0 and blind.pushes_sent == 0
    assert blind.subtree_doc()["covers"] == [1]
    monkeypatch.setenv("HVD_TPU_PEER_HOSTS", "h0,h0,h1,h1")
    assert t_fleet.FleetAggregator(rank=1, size=4, base_port=1,
                                   registry=t_reg.Registry(),
                                   push_interval=60.0, cross_size=2).routable


# -- merge / ingest on the same snapshots ---------------------------------------

def _agg(p, rank, size, reg, **kw):
    kw.setdefault("push_interval", 60.0)
    return PKGS[p][0].FleetAggregator(rank=rank, size=size, base_port=9090,
                                      registry=reg, **kw)


def _regs(p, n, fill):
    regs = [PKGS[p][1].Registry() for _ in range(n)]
    for r, reg in enumerate(regs):
        fill(r, reg)
    return regs


def _fill_steps(r, reg):
    reg.counter("hvd_steps_total").inc(10 * (r + 1))
    for _ in range(4):
        reg.histogram("hvd_step_time_seconds").observe(
            (0.01, 0.01, 0.05, 0.02)[r % 4])
    reg.gauge("hvd_hbm_bytes_in_use").set(1e9 * (r + 1))


def _tree(p, size, arity, fill=_fill_steps, **kw):
    regs = _regs(p, size, fill)
    aggs = [_agg(p, r, size, regs[r], arity=arity, **kw)
            for r in range(size)]
    # deepest first: each node ingests its children's subtree docs
    for r in sorted(range(1, size),
                    key=lambda r: -j_fleet.tree_depth(r + 1, arity)):
        assert aggs[aggs[r].parent].ingest(aggs[r].subtree_doc())
    return aggs


@pytest.mark.parametrize("size,arity", [(1, 4), (3, 4), (4, 2), (7, 2),
                                        (9, 3)])
def test_subtree_and_fleet_snapshot_equal_jax(size, arity):
    docs = {p: _tree(p, size, arity)[0] for p in PKGS}
    jdoc = docs["j"].subtree_doc(consume_window=False)
    tdoc = docs["t"].subtree_doc(consume_window=False)
    assert _strip_ts(tdoc) == _strip_ts(jdoc)
    assert tdoc["covers"] == list(range(size))
    assert tdoc["snapshot"]["hvd_steps_total"]["value"] == \
        10 * size * (size + 1) / 2
    jsnap = docs["j"].fleet_snapshot()
    tsnap = docs["t"].fleet_snapshot()
    assert tsnap["snapshot"] == jsnap["snapshot"]
    assert _strip_ts(tsnap["doc"]) == _strip_ts(jsnap["doc"])
    assert docs["t"].render_fleet() == docs["j"].render_fleet()
    if size > 2:
        assert tsnap["snapshot"]["hvd_fleet_straggler_rank"]["value"] % 4 \
            == 2


def test_ingest_rejects_other_world_and_generation():
    counts = {}
    for p in PKGS:
        root = _agg(p, 0, 2, PKGS[p][1].Registry(), generation=1)
        ok = _agg(p, 1, 2, PKGS[p][1].Registry(),
                  generation=1).subtree_doc()
        assert root.ingest(ok)
        for doc in (dict(ok, size=3), dict(ok, generation=0),
                    dict(ok, from_rank=5), {"hello": "world"},
                    dict(ok, from_rank="x")):
            assert not root.ingest(doc)
        counts[p] = (root.rejected, root.pushes_received)
    assert counts["t"] == counts["j"] == (5, 1)


def test_stale_children_drop_out_of_the_merge():
    docs = {}
    for p in PKGS:
        root = _agg(p, 0, 2, PKGS[p][1].Registry(), push_interval=0.05)
        assert root.ingest(_agg(p, 1, 2, PKGS[p][1].Registry())
                           .subtree_doc())
        assert 1 in root.subtree_doc()["covers"]
        docs[p] = root
    time.sleep(0.2)
    for p, root in docs.items():
        doc = root.subtree_doc()
        assert doc["covers"] == [0] and doc["stale"] == [1], p


def test_mismatched_histogram_bounds_degrade_to_local_view():
    docs = {}
    for p in PKGS:
        ra, rb = PKGS[p][1].Registry(), PKGS[p][1].Registry()
        ra.histogram("h", buckets=[1.0]).observe(0.5)
        rb.histogram("h", buckets=[2.0]).observe(0.5)
        root = _agg(p, 0, 2, ra)
        assert root.ingest(_agg(p, 1, 2, rb).subtree_doc())
        docs[p] = root.subtree_doc()
    assert docs["t"]["covers"] == [0]
    assert _strip_ts(docs["t"]) == _strip_ts(docs["j"])


def test_scrape_does_not_consume_the_push_window():
    for p in PKGS:
        reg = PKGS[p][1].Registry()
        agg = _agg(p, 0, 1, reg)
        for _ in range(4):
            reg.histogram("hvd_step_time_seconds").observe(0.02)
        for _ in range(5):
            snap = agg.fleet_snapshot()["snapshot"]
            assert snap["hvd_fleet_step_time_mean"]["value"] == \
                pytest.approx(0.02, rel=0.01)
        for _ in range(2):  # the window, then the idle carry-over
            doc = agg.subtree_doc(consume_window=True)
            assert doc["per_rank"]["0"]["win_step_time"] == \
                pytest.approx(0.02, rel=0.01)
        assert "hvd_fleet_size" not in reg.snapshot()  # view-only gauges


def test_goodput_rides_the_breakdown():
    from horovod_tpu.metrics import goodput as j_goodput

    class _Led:
        def last_window(self):
            return {"fraction": 0.81234, "wall_s": 2.5,
                    "seconds": {"compute": 2.0, "input_wait": 0.5}}

    try:
        for mod in (j_goodput, t_goodput):
            mod._LEDGER = _Led()  # the JAX one is put back by fresh_state
        assert t_goodput.fleet_summary() == j_goodput.fleet_summary()
        docs = {p: _agg(p, 0, 1, PKGS[p][1].Registry()).fleet_snapshot()
                for p in PKGS}
    finally:
        t_goodput._LEDGER = None
    assert docs["t"]["snapshot"] == docs["j"]["snapshot"]
    assert docs["t"]["snapshot"]["hvd_fleet_goodput_worst_rank"][
        "value"] == 0


# -- pushes over HTTP ----------------------------------------------------------------

def _get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def test_child_pushes_upstream_for_real():
    bodies = {}
    for p, exp_mod in (("j", j_exp), ("t", t_exp)):
        fleet, reg = PKGS[p]
        reg0, reg1 = reg.Registry(), reg.Registry()
        reg0.counter("hvd_steps_total").inc(1)
        reg1.counter("hvd_steps_total").inc(2)
        exp = exp_mod.MetricsExporter(registry=reg0, port=0)
        exp.fleet = _agg(p, 0, 2, reg0)
        exp.start()
        try:
            child = fleet.FleetAggregator(rank=1, size=2, base_port=exp.port,
                                          registry=reg1, push_interval=60.0)
            child.flush()
            assert child.pushes_sent == 1
            assert exp.fleet.subtree_doc()["covers"] == [0, 1]
            bodies[p] = _get(exp.port, "/metrics/fleet")[1]
        finally:
            exp.stop()
    assert bodies["t"] == bodies["j"]
    assert "hvd_steps_total 3" in bodies["t"]
    assert "hvd_fleet_ranks_reporting 2" in bodies["t"]


def test_dead_parent_degrades_gracefully():
    child = t_fleet.FleetAggregator(rank=1, size=2, base_port=1,
                                    registry=t_reg.Registry(),
                                    push_interval=60.0)
    child.flush()
    child.flush()
    assert child.pushes_sent == 0 and child._push_failures == 2


def test_root_tick_feeds_the_straggler_detector(monkeypatch):
    monkeypatch.setenv("HVD_TPU_ANOMALY_STRAGGLER_WINDOWS", "2")
    t_anomaly.reset()
    regs = _regs("t", 2, lambda r, reg: None)
    root = _agg("t", 0, 2, regs[0])
    child = _agg("t", 1, 2, regs[1])
    for _ in range(2):
        for r, reg in enumerate(regs):
            for _ in range(3):
                reg.histogram("hvd_step_time_seconds").observe(
                    0.01 if r == 0 else 0.05)
        assert root.ingest(child.subtree_doc())
        root.flush()
    kinds = [f["kind"] for f in t_anomaly.recent_findings()]
    assert kinds == ["persistent_straggler"]
    assert t_anomaly.recent_findings()[0]["rank"] == 1


# -- the persistent-straggler detector ----------------------------------------------

_TRACE_KEYS = ("trace", "span", "traceparent", "ts", "profile")


@pytest.fixture
def no_jax_side_effects(monkeypatch):
    """A JAX finding would arm a device-trace capture and an autopilot
    decision in that package's singletons: both are off here, so no later
    test of this process sees them."""
    monkeypatch.setenv("HVD_TPU_PROFILE_ON_ANOMALY", "0")
    monkeypatch.setenv("HVD_TPU_AUTOPILOT", "off")


def test_observe_fleet_equals_jax(monkeypatch, no_jax_side_effects):
    monkeypatch.setenv("HVD_TPU_ANOMALY_STRAGGLER_WINDOWS", "3")
    monkeypatch.setenv("HVD_TPU_ANOMALY_STRAGGLER_RATIO", "1.3")
    engines = {"j": j_anomaly.AnomalyEngine(registry=j_reg.Registry()),
               "t": t_anomaly.AnomalyEngine(registry=t_reg.Registry())}
    rng = np.random.RandomState(7)
    found = {"j": [], "t": []}
    for w in range(60):
        size = int(rng.choice([1, 3, 4]))
        slow = int(rng.choice([1, 2])) if w < 30 else 2
        per_rank = {}
        for r in range(size):
            t = 0.02 * (1 + 0.05 * rng.rand())
            if r == slow and rng.rand() < 0.8:
                t *= 1.6
            per_rank[str(r)] = {"win_step_time": t, "steps": w}
        per_rank["9"] = {"steps": 3}  # no window yet: ignored
        for p, eng in engines.items():
            found[p].append([
                {k: v for k, v in f.items() if k not in _TRACE_KEYS}
                for f in eng.observe_fleet(per_rank)])
    assert found["t"] == found["j"]
    assert sum(len(f) for f in found["t"]) >= 2
    assert {f["kind"] for fs in found["t"] for f in fs} == \
        {"persistent_straggler"}
    engines["t"].reset_baselines()
    assert engines["t"]._straggler_run == 0


# -- the metrics CLI -------------------------------------------------------------------

def _scrape_text():
    reg = t_reg.Registry()
    _fill_steps(0, reg)
    reg.gauge("hvd_hbm_peak_bytes").set(2e9)
    reg.gauge("hvd_hbm_limit_bytes").set(8e10)
    reg.gauge("hvd_hbm_oom_margin_bytes").set(7.8e10)
    reg.counter("hvd_compile_total").inc(3)
    reg.counter("hvd_compile_cache_miss_total").inc(1)
    reg.histogram("hvd_compile_seconds", labels={"function": "f"}
                  ).observe(1.5)
    for cat, v in (("compute", 8.0), ("input_wait", 1.0),
                   ("exposed_comm", 0.5)):
        reg.counter("hvd_goodput_seconds_total",
                    labels={"category": cat}).inc(v)
    reg.counter("hvd_anomaly_total",
                labels={"kind": "step_time_drift"}).inc(2)
    reg.gauge("hvd_serving_qps").set(12.5)
    reg.gauge("hvd_serving_replicas_live").set(1)
    reg.gauge("hvd_serving_replicas_target").set(2)
    reg.gauge("hvd_tokens_per_second").set(4321.0)
    reg.counter("hvd_autopilot_decisions_total",
                labels={"policy": "p", "outcome": "fired"}).inc()
    reg.counter("hvd_remesh_total").inc()
    reg.counter("hvd_driver_takeovers_total").inc()
    root = t_fleet.FleetAggregator(0, 1, 1, registry=reg,
                                   push_interval=60.0)
    return root.render_fleet() + "garbage line\n# comment\n"


def test_parse_and_render_top_equal_jax(monkeypatch):
    text = _scrape_text()
    series = t_cli.parse_prometheus(text)
    assert series == j_cli.parse_prometheus(text)
    monkeypatch.setattr(time, "strftime", lambda *a: "12:00:00")
    frame = t_cli.render_top(series, "src")
    assert frame == j_cli.render_top(series, "src")
    for want in ("ranks reporting : 1/1", "steps total     : 10",
                 "GOODPUT", "SERVING", "ANOMALIES", "AUTOPILOT",
                 "per-rank windowed step time:"):
        assert want in frame, want
    assert t_cli.render_top({}, "x") == j_cli.render_top({}, "x")


def test_top_command_equals_jax(monkeypatch):
    reg = t_reg.Registry()
    _fill_steps(1, reg)
    exp = t_exp.MetricsExporter(registry=reg, port=0)
    exp.start()
    monkeypatch.setattr(time, "strftime", lambda *a: "12:00:00")
    outs = {}
    try:
        for p, cli in (("j", j_cli), ("t", t_cli)):
            for url in (f"http://127.0.0.1:{exp.port}",
                        f"http://127.0.0.1:{exp.port}/metrics"):
                buf = io.StringIO()
                with redirect_stdout(buf):
                    rc = cli.main(["top", "--url", url, "--once"])
                outs[(p, url)] = (rc, buf.getvalue())
    finally:
        exp.stop()
    for url in {u for _, u in outs}:
        assert outs[("t", url)] == outs[("j", url)]
        assert outs[("t", url)][0] == 0
        assert "steps total     : 20" in outs[("t", url)][1]
    err = io.StringIO()
    with redirect_stderr(err):
        assert t_cli.main(["top", "--url", "http://127.0.0.1:1",
                           "--once"]) == 1


def _obs_store(d):
    os.makedirs(d, exist_ok=True)
    t0 = 1.7e9
    with open(os.path.join(d, "obs_rank0.jsonl"), "w") as f:
        for i in range(4):
            f.write(json.dumps({"ts": t0 + i, "rank": 0, "step": i + 1,
                                "step_time_s": 0.02 + 0.001 * i,
                                "units_per_s": 1000.0 + i}) + "\n")
        f.write(json.dumps({
            "ts": t0 + 5, "rank": 0, "trigger": "preemption_drain",
            "takeover": True, "remesh_total_s": 3.5,
            "remesh": {"drain": 0.5, "rendezvous": 1.25,
                       "first_step": 0.75}}) + "\n")
        f.write(json.dumps({
            "ts": t0 + 6, "rank": 0, "serving": {
                "window_s": 10.0, "requests": 120, "qps": 12.0,
                "p50_s": 0.05, "p99_s": 1.5, "shed": 2,
                "dominant_stage": "queue",
                "stage_shares": {"queue": 0.61},
                "unattributed_frac": 0.012}}) + "\n")
        f.write(json.dumps({
            "ts": t0 + 7, "rank": 0, "goodput": {
                "compute": 8.0, "input_wait": 1.0, "idle_other": 0.25},
            "goodput_fraction": 0.86, "goodput_steps": 5,
            "goodput_wall_s": 9.25, "goodput_closed": False}) + "\n")
    with open(os.path.join(d, "obs_rank1.jsonl"), "w") as f:
        f.write(json.dumps({"ts": t0 + 0.5, "rank": 1, "step": 1,
                            "step_time_s": 0.03}) + "\n")
    with open(os.path.join(d, "actions_rank0.jsonl"), "w") as f:
        f.write(json.dumps({
            "ts": t0 + 8, "rank": 0, "policy": "straggler_evict",
            "action": "remesh", "finding": "persistent_straggler",
            "outcome": "fired", "reason": "rank 3 slow",
            "target_rank": 3, "trace": "cd" * 16,
            "gate": {"remesh_p50_s": 4.0, "margin_frac": 0.2}}) + "\n")


@pytest.mark.parametrize("flags", [[], ["--rank", "0"], ["--last", "2"],
                                   ["--json"], ["--remesh"], ["--actions"],
                                   ["--serving"], ["--goodput"],
                                   ["--goodput", "--json"]],
                         ids=lambda f: "_".join(f) or "steps")
def test_history_equals_jax(tmp_path, flags):
    d = str(tmp_path / "obs")
    _obs_store(d)
    outs = {}
    for p, cli in (("j", j_cli), ("t", t_cli)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main(["history", "--dir", d, *flags])
        outs[p] = (rc, buf.getvalue())
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == 0 and outs["t"][1]


def test_history_tables_equal_jax(tmp_path):
    from horovod_tpu_torch.metrics.timeseries import read_series
    d = str(tmp_path / "obs")
    _obs_store(d)
    points = read_series(d)
    for name in ("render_remesh_table", "render_serving_table",
                 "render_goodput_table"):
        key = {"render_remesh_table": "remesh",
               "render_serving_table": "serving",
               "render_goodput_table": "goodput"}[name]
        rows = [p for p in points if isinstance(p.get(key), dict)]
        assert getattr(t_cli, name)(rows) == getattr(j_cli, name)(rows)
    decisions = read_series(d, basename="actions")
    assert t_cli.render_actions_table(decisions) == \
        j_cli.render_actions_table(decisions)
    assert t_cli.render_remesh_table([]) == ""
    err = io.StringIO()
    with redirect_stderr(err), redirect_stdout(io.StringIO()):
        assert t_cli.main(["history", "--dir", str(tmp_path / "none"),
                           "--actions"]) == 1
