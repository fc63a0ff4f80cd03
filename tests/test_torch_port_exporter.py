"""The port's per-worker exporter against the JAX package's, on the CPU:
``/metrics`` byte-equal over registries filled alike; ``/healthz`` (ok,
stalled with 503, shutdown) and ``/readyz`` from ``start_worker_exporter``
on states alike; the 404s; the ``/debug/*`` kinds; ``POST /metrics/push``
with its 404 and 409 (``tests/test_metrics.py:285-345``, ``:431-480``);
``peer_endpoint`` over host maps; a bind failure that warns and returns
None; and, in a gloo world of 2, ``init`` binding ``base + local_rank`` on
each rank.

The gloo ranks run ``python tests/test_torch_port_exporter.py --worker
exporter --out DIR``, importing no JAX.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import (reserve_ports, spawn_world,  # noqa: E402
                               worker_main)


# -- the worker (torch only) ---------------------------------------------------

def _w_exporter():
    import json
    import urllib.request

    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import _state

    r = hvd.rank()
    exp = _state.metrics_exporter
    cb = hvd.TelemetryCallback()
    for _ in range(r + 1):
        cb.on_step_begin()
        cb.on_step_end()
    dist.barrier()
    # each rank scrapes the other's exporter at base + its local rank
    other = int(os.environ["HVD_TPU_METRICS_PORT"]) + (1 - r)
    with urllib.request.urlopen(f"http://127.0.0.1:{other}/healthz",
                                timeout=10) as resp:
        peer = json.loads(resp.read())
    dist.barrier()
    return {"port": np.array(exp.port), "peer_rank": np.array(peer["rank"]),
            "peer_last_step": np.array(peer["last_step"]),
            "peer_size": np.array(peer["size"]),
            "fleet_children": np.array(exp.fleet.children, np.int64)}


if __name__ == "__main__":
    sys.exit(worker_main({"exporter": _w_exporter}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

import json  # noqa: E402
import socket  # noqa: E402
import time  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu.diagnostics import watchdog as j_wd  # noqa: E402
from horovod_tpu.metrics import exporter as j_exp  # noqa: E402
from horovod_tpu.metrics import fleet as j_fleet  # noqa: E402
from horovod_tpu.metrics import registry as j_reg  # noqa: E402

from horovod_tpu_torch.diagnostics import flight_recorder as t_flight  # noqa: E402
from horovod_tpu_torch.diagnostics import watchdog as t_wd  # noqa: E402
from horovod_tpu_torch.metrics import exporter as t_exp  # noqa: E402
from horovod_tpu_torch.metrics import fleet as t_fleet  # noqa: E402
from horovod_tpu_torch.metrics import registry as t_reg  # noqa: E402

HERE = os.path.abspath(__file__)


@pytest.fixture(autouse=True)
def fresh_singletons(monkeypatch):
    for name in ("HVD_TPU_WATCHDOG_SECONDS", "HOROVOD_WATCHDOG_SECONDS",
                 "HVD_TPU_PEER_HOSTS", "HVD_TPU_FLEET"):
        monkeypatch.delenv(name, raising=False)
    for mod in (j_wd, t_wd):
        mod.reset()
    t_flight.recorder().clear()
    t_reg.default_registry().clear()
    yield
    for mod in (j_wd, t_wd):
        mod.reset()
    t_flight.recorder().clear()
    t_reg.default_registry().clear()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _status(port, path, method="GET", body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _fill(reg):
    reg.counter("hvd_steps_total", help="steps").inc(2)
    reg.counter("hvd_anomaly_total", help="findings",
                labels={"kind": "step_time_drift"}).inc()
    reg.gauge("hvd_mfu", help="model FLOPs utilization").set(0.41)
    reg.gauge("hvd_overlap_bucket_bytes").set(3 << 20)
    h = reg.histogram("hvd_step_time_seconds", help="step seconds",
                      buckets=[0.01, 0.1, 1.0])
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    reg.histogram("hvd_compile_seconds", labels={"function": "step"},
                  buckets=[1.0]).observe(0.25)


def _both(**kw):
    """A JAX and a port exporter over registries filled alike."""
    jr, tr = j_reg.Registry(), t_reg.Registry()
    _fill(jr)
    _fill(tr)
    je = j_exp.MetricsExporter(registry=jr, port=0, **kw)
    te = t_exp.MetricsExporter(registry=tr, port=0, **kw)
    je.start()
    te.start()
    return je, te


def test_metrics_byte_equal_to_jax():
    je, te = _both()
    try:
        for path in ("/metrics", "/", "/metrics/"):
            js, jc, jb = _get(je.port, path)
            ts, tc, tb = _get(te.port, path)
            assert (ts, tc, tb) == (js, jc, jb)
        assert b"hvd_steps_total 2" in tb
        assert b'hvd_step_time_seconds_bucket{le="+Inf"} 4' in tb
        assert _get(te.port, "/healthz")[2] == _get(je.port, "/healthz")[2] \
            == b'{"status": "ok"}'
        assert _get(te.port, "/readyz")[2] == _get(je.port, "/readyz")[2]
    finally:
        je.stop()
        te.stop()


@pytest.mark.parametrize("method,path", [
    ("GET", "/nope"), ("GET", "/metrics/fleet"), ("GET", "/debug/nope"),
    ("POST", "/metrics/push"), ("POST", "/elsewhere")])
def test_not_found_equal_to_jax(method, path):
    je, te = _both()
    try:
        body = b"{}" if method == "POST" else None
        got = _status(te.port, path, method, body)
        assert got == _status(je.port, path, method, body)
        assert got[0] == 404
    finally:
        je.stop()
        te.stop()


@pytest.mark.parametrize("health,code", [
    (lambda: {"status": "shutdown"}, 503), (lambda: 1 / 0, 503),
    (lambda: {"status": "stalled", "last_step": 3}, 503),
    (lambda: {"status": "ok", "rank": 1}, 200)])
def test_health_and_ready_probes_equal_to_jax(health, code):
    je, te = _both(health_fn=health)
    try:
        for path in ("/healthz", "/readyz"):
            got = _status(te.port, path)
            assert got == _status(je.port, path), path
            assert got[0] == code  # ready iff healthy
    finally:
        je.stop()
        te.stop()


@pytest.mark.parametrize("kind", ["stacks", "flight", "engine",
                                  "exemplars", "profile"])
def test_debug_kinds(kind, monkeypatch, tmp_path):
    from horovod_tpu_torch import profiling
    from horovod_tpu_torch.serving import ledger
    monkeypatch.setenv("HVD_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    profiling.reset()
    ledger.reset()
    t_flight.record_event("debug_marker", n=3)
    ledger.default_ring().add({"trace": "ab" * 16, "e2e_s": 0.2})
    exp = t_exp.MetricsExporter(registry=t_reg.Registry(), port=0)
    exp.start()
    try:
        code, ctype, body = _get(exp.port, f"/debug/{kind}")
        assert code == 200
        if kind == "stacks":
            assert ctype == "text/plain"
            text = body.decode()
            # the handler thread, and this (test) thread waiting on it
            assert "stacks_text" in text and "test_debug_kinds" in text
            return
        doc = json.loads(body)
        assert ctype == "application/json"
        if kind == "flight":
            assert set(doc) == set(j_exp_flight_keys())
            assert doc["events"][-1]["kind"] == "debug_marker"
        elif kind == "engine":
            assert set(doc) == {"rank", "ts"}
        elif kind == "exemplars":
            assert doc == {"exemplars": [{"trace": "ab" * 16,
                                          "e2e_s": 0.2}]}
        else:
            # arms only: the window opens on the training thread at the
            # next step boundary, never on the handler's thread
            from horovod_tpu_torch.profiling.manager import default_steps
            assert doc["started"] is True
            assert doc["steps"] == default_steps()
            assert doc["path"].startswith(str(tmp_path / "prof"))
            mgr = profiling.default_manager()
            assert mgr.status()["pending"] is not None
            assert mgr.status()["active"] is None
            again = json.loads(_get(exp.port,
                                    "/debug/profile?steps=2")[2])
            assert again["started"] is False  # one capture at a time
            assert again["status"]["pending"]["path"] == doc["path"]
    finally:
        exp.stop()
        profiling.reset()
        ledger.reset()


def j_exp_flight_keys():
    from horovod_tpu.diagnostics.flight_recorder import FlightRecorder
    return FlightRecorder(4).dump().keys()


def test_debug_profile_arms_the_requested_steps(monkeypatch, tmp_path):
    from horovod_tpu_torch import profiling
    monkeypatch.setenv("HVD_TPU_PROFILE_DIR", str(tmp_path))
    profiling.reset()
    exp = t_exp.MetricsExporter(registry=t_reg.Registry(), port=0)
    exp.start()
    try:
        doc = json.loads(_get(exp.port, "/debug/profile?steps=2")[2])
        assert doc["started"] is True and doc["steps"] == 2
        assert set(doc) == {"rank", "started", "path", "steps"}
    finally:
        exp.stop()
        profiling.reset()


def _fleet_pair(generation=0):
    return (j_fleet.FleetAggregator(0, 2, 9, registry=j_reg.Registry(),
                                    generation=generation,
                                    push_interval=60.0),
            t_fleet.FleetAggregator(0, 2, 9, registry=t_reg.Registry(),
                                    generation=generation,
                                    push_interval=60.0))


@pytest.mark.parametrize("case", ["ok", "other_generation", "other_size",
                                  "not_a_child", "garbage", "not_json"])
def test_push_codes_equal_to_jax(case):
    je, te = _both()
    je.fleet, te.fleet = _fleet_pair(generation=7)
    try:
        child = t_fleet.FleetAggregator(1, 2, 9, registry=t_reg.Registry(),
                                        generation=7, push_interval=60.0)
        doc = child.subtree_doc()
        doc = {"ok": doc, "other_generation": dict(doc, generation=6),
               "other_size": dict(doc, size=3),
               "not_a_child": dict(doc, from_rank=5),
               "garbage": {"hello": "world"}}.get(case)
        body = b"{" if doc is None else json.dumps(doc).encode()
        got = _status(te.port, "/metrics/push", "POST", body)
        want = _status(je.port, "/metrics/push", "POST", body)
        assert got[0] == want[0] == {"ok": 200, "not_json": 400}.get(
            case, 409)
        if case != "not_json":
            assert got == want
    finally:
        je.stop()
        te.stop()


def test_peer_endpoint_equals_jax():
    rng = np.random.RandomState(0)
    maps = [None, [], ["h0", "h0"], ["h0", "", "h1"],
            ["hostA", "hostA", "hostB", "hostB"]]
    for _ in range(20):
        n = rng.randint(1, 12)
        maps.append([f"h{rng.randint(3)}" if rng.rand() > 0.1 else ""
                     for _ in range(n)])
    for hosts in maps:
        for rank in range(14):
            got = t_exp.peer_endpoint(rank, 9090, hosts)
            assert got == j_exp.peer_endpoint(rank, 9090, hosts)
    assert t_exp.peer_endpoint(2, 9090, ["a", "a", "b"]) == ("b", 9090)


class _JaxState:
    initialized = True
    rank, size, local_rank, cross_size = 0, 1, 0, 1
    hostname = "test-host"
    backend = None

    def __init__(self, port):
        from horovod_tpu.common.config import Config
        self.config = Config(metrics_port=port)


class _PortState(_JaxState):
    def __init__(self, port):
        from horovod_tpu_torch.common.config import Config
        self.config = Config(metrics_port=port)


def test_worker_health_ok_stalled_shutdown_equal_to_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET", "0")
    monkeypatch.setenv("HVD_TPU_WATCHDOG_SECONDS", "0.3")
    base, held = reserve_ports(2)
    try:
        js, ts = _JaxState(base), _PortState(base + 1)
        je = j_exp.start_worker_exporter(js)
        te = t_exp.start_worker_exporter(ts)
    finally:
        for s in held:
            s.close()
    assert (je.port, te.port) == (base, base + 1) and te.fleet is None
    try:
        docs = {}

        def probe(name):
            for (key, exp) in (("j", je), ("t", te)):
                code, body = _status(exp.port, "/healthz")
                docs[(name, key)] = (code, json.loads(body))

        probe("fresh")  # no step yet: still compiling is not stalled
        for mod in (j_wd, t_wd):
            mod.notify_progress(4)
        probe("ok")
        time.sleep(0.6)
        probe("stalled")
        js.initialized = ts.initialized = False
        probe("shutdown")
        for name, code, status in (("fresh", 200, "ok"), ("ok", 200, "ok"),
                                   ("stalled", 503, "stalled"),
                                   ("shutdown", 503, "shutdown")):
            (jc, jd), (tc, td) = docs[(name, "j")], docs[(name, "t")]
            assert tc == jc == code and td["status"] == jd["status"] == \
                status, name
            assert set(td) == set(jd)
            for k in ("rank", "size", "hostname", "last_step",
                      "engine_alive"):
                assert td[k] == jd[k], (name, k)
            assert set(td["watchdog"]) == set(jd["watchdog"])
            assert td["watchdog"]["timeout_s"] == 0.3
            age = td["last_step_age_s"]
            assert (age is None) == (name == "fresh")
            assert td["watchdog"]["last_fed_age_s"] == age
        assert docs[("stalled", "t")][1]["last_step"] == 4
        # readiness follows health
        assert _status(te.port, "/readyz")[0] == 503
    finally:
        je.stop()
        te.stop()


def test_worker_exporter_off_and_bind_failure(monkeypatch, caplog):
    assert t_exp.start_worker_exporter(_PortState(0)) is None
    squat = socket.socket()
    squat.bind(("127.0.0.1", 0))
    squat.listen(1)
    try:
        st = _PortState(squat.getsockname()[1])
        assert t_exp.start_worker_exporter(st) is None  # warns, no raise
    finally:
        squat.close()
    st = _PortState(65535)
    st.local_rank = 3
    assert t_exp.start_worker_exporter(st) is None  # past the port range


def test_stop_without_start_and_fleet_thread():
    import threading
    exp = t_exp.MetricsExporter(registry=t_reg.Registry(), port=0)
    t = threading.Thread(target=exp.stop, daemon=True)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()
    exp = t_exp.MetricsExporter(registry=t_reg.Registry(), port=0)
    agg = t_fleet.FleetAggregator(0, 1, 1, registry=t_reg.Registry(),
                                  push_interval=0.05)
    exp.fleet = agg.start()
    exp.start()
    exp.stop()
    assert exp.fleet is None and agg._thread is None


def test_init_binds_base_plus_local_rank_in_a_gloo_world(tmp_path):
    base, held = reserve_ports(2)
    try:
        out = spawn_world(HERE, "exporter", 2, tmp_path, extra_env={
            "HVD_TPU_METRICS_PORT": str(base),
            "HVD_TPU_FLEET_PUSH_SECONDS": "60"})
    finally:
        for s in held:
            s.close()
    assert [int(o["port"]) for o in out] == [base, base + 1]
    for r, o in enumerate(out):
        assert int(o["peer_rank"]) == 1 - r
        assert int(o["peer_size"]) == 2
        assert int(o["peer_last_step"]) == (1 - r) + 1
    assert out[0]["fleet_children"].tolist() == [1]
    assert out[1]["fleet_children"].tolist() == []
