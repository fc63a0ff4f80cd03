"""The port's canary rollout against the JAX package's, on the CPU:
``version_windows``, ``compare`` and the golden probe give the JAX
functions' results on the same request-log entries and the same stub
replicas; the controller walks idle → canary → expanding → promoted and
→ rolling_back → rolled_back with its status persisted, refuses a
one-slot fleet, keeps its stage window across a log trim, and drives the
governed transition in process (the JAX ``tests/test_rollout.py:702``:
evaluate → ``rollout_verdict`` → autopilot decision → hook, one trace id
a rollout); and ``python -m horovod_tpu_torch.serving rollout status``
prints the persisted status."""

import json
import random
import threading
import time

import pytest

from horovod_tpu.serving.rollout import comparator as j_cmp

from horovod_tpu_torch import autopilot as t_ap
from horovod_tpu_torch.metrics import anomaly as t_anomaly
from horovod_tpu_torch.serving.rollout import comparator as t_cmp


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from horovod_tpu_torch import chaos
    for name in ("HVD_TPU_AUTOPILOT", "HVD_TPU_AUTOPILOT_POLICY",
                 "HVD_TPU_OBS_DIR", "HVD_TPU_FAULT_PLAN"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HVD_TPU_PROFILE_ON_ANOMALY", "0")
    chaos.uninstall()
    t_ap.reset()
    t_anomaly.reset()
    yield
    chaos.uninstall()
    t_ap.reset()
    t_anomaly.reset()


def _wait(cond, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _entries(seed: int, n: int = 400):
    """A seeded request log: ok lines of versions 1-3 (with and without
    ledger stages), retried lines naming the version that failed, and
    lines the comparator ignores."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        r = rng.random()
        v = rng.choice([1, 2, 3])
        if r < 0.8:
            e = {"outcome": "ok", "version": v,
                 "latency_s": rng.lognormvariate(-4 + 0.3 * (v == 3), 0.5)}
            if rng.random() < 0.5:
                e["stages"] = {"queue": rng.random() * 1e-3,
                               "forward": rng.random() * 1e-2,
                               "page_wait": rng.random() * 1e-3 * v}
            out.append(e)
        elif r < 0.9:
            out.append({"outcome": "retried", "after_version": v})
        else:
            out.append({"outcome": rng.choice(["accepted", "failed",
                                               "shed"]), "id": str(i)})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_comparator_matches_jax(seed):
    entries = _entries(seed)
    for versions in ([2, 1], [3, 1], [1, 2, 3], [4, 1]):
        js = j_cmp.version_windows(entries, versions)
        ts = t_cmp.version_windows(entries, versions)
        assert ts == js
    stats = t_cmp.version_windows(entries, [1, 2, 3])
    for cand, inc in ((2, 1), (3, 1), (1, 3)):
        for kw in (dict(min_requests=10, max_p99_ratio=2.0,
                        max_error_rate=0.05),
                   dict(min_requests=10, max_p99_ratio=1.1,
                        max_error_rate=0.5),
                   dict(min_requests=500, max_p99_ratio=2.0,
                        max_error_rate=0.05),
                   dict(min_requests=10, max_p99_ratio=9.0,
                        max_error_rate=0.5, golden_divergence=0.7,
                        golden_max=0.5),
                   dict(min_requests=10, max_p99_ratio=9.0,
                        max_error_rate=0.5, golden_divergence=0.2)):
            assert t_cmp.compare(stats[cand], stats[inc], **kw) == \
                j_cmp.compare(stats[cand], stats[inc], **kw)


def test_comparator_verdicts_and_fractions():
    """The JAX battery's cases (``tests/test_rollout.py:484-534``)."""
    def ok(version, latency_s):
        return {"outcome": "ok", "version": version, "latency_s": latency_s}
    entries = ([ok(2, 0.01)] * 9 + [ok(1, 0.01)] * 20
               + [{"outcome": "retried", "after_version": 2}]
               + [{"outcome": "accepted", "id": "x"}])
    stats = t_cmp.version_windows(entries, [2, 1])
    assert stats[2]["requests"] == 10 and stats[2]["errors"] == 1
    assert stats[1] == {"version": 1, "requests": 20, "ok": 20,
                        "errors": 0, "error_rate": 0.0,
                        "p50_s": 0.01, "p99_s": 0.01}
    kw = dict(max_p99_ratio=2.0, max_error_rate=0.05)
    assert t_cmp.compare(stats[2], stats[1], min_requests=50, **kw)[0] \
        is None
    v, reason = t_cmp.compare(stats[2], stats[1], min_requests=10, **kw)
    assert v == "rollback" and "error rate" in reason
    slow = t_cmp.version_windows([ok(2, 0.5)] * 10 + [ok(1, 0.01)] * 10,
                                 [2, 1])
    v, reason = t_cmp.compare(slow[2], slow[1], min_requests=10, **kw)
    assert v == "rollback" and "p99" in reason
    good = t_cmp.version_windows([ok(2, 0.011)] * 10
                                 + [ok(1, 0.01)] * 10, [2, 1])
    assert t_cmp.compare(good[2], good[1], min_requests=10,
                         **kw)[0] == "promote"
    v, reason = t_cmp.compare(good[2], good[1], min_requests=10,
                              golden_divergence=49.0, golden_max=0.5,
                              **kw)
    assert v == "rollback" and "golden" in reason
    skew = t_cmp.version_windows([ok(2, 0.01)] * 9 + [ok(2, 1.0)], [2])
    assert skew[2]["p50_s"] == pytest.approx(0.01)
    assert skew[2]["p99_s"] == pytest.approx(1.0)


class _VersionStub:
    """A replica's wire contract: /infer answers y = [version] * len(x),
    /readyz answers 200."""

    def __init__(self, version):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        stub = self

        class _H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._send(200, {"ready": True, "version": stub.version})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n))
                stub.hits += 1
                x = doc.get("x") or [0.0]
                self._send(200, {"id": doc.get("id"),
                                 "y": [float(stub.version)] * len(x),
                                 "version": stub.version})

        self.version = version
        self.hits = 0
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()

    @property
    def endpoint(self):
        return ("127.0.0.1", self._srv.server_address[1])

    def close(self):
        self._srv.shutdown()


def test_golden_set_and_divergence_match_jax(tmp_path):
    p = tmp_path / "golden.json"
    p.write_text(json.dumps({"requests": [{"x": [1.0, 2.0]},
                                          {"x": [0.0]}]}))
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps([{"x": [3.0]}]))
    for path in (p, bare):
        assert t_cmp.load_golden_set(str(path)) == \
            j_cmp.load_golden_set(str(path))
    for body, match in (("[]", "no requests"),
                        (json.dumps([{"y": [1.0]}]), "no 'x'")):
        bad = tmp_path / "bad.json"
        bad.write_text(body)
        for mod in (t_cmp, j_cmp):
            with pytest.raises(ValueError, match=match):
                mod.load_golden_set(str(bad))
    a, b = _VersionStub(5), _VersionStub(2)
    try:
        reqs = t_cmp.load_golden_set(str(p))
        got = [mod.golden_divergence(a.endpoint, b.endpoint, reqs)
               for mod in (t_cmp, j_cmp)]
        assert got == [3.0, 3.0]
        assert a.hits == 4 and b.hits == 4
    finally:
        a.close()
        b.close()


class _FakeFleet:
    """The controller's fleet surface in process: records every pin."""

    def __init__(self, slots, eps_by_version=None):
        self._slots = list(slots)
        self.eps = dict(eps_by_version or {})
        self.pin_calls = []
        self.pinned = {}

    def slots(self):
        return list(self._slots)

    def pin_slot(self, slot, version, reason="pin", heal_version=None):
        self.pin_calls.append({"slot": slot, "version": version,
                               "reason": reason, "heal": heal_version})
        if version is None:
            self.pinned.pop(slot, None)
        else:
            self.pinned[slot] = version
        return True

    def unpin_slot(self, slot):
        return self.pin_slot(slot, None, reason="unpin")

    def endpoints_at(self, version):
        return list(self.eps.get(version, []))


def _router():
    from horovod_tpu_torch.serving import Router
    return Router(lambda: [], max_attempts=2)


def test_controller_state_machine_and_persisted_status(tmp_path):
    from horovod_tpu_torch.serving.rollout import (RolloutConfig,
                                                   RolloutController,
                                                   read_status)
    fleet = _FakeFleet([0, 1, 2])
    router = _router()
    cfg = RolloutConfig(canary_pct=34, expand_pct=50, window_s=60.0,
                        min_requests=5)
    ctl = RolloutController(fleet, router, cfg, store_dir=str(tmp_path))
    try:
        assert ctl.state == "idle" and ctl.evaluate(force=True) is None
        ctl.begin(candidate=7, incumbent=6)
        assert ctl.state == "canary" and ctl.canary_slots == [0]
        pins = {c["slot"]: c for c in fleet.pin_calls}
        assert pins[0]["version"] == 7 and pins[0]["heal"] == 6
        assert pins[1]["version"] == 6 and pins[1]["heal"] is None
        assert pins[2]["version"] == 6
        assert router.version_split() == {
            "pct": 34, "canary_version": 7, "incumbent_version": 6}
        with pytest.raises(RuntimeError, match="already in progress"):
            ctl.begin(candidate=8, incumbent=7)
        assert ctl.evaluate() is None and ctl.evaluate(force=True) is None
        ctl._on_promote({"rollout_id": "rollout-999-v9"})  # stale
        assert ctl.state == "canary"
        ctl._on_promote({"rollout_id": ctl.rollout_id})
        assert ctl.state == "expanding"
        assert router.version_split()["pct"] == 50
        fleet.pin_calls.clear()
        ctl._on_promote({"rollout_id": ctl.rollout_id})
        assert ctl.state == "promoted" and router.version_split() is None
        for s in (0, 1, 2):
            calls = [c for c in fleet.pin_calls if c["slot"] == s]
            assert calls[0]["version"] == 7 and calls[-1]["version"] is None
        doc = read_status(str(tmp_path))
        assert doc["state"] == "promoted"
        assert doc["rollout_id"] == ctl.rollout_id
        assert doc["trace"] == ctl.trace.trace_id
        assert [h["to"] for h in doc["history"]] == [
            "canary", "expanding", "promoted"]
        ctl.begin(candidate=9, incumbent=7)
        fleet.pin_calls.clear()
        ctl.rollback("test")
        assert ctl.state == "rolled_back" and router.version_split() is None
        for s in (0, 1, 2):
            last = [c for c in fleet.pin_calls if c["slot"] == s][-1]
            assert last["version"] == 7 and last["reason"] == "rollback"
        assert fleet.pinned == {0: 7, 1: 7, 2: 7}
        doc = read_status(str(tmp_path))
        assert doc["state"] == "rolled_back"
        assert [h["to"] for h in doc["history"]][-3:] == [
            "canary", "rolling_back", "rolled_back"]
        ctl.rollback()
        assert ctl.state == "rolled_back"
    finally:
        router.close()


def test_rollout_refuses_a_one_slot_fleet():
    from horovod_tpu_torch.serving.rollout import (RolloutConfig,
                                                   RolloutController)
    fleet = _FakeFleet([0])
    router = _router()
    try:
        ctl = RolloutController(fleet, router, RolloutConfig())
        with pytest.raises(RuntimeError, match="at least 2"):
            ctl.begin(candidate=2, incumbent=1)
        assert ctl.state == "idle" and fleet.pin_calls == []
        assert router.version_split() is None
    finally:
        router.close()


def test_stage_window_survives_a_log_trim(monkeypatch, tmp_path):
    from horovod_tpu_torch.serving.router import RequestLog
    from horovod_tpu_torch.serving.rollout import (RolloutConfig,
                                                   RolloutController)
    monkeypatch.setattr(RequestLog, "MAX_MEMORY", 200)
    router = _router()
    ctl = RolloutController(_FakeFleet([0, 1]), router,
                            RolloutConfig(canary_pct=50, window_s=0.0,
                                          min_requests=60),
                            store_dir=str(tmp_path))
    try:
        for i in range(150):
            router.log.note(f"pre-{i}", "ok", version=1, latency_s=0.01)
        ctl.begin(candidate=2, incumbent=1)
        for i in range(100):
            router.log.note(f"c2-{i}", "ok", version=2, latency_s=0.01)
            router.log.note(f"c1-{i}", "ok", version=1, latency_s=0.01)
        assert router.log.trimmed > 0
        f = ctl.evaluate(force=True)
        assert f is not None and f["verdict"] == "promote"
        assert f["canary_stats"]["requests"] >= 60
        assert f["incumbent_stats"]["requests"] >= 60
    finally:
        router.close()


def test_governed_rollout_in_process(monkeypatch, tmp_path, capsys):
    """Under ``act``: a healthy candidate walks canary → expanding →
    promoted through two fired ``rollout-promote`` decisions, a degraded
    one rolls back through one ``rollout-rollback``; each rollout's
    finding, decisions and transitions share one trace id, whose tree
    ``diagnostics trace <id>`` prints from a flight dump."""
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.serving.rollout import (RolloutConfig,
                                                   RolloutController)
    monkeypatch.setenv("HVD_TPU_AUTOPILOT", "act")
    t_ap.reset()
    fleet = _FakeFleet([0, 1])
    router = _router()
    ctl = RolloutController(fleet, router,
                            RolloutConfig(canary_pct=50, window_s=0.01,
                                          min_requests=5),
                            store_dir=str(tmp_path)).register_autopilot_hooks()

    def feed(version, latency_s, n=8):
        for i in range(n):
            router.log.note(f"f{version}-{time.monotonic_ns()}-{i}", "ok",
                            version=version, latency_s=latency_s)

    try:
        ctl.begin(candidate=2, incumbent=1)
        trace_id = ctl.trace.trace_id
        feed(2, 0.01)
        feed(1, 0.01)
        time.sleep(0.05)
        finding = ctl.evaluate()
        assert finding["verdict"] == "promote"
        assert finding["trace"] == trace_id
        assert _wait(lambda: ctl.state == "expanding", timeout=5)
        assert ctl.evaluate(force=True) is None  # a fresh window
        feed(2, 0.01)
        feed(1, 0.01)
        time.sleep(1.1)  # the rollout-promote cooldown
        assert ctl.evaluate(force=True)["verdict"] == "promote"
        assert _wait(lambda: ctl.state == "promoted", timeout=5)
        promoted = [d for d in t_ap.recent_decisions()
                    if d["policy"] == "rollout-promote"
                    and d["outcome"] == "fired"]
        assert len(promoted) == 2
        assert all(d["trace"] == trace_id for d in promoted)
        ctl.begin(candidate=3, incumbent=2)
        t2 = ctl.trace.trace_id
        assert t2 != trace_id
        feed(3, 0.5)
        feed(2, 0.01)
        f2 = ctl.evaluate(force=True)
        assert f2["verdict"] == "rollback" and "p99" in f2["reason"]
        assert f2["trace"] == t2
        assert _wait(lambda: ctl.state == "rolled_back", timeout=5)
        assert fleet.pinned == {0: 2, 1: 2}
        rb = [d for d in t_ap.recent_decisions()
              if d["policy"] == "rollout-rollback"
              and d["outcome"] == "fired"]
        assert len(rb) == 1 and rb[0]["trace"] == t2
        dump = tmp_path / "flight_rank0.json"
        recorder().dump_to(str(dump))
        from horovod_tpu_torch.diagnostics.__main__ import main as diag_main
        rc = diag_main(["trace", t2, "--flight", str(dump)])
        out = capsys.readouterr().out
        assert rc == 0 and "rollout" in out and "rolled_back" in out
    finally:
        router.close()


def test_rollout_status_cli(tmp_path, capsys):
    from horovod_tpu_torch.serving.__main__ import main as serving_main
    from horovod_tpu_torch.serving.rollout import (RolloutConfig,
                                                   RolloutController)
    assert serving_main(["rollout", "status", "--store-dir",
                         str(tmp_path)]) == 1
    assert "no status" in capsys.readouterr().out
    router = _router()
    try:
        RolloutController(_FakeFleet([0, 1]), router,
                          RolloutConfig(canary_pct=50),
                          store_dir=str(tmp_path)).begin(candidate=2,
                                                         incumbent=1)
    finally:
        router.close()
    assert serving_main(["rollout", "status", "--store-dir",
                         str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["state"] == "canary" and doc["candidate"] == 2
    assert doc["split"]["pct"] == 50
    # the JAX front reads the port's status file alike
    from horovod_tpu.serving.rollout import read_status as j_read
    assert j_read(str(tmp_path))["rollout_id"] == doc["rollout_id"]


def test_config_from_env_matches_jax(monkeypatch):
    import dataclasses

    from horovod_tpu.serving.rollout import RolloutConfig as JConfig
    from horovod_tpu_torch.serving.rollout import RolloutConfig
    assert dataclasses.asdict(RolloutConfig.from_env()) == \
        dataclasses.asdict(JConfig.from_env())
    monkeypatch.setenv("HVD_TPU_ROLLOUT_CANARY_PCT", "10")
    monkeypatch.setenv("HVD_TPU_ROLLOUT_GOLDEN_MAX_DIVERGENCE", "0.01")
    monkeypatch.setenv("HVD_TPU_ROLLOUT_MIN_REQUESTS", "7")
    got = dataclasses.asdict(RolloutConfig.from_env())
    assert got == dataclasses.asdict(JConfig.from_env())
    assert got["canary_pct"] == 10 and got["min_requests"] == 7
