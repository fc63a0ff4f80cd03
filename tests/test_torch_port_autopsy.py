"""The port's hang watchdog and autopsy bundle against the JAX package's,
on the CPU: the watchdog cases of ``tests/test_diagnostics.py:225-339``
(no false positive on a healthy loop, one trigger a stall, zero disarms,
the environment's default, suspend and resume, ``TelemetryCallback``
arming it and standing it down), each run on both packages' watchdogs
side by side; the same file set and summary keys from ``write_autopsy``
without ``init``; ``suspects_from_engine`` on the same document; the crash
hooks' flight dump; the checkpoint store feeding progress; and, in a gloo
world of 2, rank 0's bundle holding ``peer_rank1_*``, fetched over
``/debug/*`` while rank 1 waits in a gloo barrier.

The gloo ranks run ``python tests/test_torch_port_autopsy.py --worker
autopsy --out DIR``, importing no JAX.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import (reserve_ports, spawn_world,  # noqa: E402
                               worker_main)


# -- the worker (torch only) ---------------------------------------------------

def _w_autopsy():
    import json

    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import _state
    from horovod_tpu_torch.diagnostics.autopsy import write_autopsy
    from horovod_tpu_torch.diagnostics.flight_recorder import record_event

    r = hvd.rank()
    record_event("worker_marker", rank=r)
    bundle = os.environ["HVD_TPU_AUTOPSY_DIR"]
    if r == 1:
        write_autopsy(reason="two-rank test")
    dist.barrier()
    if r == 0:
        # rank 1 sits in the next barrier meanwhile: its exporter must
        # answer with its main thread blocked in gloo
        write_autopsy(reason="two-rank test")
    dist.barrier()
    with open(os.path.join(bundle, f"summary_rank{r}.json")) as f:
        summary = json.load(f)
    return {"fetched": np.array(summary["peers_fetched"], np.int64),
            "unreachable": np.array(summary["peers_unreachable"], np.int64),
            "port": np.array(_state.metrics_exporter.port)}


if __name__ == "__main__":
    sys.exit(worker_main({"autopsy": _w_autopsy}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

import json  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu.common import basics as j_basics  # noqa: E402
from horovod_tpu.diagnostics import autopsy as j_autopsy  # noqa: E402
from horovod_tpu.diagnostics import flight_recorder as j_flight  # noqa: E402
from horovod_tpu.diagnostics import watchdog as j_wd  # noqa: E402

from horovod_tpu_torch.common import basics as t_basics  # noqa: E402
from horovod_tpu_torch.diagnostics import autopsy as t_autopsy  # noqa: E402
from horovod_tpu_torch.diagnostics import flight_recorder as t_flight  # noqa: E402
from horovod_tpu_torch.diagnostics import watchdog as t_wd  # noqa: E402

HERE = os.path.abspath(__file__)
PACKAGES = (("jax", j_wd), ("torch", t_wd))


@pytest.fixture(autouse=True)
def fresh_singletons(monkeypatch):
    """Every process-wide singleton this file touches starts and ends
    clean: both watchdogs, the port's flight ring and registry (never the
    JAX package's registry: its metrics cache their instruments)."""
    for name in ("HVD_TPU_WATCHDOG_SECONDS", "HOROVOD_WATCHDOG_SECONDS",
                 "HVD_TPU_WATCHDOG_REPEAT"):
        monkeypatch.delenv(name, raising=False)
    from horovod_tpu_torch.metrics.registry import default_registry
    for _, wd in PACKAGES:
        wd.reset()
    t_flight.recorder().clear()
    default_registry().clear()
    yield
    for _, wd in PACKAGES:
        wd.reset()
    t_flight.recorder().clear()
    default_registry().clear()


def _pair(**kw):
    """One watchdog of each package with the same settings, recording
    their triggers."""
    fired = {name: [] for name, _ in PACKAGES}
    dogs = {name: wd.Watchdog(on_trigger=fired[name].append, **kw)
            for name, wd in PACKAGES}
    return dogs, fired


# -- the watchdog ------------------------------------------------------------------

def test_watchdog_no_false_positive_during_healthy_loop():
    dogs, fired = _pair(timeout_s=0.6, check_interval_s=0.05)
    for d in dogs.values():
        d.start()
    try:
        t_end = time.monotonic() + 1.8
        step = 0
        while time.monotonic() < t_end:
            time.sleep(0.1)
            step += 1
            for d in dogs.values():
                d.notify_progress(step)
        assert fired == {"jax": [], "torch": []}
        assert [d.trigger_count for d in dogs.values()] == [0, 0]
        assert dogs["torch"]._last_step == dogs["jax"]._last_step == step
    finally:
        for d in dogs.values():
            d.stop()


@pytest.mark.parametrize("repeat", ["0", "1"])
def test_watchdog_triggers_once_on_stall(monkeypatch, repeat):
    monkeypatch.setenv("HVD_TPU_WATCHDOG_REPEAT", repeat)
    dogs, fired = _pair(timeout_s=0.3, check_interval_s=0.05)
    for d in dogs.values():
        d.start()
    try:
        time.sleep(1.2)  # several timeout periods with zero progress
    finally:
        for d in dogs.values():
            d.stop()
    counts = {k: d.trigger_count for k, d in dogs.items()}
    if repeat == "0":
        assert counts == {"jax": 1, "torch": 1}, fired  # one per stall
    else:
        assert counts["torch"] >= 2 and counts["jax"] >= 2, counts
    assert "no step progress" in fired["torch"][0]
    assert fired["torch"][0].split("(")[1] == fired["jax"][0].split("(")[1]
    kinds = [e["kind"] for e in t_flight.recorder().events()]
    assert kinds.count("watchdog_trigger") == counts["torch"]


def test_watchdog_disarmed_by_zero_timeout():
    for _, wd in PACKAGES:
        d = wd.Watchdog(timeout_s=0)
        d.start()
        assert not d.armed
    os.environ["HVD_TPU_WATCHDOG_SECONDS"] = "0"
    try:
        assert t_wd.ensure_watchdog() is None is j_wd.ensure_watchdog()
    finally:
        os.environ.pop("HVD_TPU_WATCHDOG_SECONDS")


def test_watchdog_env_default(monkeypatch):
    assert t_wd.Watchdog().timeout_s == j_wd.Watchdog().timeout_s == 600.0
    monkeypatch.setenv("HOROVOD_WATCHDOG_SECONDS", "17")
    assert t_wd.Watchdog().timeout_s == j_wd.Watchdog().timeout_s == 17.0
    monkeypatch.setenv("HVD_TPU_WATCHDOG_SECONDS", "42.5")
    assert t_wd.Watchdog().timeout_s == j_wd.Watchdog().timeout_s == 42.5
    d = t_wd.Watchdog(timeout_s=100)
    assert d._interval == j_wd.Watchdog(timeout_s=100)._interval == 10.0


def test_watchdog_suspend_resume_cycle(monkeypatch):
    monkeypatch.setenv("HVD_TPU_WATCHDOG_SECONDS", "120")
    for _, wd in PACKAGES:
        d = wd.ensure_watchdog()
        assert d is not None and d.armed
        assert wd.ensure_watchdog() is d  # one process-wide watchdog
        wd.suspend()
        assert not d.armed
        wd.resume()
        assert d.armed
        wd.notify_progress(7)  # still wired to the same instance
        assert d._last_step == 7


def test_liveness_doc_equals_jax():
    for _, wd in PACKAGES:
        live = wd.liveness()
        assert live["last_step"] is None
        assert live["last_step_age_s"] is None  # still compiling != stalled
    docs = {}
    for name, wd in PACKAGES:
        wd.notify_progress(7)
        docs[name] = wd.liveness()
    assert set(docs["torch"]) == set(docs["jax"])
    assert docs["torch"]["last_step"] == docs["jax"]["last_step"] == 7
    assert docs["torch"]["armed"] is docs["jax"]["armed"] is False
    assert 0 <= docs["torch"]["last_step_age_s"] < 5
    assert docs["torch"]["timeout_s"] == docs["jax"]["timeout_s"]


def test_telemetry_callback_arms_and_stands_down(monkeypatch):
    from horovod_tpu.train.callbacks import TelemetryCallback as JCb
    from horovod_tpu_torch.train.callbacks import TelemetryCallback as TCb
    monkeypatch.setenv("HVD_TPU_WATCHDOG_SECONDS", "120")
    for state, cb_cls in ((j_basics._state, JCb), (t_basics._state, TCb)):
        monkeypatch.setattr(state, "initialized", True)
        cb = cb_cls()
        assert cb.watchdog is not None and cb.watchdog.armed
        before = cb.watchdog._last_progress
        cb.on_step_begin()
        cb.on_step_end()
        assert cb.watchdog._last_progress >= before
        # the step number the timer counted (the JAX registry is the
        # process's, cumulative over earlier tests)
        assert cb.watchdog._last_step == int(cb.timer.steps.value)
        cb.on_train_end()
        assert not cb.watchdog.armed
        monkeypatch.setattr(state, "initialized", False)


def test_telemetry_callback_does_not_arm_uninitialized():
    from horovod_tpu_torch.train.callbacks import TelemetryCallback
    assert not t_basics.is_initialized()
    cb = TelemetryCallback()
    assert cb.watchdog is None and t_wd._WATCHDOG is None
    cb.on_step_begin()
    cb.on_step_end()
    # the liveness stamp moves even with no watchdog armed
    assert t_wd.liveness()["last_step"] == 1


# -- the bundle ----------------------------------------------------------------------

def _bundle_files(bundle):
    return sorted(os.listdir(bundle))


@pytest.fixture
def no_earlier_evidence(monkeypatch):
    """Both packages' serving exemplars and the JAX autopilot's decisions
    empty: earlier tests of this process fill the JAX ones, which are set
    aside and put back after (the port's autopsy writes ``actions: []``
    until its autopilot exists), as are the JAX flight ring, goodput
    ledger and profile manager that a JAX bundle reads or flushes."""
    from horovod_tpu import autopilot as j_autopilot
    from horovod_tpu.metrics import goodput as j_goodput
    from horovod_tpu.profiling import manager as j_manager
    from horovod_tpu.serving import ledger as j_ledger
    from horovod_tpu_torch.serving import ledger as t_ledger
    for mod, name in ((j_autopilot, "_ENGINE"), (j_ledger, "_default_ring"),
                      (j_goodput, "_LEDGER"), (j_manager, "_MANAGER"),
                      (j_flight, "_RECORDER")):
        monkeypatch.setattr(mod, name, None)
    t_ledger.reset()
    yield
    t_ledger.reset()


def test_write_autopsy_without_init_matches_jax(tmp_path, monkeypatch,
                                                no_earlier_evidence):
    monkeypatch.delenv("HVD_TPU_TIMELINE", raising=False)
    monkeypatch.delenv("HOROVOD_TIMELINE", raising=False)
    from horovod_tpu.common.config import reset_config as j_reset
    from horovod_tpu_torch.common.config import reset_config as t_reset
    j_reset()
    t_reset()
    j_flight.record_event("unit_test_marker")
    t_flight.record_event("unit_test_marker")
    jb = j_autopsy.write_autopsy(str(tmp_path / "j"), reason="unit test",
                                 fetch_peers=False)
    tb = t_autopsy.write_autopsy(str(tmp_path / "t"), reason="unit test",
                                 fetch_peers=False)
    assert _bundle_files(tb) == _bundle_files(jb)
    rank = t_autopsy._my_rank()
    assert _bundle_files(tb) == sorted(
        f"{k}_rank{rank}.{'txt' if k == 'stacks' else 'json'}"
        for k in ("stacks", "flight", "engine", "metrics", "summary"))
    docs = {}
    for name, b in (("j", jb), ("t", tb)):
        with open(os.path.join(b, f"summary_rank{rank}.json")) as f:
            docs[name] = json.load(f)
        with open(os.path.join(b, f"engine_rank{rank}.json")) as f:
            docs[name + "_engine"] = json.load(f)
        with open(os.path.join(b, f"flight_rank{rank}.json")) as f:
            docs[name + "_flight"] = json.load(f)
    s, js = docs["t"], docs["j"]
    assert set(s) == set(js)
    assert isinstance(s["written_at"], float)
    for k in ("reason", "rank", "suspects", "actions", "driver_outage",
              "exemplars", "peers_fetched", "peers_unreachable"):
        assert s[k] == js[k], k
    assert set(docs["t_engine"]) == set(docs["j_engine"]) == {"rank", "ts"}
    assert set(docs["t_flight"]) == set(docs["j_flight"])
    assert any(e["kind"] == "unit_test_marker"
               for e in docs["t_flight"]["events"])
    with open(os.path.join(tb, f"stacks_rank{rank}.txt")) as f:
        assert "stacks_text" in f.read()  # the dumping frame itself


def test_write_autopsy_ships_exemplars_like_jax(tmp_path,
                                                no_earlier_evidence):
    from horovod_tpu.serving import ledger as j_ledger
    from horovod_tpu_torch.serving import ledger as t_ledger
    ex = {"trace": "ab" * 16, "e2e_s": 0.5, "stages": {"queue": 0.4}}
    for led in (j_ledger, t_ledger):
        led.default_ring().add(ex)
    jb = j_autopsy.write_autopsy(str(tmp_path / "j"), fetch_peers=False)
    tb = t_autopsy.write_autopsy(str(tmp_path / "t"), fetch_peers=False)
    assert _bundle_files(tb) == _bundle_files(jb)
    rank = t_autopsy._my_rank()
    for b in (jb, tb):
        with open(os.path.join(b, f"exemplars_rank{rank}.json")) as f:
            assert json.load(f) == {"exemplars": [ex]}
        with open(os.path.join(b, f"summary_rank{rank}.json")) as f:
            assert json.load(f)["exemplars"] == 1


def test_suspects_from_engine_equals_jax():
    engine = {"engine_state": {"domains": [
        {"id": 0, "pending": [
            {"name": "a", "waited_s": 1.0, "ready_ranks": [0],
             "missing_ranks": [1]},
            {"name": "b", "waited_s": 9.0, "ready_ranks": [0, 2],
             "missing_ranks": [3]}]},
        {"id": 1, "pending": [{"name": "c", "waited_s": None}]}]}}
    sus = t_autopsy.suspects_from_engine(engine)
    assert sus == j_autopsy.suspects_from_engine(engine)
    assert [s["tensor"] for s in sus] == ["b", "a", "c"]
    assert t_autopsy.suspects_from_engine(t_autopsy.engine_doc()) == []


def test_crash_hooks_dump_the_flight_ring(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[1]))
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_value))
    monkeypatch.setattr(t_flight, "_hooks_installed", False)
    monkeypatch.setenv("HVD_TPU_AUTOPSY_DIR", str(tmp_path / "dumps"))
    path = t_flight.crash_dump_path()
    assert path == j_flight.crash_dump_path()
    t_flight.install_crash_hooks()
    hook = sys.excepthook
    t_flight.install_crash_hooks()  # idempotent: no second chain
    assert sys.excepthook is hook
    sys.excepthook(ValueError, ValueError("boom"), None)
    with open(path) as f:
        doc = json.load(f)
    assert doc["events"][-1]["kind"] == "crash"
    assert doc["events"][-1]["error"] == repr(ValueError("boom"))
    assert set(doc) == set(j_flight.FlightRecorder(4).dump())

    def bad():
        raise RuntimeError("thread boom")

    t = threading.Thread(target=bad, name="doomed")
    t.start()
    t.join()
    with open(path) as f:
        last = json.load(f)["events"][-1]
    assert last["kind"] == "thread_crash" and last["thread"] == "doomed"
    assert [type(e) for e in seen] == [ValueError, RuntimeError]


def test_peer_fetch_backs_off_then_gives_up():
    """``_fetch`` retries a dead peer with backoff (3 attempts, under its
    deadline), gives up on an HTTP status at once, and returns None
    either way; the retry metrics name the site."""
    from horovod_tpu_torch.metrics.exporter import MetricsExporter
    from horovod_tpu_torch.metrics.registry import Registry, default_registry
    reg = default_registry()
    t0 = time.monotonic()
    assert t_autopsy._fetch("http://127.0.0.1:1/debug/stacks") is None
    assert 0.3 < time.monotonic() - t0 < 10.0
    site = {"site": "autopsy.peer_fetch"}
    assert reg.get("hvd_retry_attempts_total", site).value == 3
    assert reg.get("hvd_retry_exhausted_total", site).value == 1
    exp = MetricsExporter(registry=Registry(), port=0)
    exp.start()
    try:
        url = f"http://127.0.0.1:{exp.port}/debug"
        assert t_autopsy._fetch(url + "/nope") is None  # 404: no retry
        assert reg.get("hvd_retry_attempts_total", site).value == 3
        assert t_autopsy._fetch(url + "/engine") is not None
    finally:
        exp.stop()


def test_checkpoint_commit_feeds_progress(tmp_path):
    import torch

    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    assert t_wd.liveness()["last_step_age_s"] is None
    store = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    store.save(3, {"w": torch.ones(4)}, wait=True)
    age = t_wd.liveness()["last_step_age_s"]
    assert age is not None and age < 5
    t_wd.reset()
    store.restore_latest()
    assert t_wd.liveness()["last_step_age_s"] is not None
    store.close()


def test_peer_bundle_in_a_gloo_world(tmp_path):
    base, held = reserve_ports(2)
    bundle = tmp_path / "bundle"
    try:
        out = spawn_world(HERE, "autopsy", 2, tmp_path, extra_env={
            "HVD_TPU_METRICS_PORT": str(base),
            "HVD_TPU_AUTOPSY_DIR": str(bundle)})
    finally:
        for s in held:
            s.close()
    assert [int(o["port"]) for o in out] == [base, base + 1]
    assert out[0]["fetched"].tolist() == [1]
    assert out[0]["unreachable"].tolist() == []
    files = set(os.listdir(bundle))
    for r in (0, 1):
        for kind in ("stacks", "flight", "engine", "metrics", "summary"):
            ext = "txt" if kind == "stacks" else "json"
            assert f"{kind}_rank{r}.{ext}" in files, (kind, r, files)
    for kind, ext in (("stacks", "txt"), ("flight", "json"),
                      ("engine", "json")):
        assert f"peer_rank1_{kind}.{ext}" in files
    with open(bundle / "peer_rank1_flight.json") as f:
        peer = json.load(f)
    assert peer["rank"] == 1
    assert any(e["kind"] == "worker_marker" for e in peer["events"])
    with open(bundle / "peer_rank1_stacks.txt") as f:
        stacks = f.read()
    # rank 1's main thread was blocked in the gloo barrier
    assert "barrier" in stacks and "_w_autopsy" in stacks
    with open(bundle / "peer_rank1_engine.json") as f:
        assert set(json.load(f)) == {"rank", "ts"}
