"""The port's re-mesh seams, in one process: ``StepTimer.end_step`` closes a
re-mesh episode (``remesh.note_step_end``), the episode's total feeds
goodput's ``remesh_recovery``, ``init`` books the ``rendezvous`` and
``rebuild`` phases, and an in-place re-mesh (``_apply_world_update`` on a
world of one) suspends the hang watchdog and takes the exporter's
``/healthz`` down while the world is torn down, then brings both back for
the new world. Also the episode's own bookkeeping against the JAX
package's (``horovod_tpu/elastic/remesh.py``) and the worker's outage
window."""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import pytest

import horovod_tpu.elastic.remesh as jx_remesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.diagnostics import flight_recorder, watchdog
from horovod_tpu_torch.elastic import notification, outage, remesh
from horovod_tpu_torch.metrics import anomaly, goodput, registry, timeseries
from horovod_tpu_torch.train.callbacks import StepTimer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import reserve_port, reserve_ports  # noqa: E402

_IDENTITY = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
             "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
             "HOROVOD_CROSS_SIZE", "HOROVOD_HOSTNAME", "HVD_TPU_COORD_ADDR",
             "HVD_TPU_COORD_PORT", "HVD_TPU_RENDEZVOUS_ADDR",
             "HVD_TPU_RENDEZVOUS_PORT", "HOROVOD_GLOO_RENDEZVOUS_ADDR",
             "HOROVOD_GLOO_RENDEZVOUS_PORT", "HVD_ELASTIC_GENERATION",
             "HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    hvd.shutdown()
    for k in _IDENTITY:       # restored after the test, whatever it set
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    for k in ("HVD_ELASTIC_KV", "HVD_ELASTIC_SECRET", "HVD_ELASTIC_CKPT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    monkeypatch.setenv("HVD_TPU_PROFILE_ON_ANOMALY", "0")
    monkeypatch.setenv("HVD_TPU_AUTOPILOT", "off")
    registry.default_registry().clear()
    flight_recorder.recorder().clear()
    for mod in (remesh, timeseries, goodput, anomaly, watchdog, outage):
        mod.reset()
    yield
    hvd.shutdown()
    for mod in (remesh, goodput, watchdog, outage):
        mod.reset()
    elastic._current_generation = None


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _snap():
    return registry.default_registry().snapshot()


def test_in_place_remesh_rearms_watchdog_exporter_and_books_goodput(
        monkeypatch):
    base, held = reserve_ports(1)
    monkeypatch.setenv("HVD_TPU_METRICS_PORT", str(base))
    monkeypatch.setenv("HVD_TPU_WATCHDOG_SECONDS", "60")
    monkeypatch.setenv("HVD_TPU_GOODPUT_WINDOW", "100")
    try:
        hvd.init()
        assert watchdog.ensure_watchdog() is not None
        timer = StepTimer(unit="tokens")
        timer.start_step()
        timer.end_step(units=8)
        code, doc = _get(base, "/healthz")
        assert code == 200 and doc["watchdog"]["armed"] and doc["size"] == 1

        seen = {}
        real_init = basics.init

        def observed_init():
            # the old world is gone: its exporter and watchdog are down
            with pytest.raises(urllib.error.URLError):
                urllib.request.urlopen(f"http://127.0.0.1:{base}/healthz",
                                       timeout=2)
            seen["armed_between_worlds"] = watchdog.liveness()["armed"]
            time.sleep(0.2)      # a re-mesh takes time between the steps
            real_init()

        monkeypatch.setattr(hvd, "init", observed_init)
        ep = remesh.begin("hosts_updated", old_size=1)
        elastic._current_generation = 0
        hold = reserve_port()
        update = {"generation": 1, "size": 1, "coord_addr": "127.0.0.1",
                  "coord_port": hold.getsockname()[1],
                  "slots": {"0": {"HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
                                  "HOROVOD_LOCAL_RANK": "0",
                                  "HOROVOD_LOCAL_SIZE": "1",
                                  "HOROVOD_CROSS_RANK": "0",
                                  "HOROVOD_CROSS_SIZE": "1",
                                  "HOROVOD_HOSTNAME": "localhost"}}}
        elastic._apply_world_update(update)
        hold.close()
        assert seen == {"armed_between_worlds": False}
        assert os.environ["HVD_ELASTIC_GENERATION"] == "1"
        assert os.environ["HVD_TPU_RENDEZVOUS_PORT"] == \
            str(update["coord_port"])
        # the new world's exporter answers, with the watchdog re-armed
        code, doc = _get(base, "/healthz")
        assert code == 200 and doc["status"] == "ok"
        assert doc["watchdog"]["armed"] and watchdog.liveness()["armed"]
        assert {"drain", "rendezvous", "rebuild"} <= set(ep.phases)

        remesh.mark_recovered(new_size=1, generation=1)
        timer.start_step()
        timer.end_step(units=8)       # closes the episode: first_step
        assert ep.finished and "first_step" in ep.phases
        snap = _snap()
        assert snap["hvd_remesh_total"]["value"] == 1
        for ph in ("drain", "rendezvous", "rebuild", "first_step"):
            assert snap[f'hvd_remesh_seconds{{phase="{ph}"}}']["count"] == 1
        closed = goodput.flush()
        assert closed is not None
        assert closed["seconds"]["remesh_recovery"] > 0.15, closed
        assert closed["closed"], closed
    finally:
        for s in held:
            s.close()


def test_step_timer_closes_a_recovered_episode():
    """``StepTimer.end_step`` is the seam of
    ``horovod_tpu/train/callbacks.py:163-164``: the first step after
    ``mark_recovered`` books ``first_step`` and the episode's counter."""
    timer = StepTimer(unit="tokens")
    ep = remesh.begin("internal_error", old_size=2)
    timer.start_step()
    timer.end_step(units=1)          # not recovered yet: stays open
    assert not ep.finished
    remesh.mark_recovered(new_size=2, generation=4)
    timer.start_step()
    timer.end_step(units=1)
    assert ep.finished and remesh.current() is None
    assert set(ep.phases) == {"first_step"} and ep.generation == 4
    assert _snap()["hvd_remesh_total"]["value"] == 1


def test_completed_episode_charges_goodput_remesh_recovery(monkeypatch):
    """A completed episode's total goes to ``goodput.note_remesh``
    (``horovod_tpu/elastic/remesh.py:128``); an abandoned one does not."""
    monkeypatch.setenv("HVD_TPU_GOODPUT_WINDOW", "100")
    seen = []
    monkeypatch.setattr(goodput, "note_remesh", seen.append)
    remesh.begin("internal_error", old_size=2)
    remesh.begin("internal_error", old_size=2)      # the first abandoned
    time.sleep(0.05)
    remesh.mark_recovered(new_size=2)
    remesh.note_step_end()
    assert len(seen) == 1 and seen[0] >= 0.05


def test_first_init_books_no_phase():
    assert remesh.current() is None
    hvd.init()
    assert remesh.current() is None
    assert not any(k.startswith("hvd_remesh") for k in _snap())


def _drive_episode(mod):
    mod.reset()
    ep = mod.begin("internal_error", old_size=3)
    with mod.phase("drain"):
        pass
    ep.add_phase("failure_detect", 0.5)
    mod.mark_recovered(new_size=3, generation=2)
    mod.note_step_end(7)
    out = (ep.finished, sorted(ep.phases), ep.new_size, ep.generation,
           mod.current())
    # an abandoned episode, then a same-world retry
    a = mod.begin("internal_error", old_size=2)
    b = mod.begin("hosts_updated", old_size=2)
    mod.note_same_world_retry()
    return out + (a.finished, b.finished, mod.current(), mod.PHASES)


def test_episode_bookkeeping_matches_the_jax_package():
    assert _drive_episode(remesh) == _drive_episode(jx_remesh)
    jx_remesh.reset()


def test_outage_window_marks_the_listener_stale(monkeypatch):
    monkeypatch.setenv("HVD_TPU_DRIVER_OUTAGE_GRACE_S", "0.1")
    assert not outage.active()
    outage.note_failure()
    assert outage.active()
    time.sleep(0.15)
    assert outage.exceeded()
    notification._registered_as = ("0", "0")
    outage.note_success()
    assert not outage.active() and notification._registered_as is None
    kinds = [e["kind"] for e in flight_recorder.recorder().events()]
    assert "driver_outage" in kinds and "driver_recovered" in kinds
