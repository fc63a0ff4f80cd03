"""The port's preemption watcher and metadata client against the JAX
package's (``tests/test_chaos.py:636-775``, ``tests/test_tpu_discovery.py:
162-196``), on the CPU, with a local fake metadata server: the chaos
notice is a pure signal; a notice publishes ``drain/<rank>`` with the JAX
watcher's fields, once per process life, retried after a failed publish;
the metadata source reads ``instance/maintenance-event`` and latches off
only where it never succeeded; the opt-in SIGTERM hook publishes and the
process runs on. Then the planned drain end to end: three gloo ranks of
the tiny flagship under the port's driver, rank 2 noticed by chaos,
drained (recorded ``DRAINED``, counted under ``source="chaos"``), its
slot re-admitted after the cooldown."""

import http.server
import json
import os
import signal
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from horovod_tpu import chaos as j_chaos  # noqa: E402
from horovod_tpu.elastic import preemption as j_pre  # noqa: E402
from horovod_tpu.runner import http_kv as j_kv  # noqa: E402
from horovod_tpu.runner import tpu_discovery as j_disc  # noqa: E402

from horovod_tpu_torch import chaos as t_chaos  # noqa: E402
from horovod_tpu_torch.elastic import preemption as t_pre  # noqa: E402
from horovod_tpu_torch.runner import gpu_discovery as t_disc  # noqa: E402
from horovod_tpu_torch.runner import http_kv as t_kv  # noqa: E402

PKGS = {"jax": (j_chaos, j_pre, j_kv), "port": (t_chaos, t_pre, t_kv)}


class _FakeMetadata:
    """The GCE metadata surface on localhost: ``instance/<name>`` and
    ``instance/attributes/<name>`` from a dict, the Metadata-Flavor header
    enforced as the real server does."""

    def __init__(self):
        self.attrs = {"maintenance-event": "NONE", "id": "1234"}
        self.hits = 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                outer.hits += 1
                if self.headers.get("Metadata-Flavor") != "Google":
                    self.send_error(403)
                    return
                base = "/computeMetadata/v1/instance/"
                name = self.path[len(base):] \
                    if self.path.startswith(base) else None
                if name and name.startswith("attributes/"):
                    name = name[len("attributes/"):]
                val = outer.attrs.get(name)
                if val is None:
                    self.send_error(404)
                    return
                body = val.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.endpoint = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # no probe ever leaves the host: a dead local endpoint unless a
    # test points the client at its fake server
    monkeypatch.setenv("HVD_TPU_METADATA_ENDPOINT", "http://127.0.0.1:1")
    for name in ("HVD_TPU_FAULT_PLAN", "HVD_ELASTIC_KV",
                 "HVD_TPU_PREEMPTION_SIGTERM", "HVD_TPU_PREEMPTION_WATCH"):
        monkeypatch.delenv(name, raising=False)
    for c, p, _ in PKGS.values():
        c.uninstall()
        p.reset()
    yield
    for c, p, _ in PKGS.values():
        c.uninstall()
        p.reset()


@pytest.fixture()
def metadata(monkeypatch):
    fake = _FakeMetadata()
    monkeypatch.setenv("HVD_TPU_METADATA_ENDPOINT", fake.endpoint)
    yield fake
    fake.close()


def _arm(monkeypatch, plan, rank):
    monkeypatch.setenv("HVD_TPU_FAULT_PLAN", json.dumps(plan))
    for c, _p, _k in PKGS.values():
        c.install(rank=rank)


def test_preemption_notice_is_a_pure_signal(monkeypatch):
    _arm(monkeypatch, {"faults": [{"seam": "preemption", "kind": "notice",
                                   "rank": 2, "count": 1}]}, 2)
    for c, _p, _k in PKGS.values():
        assert c.fire("preemption") == [("preemption", "notice")]
        assert c.fire("preemption") == []
    _arm(monkeypatch, {"faults": [{"seam": "preemption", "kind": "notice",
                                   "rank": 2}]}, 0)
    for c, _p, _k in PKGS.values():
        assert c.fire("preemption") == []


def _notice_doc(pkg, monkeypatch):
    c, pre, kv = PKGS[pkg]
    root = kv.KVStoreServer()
    root.start()
    try:
        monkeypatch.setenv("HVD_ELASTIC_KV", f"127.0.0.1:{root.port}")
        monkeypatch.setenv("HOROVOD_RANK", "2")
        monkeypatch.setenv("HVD_ELASTIC_GENERATION", "4")
        w = pre.PreemptionWatcher()
        src = w.check_once()
        assert src == "chaos"
        assert w.notify(src) is True
        doc = json.loads(root.get("drain", "2"))
        assert w.draining is True and w.check_once() is None
        assert w.notify("chaos") is False   # one notice a process life
        return doc
    finally:
        root.stop()


def test_chaos_notice_publishes_the_jax_drain_doc(monkeypatch):
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.metrics.registry import default_registry
    key = 'hvd_drain_notices_total{source="chaos"}'
    before = default_registry().snapshot().get(key, {}).get("value", 0)
    docs = {}
    for pkg in PKGS:
        _arm(monkeypatch, {"faults": [{"seam": "preemption",
                                       "kind": "notice", "rank": 2}]}, 2)
        docs[pkg] = _notice_doc(pkg, monkeypatch)
    j, t = docs["jax"], docs["port"]
    assert set(t) == set(j)
    for k in ("rank", "host", "source", "scope", "generation"):
        assert t[k] == j[k], k
    assert t["rank"] == 2 and t["source"] == "chaos"
    assert t["scope"] == "worker" and t["generation"] == 4
    assert default_registry().snapshot()[key]["value"] == before + 1
    ev = [e for e in recorder().events() if e["kind"] == "preemption_notice"]
    assert ev and ev[-1]["source"] == "chaos" and ev[-1]["rank"] == "2"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_notice_without_a_driver_kv(monkeypatch, pkg):
    _c, pre, _kv = PKGS[pkg]
    w = pre.PreemptionWatcher()
    assert w.notify("sigterm") is False
    assert pre.ensure_watcher() is None


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_notify_retries_after_a_failed_publish(monkeypatch, pkg):
    _c, pre, kv = PKGS[pkg]
    monkeypatch.setenv("HOROVOD_RANK", "1")
    monkeypatch.setenv("HVD_ELASTIC_KV", "127.0.0.1:1")  # nothing listens
    w = pre.PreemptionWatcher()
    assert w.notify("chaos") is False
    assert w.draining is False and w.check_once() == "chaos"
    root = kv.KVStoreServer()
    root.start()
    try:
        monkeypatch.setenv("HVD_ELASTIC_KV", f"127.0.0.1:{root.port}")
        assert w.notify(w.check_once()) is True
        assert json.loads(root.get("drain", "1"))["source"] == "chaos"
        assert w.draining is True and w.check_once() is None
    finally:
        root.stop()


def test_maintenance_event_and_the_vm_probe(metadata):
    assert t_disc.maintenance_event() == t_disc.MAINTENANCE_NONE == \
        j_disc.tpu_maintenance_event()
    metadata.attrs["maintenance-event"] = "TERMINATE_ON_HOST_MAINTENANCE"
    assert t_disc.maintenance_event() == j_disc.tpu_maintenance_event() \
        == "TERMINATE_ON_HOST_MAINTENANCE"
    assert t_disc.running_on_cloud_vm() is True
    assert t_disc.metadata_get("id", base="/computeMetadata/v1/instance/") \
        == "1234"
    with pytest.raises(OSError):
        t_disc.metadata_get("no-such-attribute")
    del metadata.attrs["id"]
    assert t_disc.running_on_cloud_vm() is False


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_watcher_reads_the_metadata_notice(metadata, pkg):
    _c, pre, _kv = PKGS[pkg]
    w = pre.PreemptionWatcher()
    assert w.check_once() is None
    metadata.attrs["maintenance-event"] = "MIGRATE_ON_HOST_MAINTENANCE"
    assert w.check_once() == "metadata"


def test_metadata_notice_publishes_a_host_scoped_drain(metadata,
                                                       monkeypatch):
    root = t_kv.KVStoreServer()
    root.start()
    try:
        monkeypatch.setenv("HVD_ELASTIC_KV", f"127.0.0.1:{root.port}")
        monkeypatch.setenv("HOROVOD_RANK", "0")
        metadata.attrs["maintenance-event"] = "TERMINATE_ON_HOST_MAINTENANCE"
        w = t_pre.PreemptionWatcher()
        assert w.notify(w.check_once()) is True
        doc = json.loads(root.get("drain", "0"))
        assert doc["source"] == "metadata" and doc["scope"] == "host"
    finally:
        root.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_metadata_latch(monkeypatch, pkg):
    """Never succeeded: off after three failures. Succeeded once: a blip
    keeps polling."""
    _c, pre, _kv = PKGS[pkg]
    w = pre.PreemptionWatcher()
    for _ in range(3):
        assert w.check_once() is None
    assert w._metadata_dead is True
    w = pre.PreemptionWatcher()
    w._metadata_ok_once = True
    for _ in range(5):
        assert w._metadata_notice() is False
    assert w._metadata_dead is False


def test_no_metadata_server_named_means_no_probe(monkeypatch, metadata):
    """Unlike the JAX watcher, the port's polls a metadata server only
    where ``HVD_TPU_METADATA_ENDPOINT`` names one."""
    monkeypatch.delenv("HVD_TPU_METADATA_ENDPOINT")
    w = t_pre.PreemptionWatcher()
    assert not t_pre.metadata_enabled()
    assert w.check_once() is None and metadata.hits == 0
    monkeypatch.setenv("HVD_TPU_METADATA_ENDPOINT", metadata.endpoint)
    assert t_pre.metadata_enabled()
    metadata.attrs["maintenance-event"] = "TERMINATE_ON_HOST_MAINTENANCE"
    assert w.check_once() == "metadata" and metadata.hits == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ensure_watcher_singleton_and_knob(monkeypatch, pkg):
    _c, pre, _kv = PKGS[pkg]
    monkeypatch.setenv("HVD_ELASTIC_KV", "127.0.0.1:1")
    monkeypatch.setenv("HVD_TPU_PREEMPTION_WATCH", "0")
    assert pre.ensure_watcher() is None
    monkeypatch.setenv("HVD_TPU_PREEMPTION_WATCH", "1")
    w = pre.ensure_watcher()
    assert w is not None and pre.ensure_watcher() is w
    assert pre.current_watcher() is w and pre.draining() is False


def test_sigterm_hook_publishes_and_the_process_runs_on(monkeypatch):
    root = t_kv.KVStoreServer()
    root.start()
    prev = signal.getsignal(signal.SIGTERM)
    try:
        monkeypatch.setenv("HVD_ELASTIC_KV", f"127.0.0.1:{root.port}")
        monkeypatch.setenv("HOROVOD_RANK", "1")
        monkeypatch.setenv("HVD_TPU_PREEMPTION_SIGTERM", "1")
        monkeypatch.setenv("HVD_TPU_PREEMPTION_POLL_S", "30")
        assert t_pre.ensure_watcher() is not None
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while root.get("drain", "1") is None:
            assert time.monotonic() < deadline, "no notice published"
            time.sleep(0.02)
        doc = json.loads(root.get("drain", "1"))
        assert doc["source"] == "sigterm" and doc["scope"] == "worker"
    finally:
        root.stop()
        t_pre.reset()
        assert signal.getsignal(signal.SIGTERM) == prev


# -- the planned drain under the port's driver ---------------------------------

def test_planned_drain_under_the_port_driver(tmp_path, monkeypatch):
    """Three gloo ranks of the tiny flagship: a chaos ``preemption``
    notice on rank 2 (a ``{rank}`` marker: once) is published
    by rank 2's watcher, the driver plans the world around it (its exit
    ``DRAINED``, never ``FAILURE``; no host blocklisted), the survivors
    keep their PIDs and the reserved slot comes back after the cooldown,
    so the run ends at three ranks."""
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.runner.elastic import journal
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.hosts import HostInfo
    out = tmp_path / "drain"
    out.mkdir()
    plan = {"faults": [{"seam": "preemption", "kind": "notice", "rank": 2,
                        "marker": str(out / "noticed_{rank}")}]}
    # driver-side knobs are read in this process (the driver's)
    monkeypatch.setenv("HVD_TPU_DRAIN_COOLDOWN_S", "2")
    env = {"HVD_TPU_FAULT_PLAN": json.dumps(plan),
           "HVD_TPU_PREEMPTION_POLL_S": "0.1",
           "HVD_TPU_GLOO_TIMEOUT_SECONDS": "60"}
    cmd = worker.command(out, "--device", "cpu", "--tiny", "--steps", 14,
                         "--rows", 2, "--sleep", 0.25, "--until-size", 3)
    rc, driver, secs = worker.run_driver(
        FixedHosts([HostInfo("localhost", 3)]), cmd, str(out), min_np=2,
        max_np=3, env=env, timeout=100, reset_limit=3)
    evs = worker.events(str(out))
    assert rc == 0, evs
    jstate = journal.load(os.path.join(str(out), "journal",
                                       journal.JOURNAL_NAME))
    exits = {k: r["state"] for k, r in jstate.exits.items()}
    assert "DRAINED" in exits.values() and "FAILURE" not in \
        exits.values(), exits
    assert jstate.blocklist == {}
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = {e["rank"]: e for e in evs if e["kind"] == "done"}
    first = {b["rank"]: b["pid"] for b in boots[:3]}
    assert sorted(dones) == [0, 1, 2] and all(
        d["size"] == 3 for d in dones.values()), dones
    assert dones[0]["pid"] == first[0] and dones[1]["pid"] == first[1]
    assert dones[2]["pid"] != first[2]   # the re-admitted slot's process
    noticed = [e for e in evs if e["kind"] == "drain_notice"]
    assert len(noticed) == 1 and noticed[0]["rank"] == 2
    assert len({d["digest"] for d in dones.values()}) == 1
