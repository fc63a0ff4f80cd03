"""Pod host enumeration (``horovod_tpu_torch.runner.gpu_discovery``) and
``hvdrun --tpu`` against the JAX package's ``tpu_discovery``: one fake GCE
metadata server answers both packages, and the cases of
``tests/test_tpu_discovery.py`` run on the port. The port's host slots
come from the card count, the process count or an explicit ``slots``; the
JAX package's are one a host."""

import http.server
import threading

import pytest
import torch

from horovod_tpu.runner import launch as jx_launch
from horovod_tpu.runner import tpu_discovery as jx
from horovod_tpu.runner.elastic.discovery import HostManager as JxHostManager
from horovod_tpu_torch.runner import gpu_discovery as pt
from horovod_tpu_torch.runner import launch as pt_launch
from horovod_tpu_torch.runner.elastic.discovery import HostManager

WORKERS4 = ("9f3a:w-0:10.164.0.10,9f3a:w-1:10.164.0.11,"
            "9f3a:w-2:10.164.0.12,9f3a:w-3:10.164.0.13")
IPS4 = ["10.164.0.10", "10.164.0.11", "10.164.0.12", "10.164.0.13"]


class _FakeMetadata:
    """Serves instance attributes from a mutable dict under
    ``/computeMetadata/v1/instance/attributes/``, enforcing the
    ``Metadata-Flavor`` header as the real server does."""

    def __init__(self):
        self.attrs = {"worker-network-endpoints": WORKERS4,
                      "agent-worker-number": "2",
                      "accelerator-type": "a3-highgpu-8g"}
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                base = "/computeMetadata/v1/instance/attributes/"
                val = outer.attrs.get(self.path[len(base):]) \
                    if self.path.startswith(base) else None
                if self.headers.get("Metadata-Flavor") != "Google":
                    self.send_error(403)
                    return
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


@pytest.fixture()
def metadata(monkeypatch):
    fake = _FakeMetadata()
    monkeypatch.setenv("HVD_TPU_METADATA_ENDPOINT", fake.endpoint)
    yield fake
    fake.close()


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def _names(hosts):
    return [(h.hostname, h.slots) for h in hosts]


def test_pod_hosts_match_the_jax_package(metadata, monkeypatch):
    assert [h.hostname for h in pt.pod_hosts(slots=1)] == IPS4
    assert _names(pt.pod_hosts(slots=1)) == _names(jx.tpu_pod_hosts())
    _cards(monkeypatch, 8)       # a host's slots: this host's cards
    assert _names(pt.pod_hosts()) == [(h, 8) for h in IPS4]
    assert _names(pt.pod_hosts(num_proc=6)) == [(h, 2) for h in IPS4]
    assert _names(pt.pod_hosts(slots=3)) == [(h, 3) for h in IPS4]


def test_pod_hosts_never_guess_slots_without_a_card(metadata, monkeypatch):
    _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.pod_hosts()


def test_worker_index_and_accelerator_type(metadata):
    assert pt.worker_index() == jx.tpu_worker_index() == 2
    assert pt.accelerator_type() == jx.tpu_accelerator_type() \
        == "a3-highgpu-8g"


def test_off_a_metadata_server_is_oserror(metadata):
    with pytest.raises(OSError):
        pt.metadata_get("no-such-attribute")
    metadata.attrs["worker-network-endpoints"] = " , "
    with pytest.raises(OSError, match="empty"):
        pt.pod_hosts(slots=1)
    dead = "http://127.0.0.1:1"
    for fn in (lambda: pt.pod_hosts(slots=1, endpoint=dead),
               lambda: pt.worker_index(endpoint=dead),
               lambda: pt.accelerator_type(endpoint=dead),
               lambda: pt.PodDiscovery(1, dead)
               .find_available_hosts_and_slots()):
        with pytest.raises(OSError):
            fn()


def test_cli_resolves_pod_hosts_without_dash_h(metadata):
    argv = ["--tpu", "-np", "4", "--", "echo", "hi"]
    got = [_names(m.resolve_hosts(m.parse_args(argv)))
           for m in (jx_launch, pt_launch)]
    assert got[0] == got[1] == [(h, 1) for h in IPS4]


@pytest.mark.parametrize("argv", [
    ["--tpu", "-H", "a:1", "--", "echo"],
    ["--tpu", "--hostfile", "hf", "--", "echo"],
    ["--tpu", "--host-discovery-script", "./d.sh", "--min-np", "2", "--",
     "echo"]])
def test_cli_tpu_excludes_explicit_hosts(argv):
    for m in (jx_launch, pt_launch):
        with pytest.raises(SystemExit):
            m.parse_args(list(argv))


@pytest.mark.parametrize("extra,cards,want_np,want_nics", [
    (["--slots", "1", "--no-nic-probe"], 0, 4, (None, False)),
    (["--nics", "eth0,eth1"], 2, 8, (["eth0", "eth1"], True)),
    (["-np", "6"], 0, 6, (None, True))])
def test_launch_static_receives_metadata_hosts(metadata, monkeypatch, extra,
                                               cards, want_np, want_nics):
    """``hvdrun --tpu`` end to end through run_commandline: the static
    launcher gets the four pod workers with their slots, ``-np`` defaults
    to the slot sum, and the NIC flags reach it."""
    _cards(monkeypatch, cards)
    captured = {}

    def fake_launch(hosts, np, command, **kw):
        captured.update(hosts=_names(hosts), np=np, command=command,
                        nics=(kw.get("nics"), kw.get("nic_probe")))
        return 0

    monkeypatch.setattr(pt_launch, "launch_static", fake_launch)
    assert pt_launch.run_commandline(["--tpu", *extra, "--", "echo",
                                      "hi"]) == 0
    assert [h for h, _ in captured["hosts"]] == IPS4
    assert captured["np"] == want_np
    assert sum(s for _, s in captured["hosts"]) >= want_np
    assert captured["command"] == ["echo", "hi"]
    assert captured["nics"] == want_nics


def test_elastic_cli_discovers_the_pod(metadata, monkeypatch):
    """With ``--min-np``, ``--tpu`` hands the elastic driver a
    PodDiscovery over the same server."""
    from horovod_tpu_torch.runner.elastic import driver
    captured = {}
    monkeypatch.setattr(driver, "run_elastic",
                        lambda discovery, np, command, **kw:
                        captured.update(d=discovery, np=np) or 0)
    assert pt_launch.run_commandline(
        ["--tpu", "--min-np", "2", "--slots", "1", "--no-driver-supervisor",
         "--", "echo"]) == 0
    assert isinstance(captured["d"], pt.PodDiscovery)
    assert captured["d"].find_available_hosts_and_slots() == \
        {h: 1 for h in IPS4}


def test_elastic_discovery_tracks_slice_changes(metadata):
    """PodDiscovery re-reads the pod each refresh, as TpuPodDiscovery
    does: a repaired worker VM appears without a discovery script, and a
    blocklisted host stays out."""
    three = "9f3a:w-0:10.164.0.10,9f3a:w-1:10.164.0.11,9f3a:w-2:10.164.0.12"
    mgrs = [JxHostManager(jx.TpuPodDiscovery()),
            HostManager(pt.PodDiscovery(slots=1))]
    seen = []
    for mgr in mgrs:
        metadata.attrs["worker-network-endpoints"] = three
        got = [mgr.update_available_hosts(), mgr.slot_count()]
        metadata.attrs["worker-network-endpoints"] = WORKERS4
        got += [mgr.update_available_hosts(), mgr.slot_count()]
        mgr.blacklist("10.164.0.12")
        got += [mgr.update_available_hosts(), mgr.slot_count(),
                [h.hostname for h in mgr.current_hosts()]]
        seen.append(got)
    assert seen[0] == seen[1]
    assert seen[1][:6] == [True, 3, True, 4, True, 3]
    assert "10.164.0.12" not in seen[1][6]
