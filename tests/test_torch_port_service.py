"""The port's task services and NIC probe (``horovod_tpu_torch.runner.
service``, ``task_server`` and ``exec_run.probe_coordinator_address``)
against the JAX package's: the JAX suite's cases (``tests/test_service.py``)
on the port, the wire both ways (a client of one package calls a service
of the other), and the same routability answers from both."""

import os
import socket
import subprocess
import sys
import urllib.error

import numpy as np
import pytest

from horovod_tpu.runner import service as jx
from horovod_tpu_torch.runner import exec_run, service as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECRET = b"0123456789abcdef"
TABLE_A = {"lo": "127.0.0.1", "deadnet": "203.0.113.7"}
TABLE_B = {"lo": "127.0.0.1"}


@pytest.fixture
def two_services():
    a = pt.TaskService(0, SECRET, addresses_override=dict(TABLE_A)).start()
    b = pt.TaskService(1, SECRET, addresses_override=dict(TABLE_B)).start()
    try:
        yield (a, pt.TaskClient("127.0.0.1", a.port, SECRET),
               b, pt.TaskClient("127.0.0.1", b.port, SECRET))
    finally:
        a.stop()
        b.stop()


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_local_addresses_match_the_jax_package():
    addrs = pt.get_local_addresses()
    assert "127.0.0.1" in addrs.values()
    assert addrs == jx.get_local_addresses()


def test_addresses_and_probe_rpc(two_services):
    a, ca, b, cb = two_services
    assert ca.addresses() == TABLE_A
    assert cb.probe("127.0.0.1", a.port)
    assert not cb.probe("127.0.0.1", _closed_port(), timeout=0.5)


def test_bad_secret_rejected(two_services):
    a, ca, _, _ = two_services
    evil = pt.TaskClient("127.0.0.1", a.port, b"wrong-secret-....")
    with pytest.raises(urllib.error.HTTPError) as e:
        evil.addresses()
    assert e.value.code == 403


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_wire_between_the_packages(server_pkg, client_pkg):
    """A client of one package calls every verb of the other's service:
    the verb, the JSON body and the signature header are one wire."""
    mods = {"port": pt, "jax": jx}
    svc = mods[server_pkg].TaskService(
        4, SECRET, addresses_override=dict(TABLE_A)).start()
    try:
        c = mods[client_pkg].TaskClient("127.0.0.1", svc.port, SECRET)
        assert c.addresses() == TABLE_A
        assert c.probe("127.0.0.1", svc.port) is True
        assert c.probe("127.0.0.1", _closed_port(), timeout=0.5) is False
        evil = mods[client_pkg].TaskClient("127.0.0.1", svc.port,
                                           b"x" * 16)
        with pytest.raises(urllib.error.HTTPError):
            evil.addresses()
        c.shutdown()
        svc._thread.join(timeout=10)
        assert not svc._thread.is_alive()
    finally:
        if svc._thread.is_alive():
            svc.stop()


def _fake_reach(reachable):
    return lambda self, addr, port, timeout=2.0: addr in reachable


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routability_matches_the_jax_package(monkeypatch, seed):
    """Both packages keep and drop the same interfaces, and pick the same
    address, on seeded NIC tables and seeded reachability (the probe is
    faked: a test host cannot produce real unreachability)."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 5))
    tables = []
    for i in range(n):
        tab = {"lo": "127.0.0.1"}
        for k in range(int(rng.randint(1, 4))):
            tab[f"eth{k}"] = f"10.{seed}.{i}.{k + 1}"
        tables.append(tab)
    every = sorted({ip for t in tables for ip in t.values()})
    reach = {ip for ip in every if ip.startswith("127.") or rng.rand() < 0.6}
    restrict = None if seed != 2 else ["lo", "eth0"]
    answers = []
    for mod in (jx, pt):
        svcs = [mod.TaskService(i, SECRET, addresses_override=t).start()
                for i, t in enumerate(tables)]
        try:
            monkeypatch.setattr(mod.TaskClient, "probe", _fake_reach(reach))
            clients = [mod.TaskClient("127.0.0.1", s.port, SECRET)
                       for s in svcs]
            routable = mod.find_routable_interfaces(clients,
                                                    restrict=restrict)
            answers.append((routable, mod.pick_rendezvous_address(routable)))
        finally:
            for s in svcs:
                s.stop()
    assert answers[0] == answers[1]
    # the unreachable addresses are gone from the port's answer
    assert all(ip in reach for _, t in answers[1][0] for ip in t.values())


def test_restrict_list(two_services, monkeypatch):
    a, ca, b, cb = two_services
    monkeypatch.setattr(pt.TaskClient, "probe", _fake_reach({"127.0.0.1"}))
    routable = pt.find_routable_interfaces([ca, cb], restrict=["lo"])
    assert routable[0][1] == {"lo": "127.0.0.1"}
    with pytest.raises(RuntimeError, match="no mutually-routable"):
        pt.find_routable_interfaces([ca, cb], restrict=["deadnet"])


@pytest.mark.parametrize("routable,want", [
    ([(0, {"lo": "127.0.0.1", "eth0": "10.0.0.5"})], "10.0.0.5"),
    ([(0, {"lo": "127.0.0.1"})], "127.0.0.1"),
    ([(0, {"eth1": "10.0.0.9", "eth0": "10.0.0.5"}),
      (1, {"eth0": "10.0.1.5"})], "10.0.0.5")])
def test_pick_rendezvous_prefers_non_loopback(routable, want):
    assert pt.pick_rendezvous_address(routable) == want \
        == jx.pick_rendezvous_address(routable)


def test_single_task_skips_peer_probe():
    svc = pt.TaskService(0, SECRET,
                         addresses_override={"eth0": "10.1.2.3"}).start()
    try:
        c = pt.TaskClient("127.0.0.1", svc.port, SECRET)
        assert pt.find_routable_interfaces([c]) == [(0, {"eth0": "10.1.2.3"})]
    finally:
        svc.stop()


def test_task_server_entry_point():
    """The ssh-launched module reads its secret from stdin, prints its
    port and serves until shutdown; a JAX client drives it."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("HVD_TPU_SERVICE_SECRET", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.task_server",
         "--index", "3", "--ttl", "30"],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        cwd=REPO)
    try:
        proc.stdin.write(SECRET.hex() + "\n")
        proc.stdin.flush()
        line = proc.stdout.readline()
        assert line.startswith("HVD_TASK_PORT=")
        port = int(line.strip().split("=")[1])
        c = jx.TaskClient("127.0.0.1", port, SECRET)
        assert c.addresses() == pt.get_local_addresses()
        c.shutdown()
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.terminate()


def test_probe_skips_all_local_launches():
    assert exec_run.probe_coordinator_address(
        ["localhost", "127.0.0.1", socket.gethostname()]) is None


def test_probe_resolves_a_remote_host(monkeypatch):
    """A launch with a host that is not this one starts a task service
    for it (over ``ssh``, faked here by a local task server whose stdin
    takes the secret) and returns the address the probe picked."""
    real_popen = subprocess.Popen
    seen = []

    def fake_ssh(argv, **kw):
        seen.append(argv)
        assert argv[:len(exec_run.SSH_COMMAND_PREFIX)] == \
            exec_run.SSH_COMMAND_PREFIX
        remote = argv[-1]
        assert "horovod_tpu_torch.runner.task_server" in remote
        return real_popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.task_server",
             "--index", remote.rsplit(" ", 1)[-1], "--ttl", "30"],
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, **kw)

    monkeypatch.setattr(subprocess, "Popen", fake_ssh)
    monkeypatch.setattr(exec_run, "_is_local", lambda h: h == "localhost")
    # the remote "host" is this one, reached over loopback
    monkeypatch.setattr(pt, "TaskClient", _LoopbackClient)
    addr = exec_run.probe_coordinator_address(["localhost", "remote-1"],
                                              restrict=["lo"])
    assert len(seen) == 1 and seen[0][-2] == "remote-1"
    assert addr == "127.0.0.1"


class _LoopbackClient(pt.TaskClient):
    def __init__(self, addr, port, secret):
        super().__init__("127.0.0.1", port, secret)


def test_launch_static_falls_back_when_the_probe_fails(monkeypatch, capsys):
    """The probe is best-effort: a failure prints the JAX package's line
    and the launch rendezvouses at rank 0's hostname; ``nics`` reaches
    the probe, ``nic_probe=False`` skips it."""
    from horovod_tpu_torch.runner.hosts import HostInfo
    calls = []

    def failing_probe(hostnames, restrict=None, verbose=False):
        calls.append((hostnames, restrict))
        raise RuntimeError("no route")

    monkeypatch.setattr(exec_run, "probe_coordinator_address", failing_probe)
    addrs = []

    def slot_command(slot, command, coord_addr, coord_port, env=None):
        addrs.append(coord_addr)
        return command, {}

    monkeypatch.setattr(exec_run, "slot_command", slot_command)
    monkeypatch.setattr(exec_run, "safe_execute", lambda cmd, **kw: 0)
    monkeypatch.setattr(exec_run, "_is_local", lambda h: False)
    hosts = [HostInfo("h0", 1), HostInfo("h1", 1)]
    assert exec_run.launch_static(hosts, 2, ["true"], nics=["eth0"]) == 0
    assert calls == [(["h0", "h1"], ["eth0"])]
    assert "[hvdrun] NIC probe failed (no route)" in capsys.readouterr().err
    assert addrs == ["h0", "h0"]
    calls.clear()
    assert exec_run.launch_static(hosts, 2, ["true"], nic_probe=False) == 0
    assert calls == []
