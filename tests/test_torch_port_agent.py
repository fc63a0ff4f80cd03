"""The port's agent transport (``horovod_tpu_torch.runner.elastic.agent``
and ``agent_worker``, the payload serializer ``common.payload``): the cases
of ``tests/test_agent_transport.py`` on the port, a signed command doc that
``make_agent_exec`` posts and ``agent_loop`` runs (either package's exec
against the port's agent), a forged doc ignored, and ``run_agent_elastic``
end to end over local agent processes: a world that allreduces, and the
flagship trainer (tiny, on the CPU) whose agent dies with its worker, the
world shrinking to two and growing back to three."""

import json
import os
import pickle
import socket
import sys
import threading
import time

import pytest

from horovod_tpu.runner.elastic import agent as jx_agent
from horovod_tpu_torch.common import payload
from horovod_tpu_torch.runner.elastic import agent
from horovod_tpu_torch.runner.elastic.agent import (AgentRegistryDiscovery,
                                                    make_agent_exec)
from horovod_tpu_torch.runner.http_kv import KVStoreServer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_elastic_worker as worker  # noqa: E402


class FakeKV:
    def __init__(self):
        self._d = {}

    def put(self, scope, key, value):
        self._d.setdefault(scope, {})[key] = value

    def get(self, scope, key):
        return self._d.get(scope, {}).get(key)

    def scope(self, scope):
        return dict(self._d.get(scope, {}))


class Slot:
    def __init__(self, hostname="h1", local_rank=0, rank=0):
        self.hostname = hostname
        self.local_rank = local_rank
        self.rank = rank


def _register(kv, agent_id, host, ts=None):
    kv.put("agents", agent_id, json.dumps(
        {"host": host, "ts": ts if ts is not None else time.time()}
    ).encode())


def test_exec_fails_fast_when_no_agent_for_slot():
    kv = FakeKV()
    _exec = make_agent_exec(kv, AgentRegistryDiscovery(kv), b"s" * 16)
    assert _exec(Slot(), ["cmd"], {}, []) == 1
    _register(kv, "h1@0", "h1")
    assert _exec(Slot(local_rank=1), ["cmd"], {}, []) == 1


def test_exec_gives_up_and_retires_cmd_when_agent_dies():
    """A dead agent never posts rc: once its heartbeat goes stale the
    exec returns failure AND blanks the command doc, so a respawned
    same-id agent cannot execute the dead generation's command."""
    kv = FakeKV()
    _exec = make_agent_exec(kv, AgentRegistryDiscovery(kv), b"s" * 16)
    _register(kv, "h1@0", "h1")
    rc = [None]
    t = threading.Thread(target=lambda: rc.__setitem__(0, _exec(
        Slot(), ["worker"], {"HOROVOD_RANK": "0"}, [])), daemon=True)
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    assert kv.get("cmd", "h1@0")
    _register(kv, "h1@0", "h1", ts=time.time() - 1e6)
    t.join(timeout=10)
    assert not t.is_alive() and rc[0] == 1
    assert kv.get("cmd", "h1@0") == b""


def test_exec_kill_deadline_bounds_teardown_wait(monkeypatch):
    """After a teardown kill, an agent that never acks is abandoned at
    the kill deadline (3 x STALE_S, shortened here) instead of blocking
    the generation restart."""
    monkeypatch.setattr(agent, "STALE_S", 1.0)
    kv = FakeKV()
    _exec = make_agent_exec(kv, AgentRegistryDiscovery(kv), b"s" * 16)
    _register(kv, "h1@0", "h1")
    stopper = threading.Event()

    def keepalive():
        while not stopper.is_set():
            _register(kv, "h1@0", "h1")
            time.sleep(0.2)

    threading.Thread(target=keepalive, daemon=True).start()
    ev = threading.Event()
    ev.set()
    try:
        start = time.time()
        rc = _exec(Slot(), ["worker"], {}, [ev])
        took = time.time() - start
    finally:
        stopper.set()
    assert rc == 1
    assert kv.scope("kill")
    assert 2.5 < took < 10


def _cmd_env(kv, agent_id):
    doc = kv.get("cmd", agent_id)
    return json.loads(doc.rpartition(b"|")[0])["env"] if doc else None


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_grown_slot_runs_on_an_idle_agent(pkg):
    """Agents h1@0, h1@1 and h1@3 run ranks 0-2; h1@2 registers late and
    growth adds rank 3 (local rank 3). Sorted, h1@3 is the fourth agent,
    but it still runs rank 2 and takes one command at a time: the port's
    exec sends rank 3 to the idle h1@2. The JAX package's overwrites
    h1@3's command (ROADMAP queue 3 item 28), and rank 3 never starts."""
    mod = agent if pkg == "port" else jx_agent
    kv = FakeKV()
    _exec = mod.make_agent_exec(kv, mod.AgentRegistryDiscovery(kv),
                                b"s" * 16)
    for a in ("h1@0", "h1@1", "h1@3"):
        _register(kv, a, "h1")

    def launch(rank):
        t = threading.Thread(target=_exec, daemon=True, args=(
            Slot(local_rank=rank, rank=rank), ["worker"],
            {"HOROVOD_RANK": str(rank)}, []))
        t.start()
        time.sleep(0.3)
        return t

    threads = [launch(r) for r in range(3)]
    assert [_cmd_env(kv, a)["HOROVOD_RANK"]
            for a in ("h1@0", "h1@1", "h1@3")] == ["0", "1", "2"]
    _register(kv, "h1@2", "h1")
    threads.append(launch(3))
    if pkg == "port":
        assert _cmd_env(kv, "h1@2")["HOROVOD_RANK"] == "3"
        assert _cmd_env(kv, "h1@3")["HOROVOD_RANK"] == "2"
    else:
        assert _cmd_env(kv, "h1@2") is None
        assert _cmd_env(kv, "h1@3")["HOROVOD_RANK"] == "3"
    for a in ("h1@0", "h1@1", "h1@2", "h1@3"):
        _register(kv, a, "h1", ts=time.time() - 1e6)   # let them go
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_resolve_kv_addr_loopback():
    for mod in (agent, jx_agent):
        assert mod.resolve_kv_addr(socket.gethostname()) == "127.0.0.1"
        assert mod.resolve_kv_addr("elsewhere.example") == "elsewhere.example"
    assert (agent.HEARTBEAT_S, agent.STALE_S, agent._ENV_SHIP_PREFIXES) == \
        (jx_agent.HEARTBEAT_S, jx_agent.STALE_S, jx_agent._ENV_SHIP_PREFIXES)


@pytest.fixture
def agent_kv():
    """A KV server with one port agent looping in a thread."""
    kv = KVStoreServer()
    kv.start()
    secret = b"k" * 16
    th = threading.Thread(target=agent.agent_loop, args=(
        0, "127.0.0.1", kv.port, secret.hex(), "ab" * 16, "agent-host"),
        daemon=True)
    th.start()
    deadline = time.time() + 10
    while not kv.scope("agents"):
        assert time.time() < deadline, "the agent never registered"
        time.sleep(0.05)
    try:
        yield kv, secret
    finally:
        kv.put("ctl", "shutdown", b"1")
        th.join(10)
        kv.stop()


@pytest.mark.parametrize("exec_pkg", ["port", "jax"])
def test_signed_command_runs_and_reports_its_exit_code(agent_kv, exec_pkg,
                                                       tmp_path):
    """``make_agent_exec`` posts a signed command doc for the slot's agent;
    the agent runs it with the shipped env (and the world secret from its
    own arguments, never the KV) and reports its exit code."""
    kv, secret = agent_kv
    mod = {"port": agent, "jax": jx_agent}[exec_pkg]
    assert list(kv.scope("agents")) == ["agent-host@0"]
    _exec = mod.make_agent_exec(kv, mod.AgentRegistryDiscovery(kv), secret)
    out = tmp_path / "seen.json"
    code = ("import json, os, sys\n"
            f"json.dump({{k: os.environ.get(k) for k in ('HOROVOD_RANK', "
            f"'HVD_ELASTIC_SECRET', 'SECRET_OF_THE_DRIVER')}}, "
            f"open({str(out)!r}, 'w'))\n"
            "sys.exit(5)\n")
    rc = _exec(Slot("agent-host"), [sys.executable, "-c", code],
               {"HOROVOD_RANK": "0", "SECRET_OF_THE_DRIVER": "x"}, [])
    assert rc == 5
    assert json.loads(out.read_text()) == {
        "HOROVOD_RANK": "0", "HVD_ELASTIC_SECRET": "ab" * 16,
        "SECRET_OF_THE_DRIVER": None}
    assert kv.get("cmd", "agent-host@0") == b""      # retired


def test_forged_command_doc_is_ignored(agent_kv, tmp_path):
    kv, _ = agent_kv
    marker = tmp_path / "ran"
    body = json.dumps({"uuid": "forged", "cmd": [
        sys.executable, "-c", f"open({str(marker)!r}, 'w')"], "env": {}
    }).encode()
    kv.put("cmd", "agent-host@0",
           body + b"|" + agent._sign(b"wrong-secret....", body).encode())
    time.sleep(1.5)
    assert not marker.exists() and kv.get("rc", "forged") is None


def _allreduce_payload(scale):
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    hvd.init()
    t = torch.ones(4) * (hvd.rank() + 1) * scale
    dist.all_reduce(t)
    out = {"rank": hvd.rank(), "size": hvd.size(), "sum": t.tolist()}
    hvd.shutdown()
    return out


def test_run_agent_elastic_end_to_end(tmp_path):
    """The payload travels through the KV to two local agents, the driver
    routes one worker to each, and the per-rank results come back."""
    results = agent.run_agent_elastic(
        lambda ctx: worker.start_local_agents(ctx, 2),
        _allreduce_payload, args=(2.0,), num_proc=2,
        env={"HOROVOD_TPU_OPERATIONS": "GLOO", "OMP_NUM_THREADS": "1"})
    assert results == [{"rank": r, "size": 2, "sum": [6.0] * 4}
                       for r in range(2)]


def test_payload_without_cloudpickle(monkeypatch):
    """``pickle`` carries a module-level function; a closure raises at
    ``dumps`` with the reason, never dropped."""
    monkeypatch.setattr(payload, "by_value_pickler", lambda: pickle)
    fn, args, kw = payload.loads(payload.dumps(
        (worker.agent_payload, ("--out", "x"), {})))
    assert fn is worker.agent_payload and args == ("--out", "x")
    scale = 3.0
    with pytest.raises(pickle.PicklingError, match="cloudpickle"):
        payload.dumps(lambda: scale)


def test_agent_loss_shrinks_and_respawn_grows(tmp_path, monkeypatch):
    """The chip's ``[agent_elastic]`` at a tiny size on the CPU: three
    agents, the flagship trainer as the payload; after rank 2's commit of
    step 3 its agent and worker die together, the heartbeat expires
    (``STALE_S`` shortened), the world shrinks to two in place (the
    driver plans it on discovery's view at that moment, not its last
    poll's), the respawned agent registers and the world grows back to
    three. The final ranks' results agree."""
    monkeypatch.setattr(agent, "STALE_S", 3.0)
    out = str(tmp_path)

    def shrunk():
        return any(e["kind"] == "step" and e["size"] == 2
                   for e in worker.events(out)) \
            if os.path.exists(os.path.join(out, "events.jsonl")) else False

    stats = {}
    results = agent.run_agent_elastic(
        lambda ctx: worker.start_local_agents(
            ctx, 3, hold=lambda: not shrunk(), stats=stats),
        worker.agent_payload,
        args=(["--out", out, "--device", "cpu", "--tiny", "--steps", 6,
               "--rows", 2, "--kill-group", "2:3", "--until-size", 3,
               "--sleep", 0.25],),
        num_proc=3, min_np=2, max_np=3, reset_limit=3,
        env={"HOROVOD_TPU_OPERATIONS": "GLOO", "OMP_NUM_THREADS": "1",
             "HVD_ELASTIC_SHRINK_WAIT_S": "60"})
    evs = worker.events(out)
    kill = [e for e in evs if e["kind"] == "kill"]
    assert len(kill) == 1 and kill[0]["rank"] == 2 and kill[0]["group"]
    assert stats["stale_at"] > kill[0]["t"]
    assert stats["respawned_at"] >= stats["stale_at"]
    sizes = [e["size"] for e in evs if e["kind"] == "step"]
    assert 2 in sizes and sizes[-1] == 3
    # the survivors healed in place: their processes are the first ones
    boots = [e for e in evs if e["kind"] == "boot"]
    assert len(boots) == 4 and boots[-1]["rank"] == 2
    first = {b["pid"] for b in boots[:3]}
    assert [r["pid"] in first for r in results] == [True, True, False]
    assert [r["rank"] for r in results] == [0, 1, 2]
    assert all(r["size"] == 3 for r in results)
    assert len({r["digest"] for r in results}) == 1
