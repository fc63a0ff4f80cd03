"""Agent-transport elastic execution, shared by the Spark and Ray
integrations.

A copy of ``horovod_tpu/runner/elastic/agent.py`` (reference: the
task-service exec model of ``horovod.spark.run_elastic``,
``spark/runner.py:309-430``, and ``horovod.ray.ElasticRayExecutor``,
``ray/elastic.py:149+``): the cluster framework owns process placement, so
the elastic driver cannot ssh; instead every framework task/actor runs a
HOST AGENT loop that registers a heartbeat in a driver-side KV, executes
HMAC-signed worker commands the ElasticDriver routes to it, and reports
exit codes. Agent loss → heartbeat expiry (``STALE_S``) → shrink; the
framework's retry respawns the agent → grow.

Trust model: command docs are integrity-protected (HMAC over a secret
shipped through the framework's own serialization channel, never the KV),
and secrets — including the elastic world-doc key — stay off the wire;
the KV itself, like the reference's rendezvous server, assumes the
cluster-private network. Do not expose the KV port outside it.

The payload and the results travel through
:mod:`horovod_tpu_torch.common.payload` (``cloudpickle`` where it
imports, else ``pickle``). ``agent_loop``'s ``host`` lets an agent
advertise the address its host is reached by (a NIC the task services'
probe picked) instead of its hostname: the driver rendezvouses each world
at rank 0's advertised host.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import subprocess
import sys
import threading
import time
import uuid as uuidlib
from typing import Any, Callable, Dict, List, Optional

HEARTBEAT_S = 1.0
STALE_S = 10.0

_ENV_SHIP_PREFIXES = ("HOROVOD_", "HVD_", "PATH", "PYTHONPATH")


def _sign(secret: bytes, body: bytes) -> str:
    return hmac.new(secret, body, hashlib.sha256).hexdigest()


def resolve_kv_addr(addr: str) -> str:
    """Same-box fast path: a process on the driver's own host talks to the
    KV over loopback (the advertised name may not resolve from inside
    containers, and loopback skips the NIC)."""
    import socket
    if socket.gethostname() == addr.split(".")[0]:
        return "127.0.0.1"
    return addr


# -- agent side (runs inside a Spark task / Ray actor) ----------------------

def agent_loop(ordinal: int, kv_addr: str, kv_port: int,
               secret_hex: str, world_secret_hex: str = "",
               host: Optional[str] = None) -> None:
    """Register as a host agent and execute signed worker commands until
    the driver posts shutdown (reference analog: the task service loop,
    ``runner/common/service/task_service.py``).

    The world-doc secret arrives through the framework's serialization
    channel (this function's arguments), NOT over the KV — the agent
    injects it into each worker's environment locally. ``host`` is the
    address this agent registers under (default: the hostname)."""
    import collections
    import socket
    from horovod_tpu_torch.runner.http_kv import kv_get, kv_put

    secret = bytes.fromhex(secret_hex)
    host = host or socket.gethostname()
    agent_id = f"{host}@{ordinal}"  # '@' is URL-path-safe; '#' would be
    # stripped as a URI fragment by the HTTP KV client
    seen = collections.OrderedDict()  # bounded processed-uuid memory
    proc: Optional[subprocess.Popen] = None
    cur_uuid: Optional[str] = None

    def beat() -> None:
        kv_put(kv_addr, kv_port, "agents", agent_id, json.dumps(
            {"host": host, "ts": time.time()}).encode())

    beat()
    last_beat = time.time()
    while True:
        now = time.time()
        if now - last_beat >= HEARTBEAT_S:
            beat()
            last_beat = now
        if kv_get(kv_addr, kv_port, "ctl", "shutdown") is not None:
            if proc is not None and proc.poll() is None:
                proc.terminate()
            return
        if proc is not None:
            if kv_get(kv_addr, kv_port, "kill", cur_uuid) is not None \
                    and proc.poll() is None:
                proc.terminate()
            rc = proc.poll()
            if rc is not None:
                kv_put(kv_addr, kv_port, "rc", cur_uuid,
                       str(rc).encode())
                proc, cur_uuid = None, None
        else:
            doc = kv_get(kv_addr, kv_port, "cmd", agent_id)
            if doc:
                body, _, sig = doc.rpartition(b"|")
                if sig and hmac.compare_digest(sig.decode(),
                                               _sign(secret, body)):
                    spec = json.loads(body)
                    if spec["uuid"] not in seen:
                        seen[spec["uuid"]] = True
                        while len(seen) > 64:
                            seen.popitem(last=False)
                        cur_uuid = spec["uuid"]
                        wenv = {**os.environ, **spec["env"]}
                        if world_secret_hex:
                            wenv["HVD_ELASTIC_SECRET"] = world_secret_hex
                        proc = subprocess.Popen(spec["cmd"], env=wenv)
        time.sleep(0.25)


# -- driver side ------------------------------------------------------------

class AgentRegistryDiscovery:
    """Host discovery over the agent registry: one slot per agent whose
    heartbeat is fresh (reference analog: the driver's view of registered
    task services)."""

    def __init__(self, kv) -> None:
        self._kv = kv

    def agents_on(self, host: str) -> List[str]:
        out = []
        for agent_id, blob in sorted(self._kv.scope("agents").items()):
            meta = json.loads(blob)
            if meta["host"] == host and \
                    time.time() - meta["ts"] < STALE_S:
                out.append(agent_id)
        return out

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        slots: Dict[str, int] = {}
        for agent_id, blob in self._kv.scope("agents").items():
            meta = json.loads(blob)
            if time.time() - meta["ts"] < STALE_S:
                slots[meta["host"]] = slots.get(meta["host"], 0) + 1
        return slots


def make_agent_exec(kv, discovery: AgentRegistryDiscovery, secret: bytes,
                    user_env_keys=()):
    """remote_exec for ElasticDriver: route (command, env) to the agent
    occupying this slot and wait for its exit code.

    Only launcher-owned env keys (and the caller's explicit ``env``
    overrides) travel in the command doc — the agent merges them over ITS
    task environment, so driver-side credentials never cross the network
    (the ssh launcher filters exports the same way, ``exec_run.py
    slot_command``).

    A slot runs on the host's agent at its ``local_rank`` in id order, or,
    when that agent still runs another slot's worker, on the first idle
    one: an agent that registers after the others can sort before them,
    and an agent runs one command at a time, so the worker of a slot that
    growth added would otherwise wait behind a running one (the JAX
    package's exec sends it there; its new world's rendezvous then times
    out)."""
    lock = threading.Lock()
    busy: set = set()   # agents running a command this exec posted

    def _claim(slot) -> Optional[str]:
        with lock:
            agents = discovery.agents_on(slot.hostname)
            if len(agents) <= slot.local_rank:
                # an agent's heartbeat went stale between assignment and
                # launch; failing the slot restarts the generation
                # cleanly rather than doubling two slots onto one agent
                return None
            idle = [a for a in agents if a not in busy]
            if not idle:
                return None
            agent_id = agents[slot.local_rank] \
                if agents[slot.local_rank] in idle else idle[0]
            busy.add(agent_id)
            return agent_id

    def _exec(slot, command: List[str], wenv: Dict[str, str],
              events) -> int:
        agent_id = _claim(slot)
        if agent_id is None:
            return 1
        try:
            return _run_on(agent_id, slot, command, wenv, events)
        finally:
            with lock:
                busy.discard(agent_id)

    def _run_on(agent_id: str, slot, command: List[str],
                wenv: Dict[str, str], events) -> int:
        uid = uuidlib.uuid4().hex
        ship = {k: v for k, v in wenv.items()
                if isinstance(v, str) and
                (k.startswith(_ENV_SHIP_PREFIXES) or k in user_env_keys)}
        body = json.dumps(
            {"uuid": uid, "cmd": list(command), "env": ship}).encode()
        kv.put("cmd", agent_id, body + b"|" + _sign(secret, body).encode())
        killed = False
        kill_deadline = None
        while True:
            rc = kv.get("rc", uid)
            if rc is not None:
                # retire the doc so the KV doesn't accumulate a full env
                # copy per launch over a long elastic job
                kv.put("cmd", agent_id, b"")
                return int(rc)
            if not killed and any(e.is_set() for e in events):
                kv.put("kill", uid, b"1")
                killed = True
                kill_deadline = time.time() + 3 * STALE_S
            # a dead agent never posts rc: give up once its heartbeat is
            # stale (task/actor loss) or a kill went unacknowledged
            if agent_id not in discovery.agents_on(slot.hostname) or \
                    (kill_deadline and time.time() > kill_deadline):
                # ALSO retire the doc: a framework-respawned agent with
                # the same id (fresh empty `seen`) must not exec this
                # dead generation's command
                kv.put("cmd", agent_id, b"")
                return 1
            time.sleep(0.1)

    return _exec


def run_agent_elastic(start_agents: Callable[[dict], Callable[[], None]],
                      fn: Callable, args: tuple = (),
                      kwargs: Optional[dict] = None,
                      num_proc: int = 1,
                      min_np: Optional[int] = None,
                      max_np: Optional[int] = None,
                      env: Optional[dict] = None,
                      reset_limit: Optional[int] = None,
                      verbose: int = 0) -> List[Any]:
    """Full agent-elastic orchestration: start the KV, ship the payload,
    let ``start_agents(ctx)`` spawn the framework-owned agents (it
    returns a cleanup callable invoked after shutdown is posted), run the
    ElasticDriver over the agent registry, and return the per-rank
    results of the generation that completed (with the ranks an in-place
    growth added, where they finished in it)."""
    import secrets as _secrets
    import socket as _socket

    from horovod_tpu_torch.common import payload
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.http_kv import KVStoreServer

    kwargs = kwargs or {}
    min_np = min_np or num_proc
    max_np = max_np or num_proc

    kv = KVStoreServer()
    kv.start()
    cleanup = None
    try:
        secret = _secrets.token_bytes(16)
        world_secret = _secrets.token_bytes(16)
        kv.put("payload", "fn", payload.dumps((fn, args, kwargs)))
        # advertise the hostname, not getfqdn(): agents on other hosts
        # resolve it via cluster DNS (the reference's task-address model)
        # and same-host agents shortcut to loopback; getfqdn() can be
        # 'localhost', which resolves to ::1 while the KV server is
        # IPv4-only
        kv_addr = _socket.gethostname()
        # ctx["kv"] is the IN-PROCESS server handle for driver-side
        # helpers (e.g. the Ray respawner); framework closures must
        # capture the scalar entries, never ctx itself
        ctx = {"kv_addr": kv_addr, "kv_port": kv.port, "kv": kv,
               "secret_hex": secret.hex(),
               "world_secret_hex": world_secret.hex(), "max_np": max_np}
        cleanup = start_agents(ctx)

        discovery = AgentRegistryDiscovery(kv)
        worker_env = dict(os.environ)
        worker_env.update(env or {})
        worker_env["HVD_AGENT_KV"] = f"{kv_addr}:{kv.port}"
        driver = ElasticDriver(
            discovery,
            [sys.executable, "-u", "-m",
             "horovod_tpu_torch.runner.elastic.agent_worker"],
            min_np=min_np, max_np=max_np, env=worker_env,
            reset_limit=reset_limit, verbose=bool(verbose),
            target_np=num_proc, world_secret=world_secret,
            remote_exec=make_agent_exec(kv, discovery, secret,
                                        user_env_keys=tuple(env or ())))
        rc = driver.run()
        if rc != 0:
            raise RuntimeError(
                f"elastic agent job failed (driver rc={rc})")
        # results are generation-scoped. Aborted generations are strictly
        # OLDER than the successful launch generation, while in-place
        # growth resyncs move a surviving worker's generation FORWARD
        # (elastic/__init__.py _apply_world_update) — so the completed
        # world's publishes are exactly those at gen >= final_generation;
        # per rank, the newest wins
        final_np = driver.final_np or 0
        final_gen = driver.final_generation or 0
        blobs: Dict[int, bytes] = {}
        best_gen: Dict[int, int] = {}
        for key, blob in kv.scope("result").items():
            g_str, _, r_str = key.partition(".")
            g, r = int(g_str), int(r_str)
            if g >= final_gen and g >= best_gen.get(r, final_gen):
                best_gen[r] = g
                blobs[r] = blob
        if any(r not in blobs for r in range(final_np)):
            raise RuntimeError(
                f"elastic agent job succeeded but results are missing: "
                f"have ranks {sorted(blobs)}, expected 0..{final_np - 1}")
        # the driver counts the ranks an in-place growth added as
        # non-essential (final_np); one that finished in the world the
        # essential ranks finished in completed that world too (the JAX
        # function drops its result)
        n = final_np
        last = max((best_gen[r] for r in range(final_np)), default=None)
        while n in blobs and best_gen[n] == last:
            n += 1
        return [payload.loads(blobs[r]) for r in range(n)]
    finally:
        kv.put("ctl", "shutdown", b"1")
        try:
            if cleanup is not None:
                cleanup()
        finally:
            kv.stop()
