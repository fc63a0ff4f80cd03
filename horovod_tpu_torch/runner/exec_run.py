"""Static job execution: one worker process per slot, local or over ssh.

Mirrors ``horovod_tpu/runner/exec_run.py`` (reference:
``horovod/runner/gloo_run.py``: slot env injection :65-76, threaded
ssh/local execs :114-186, 226-271). Rank 0's ``torch.distributed`` TCP
store is the rendezvous, so the launcher only picks a port and points
every worker at rank 0's host.

Two differences from the JAX module:

* **The rendezvous port is held, never handed over.** The JAX
  ``free_port`` binds port 0, closes the socket and hands the number on,
  so another process can take the port before rank 0 binds it (ROADMAP
  queue 3). :func:`reserve_port` keeps a socket bound to the port with
  ``SO_REUSEADDR`` and not listening: rank 0's store (``SO_REUSEADDR``
  too) can still bind and listen on it, while the kernel gives it to no
  other ``bind(0)``. The launcher holds it until its world ends.
* **The exit code is the first failure's.** The JAX ``launch_static``
  returns the first non-zero code in rank order, so a rank that the
  launcher terminated because another rank failed can hand back its
  -15 (241 from ``hvdrun``) instead of the failing rank's code (ROADMAP
  queue 3 item 20). Here the code of the rank that failed first, by
  time, is returned: a rank the launcher terminates fails only after
  that first failure has been recorded.

A multi-host launch first resolves a rendezvous address every host can
reach (:func:`probe_coordinator_address`): a task service
(:mod:`horovod_tpu_torch.runner.task_server`) on every distinct host,
started locally or over ``ssh``, probes the others' interfaces. The probe
is best-effort: a failed probe falls back to rank 0's hostname.
"""

from __future__ import annotations

import os
import shlex
import socket
import sys
import threading
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.runner.hosts import (HostInfo, SlotInfo,
                                            get_host_assignments)
from horovod_tpu_torch.runner.safe_exec import safe_execute

SSH_COMMAND_PREFIX = ["ssh", "-o", "StrictHostKeyChecking=no",
                      "-o", "BatchMode=yes"]

_LOCAL_NAMES = {"localhost", "127.0.0.1", socket.gethostname()}


def reserve_port() -> socket.socket:
    """A free port, held (see the module docstring): the caller reads
    ``getsockname()[1]`` and closes the socket once the world that
    rendezvouses on the port has ended."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("0.0.0.0", 0))
    return s


def _is_local(host: str) -> bool:
    return host in _LOCAL_NAMES


def build_worker_env(slot: SlotInfo, coord_addr: str, coord_port: int,
                     base_env: Optional[Dict[str, str]] = None
                     ) -> Dict[str, str]:
    env = dict(base_env if base_env is not None else os.environ)
    env.update(slot.to_env())
    env["HVD_TPU_COORD_ADDR"] = coord_addr
    env["HVD_TPU_COORD_PORT"] = str(coord_port)
    # reference also exports HOROVOD_GLOO_RENDEZVOUS_* (gloo_run.py:187-198);
    # the port's init reads HVD_TPU_RENDEZVOUS_* first, so those are set
    # too: a value inherited from the launcher's own environment must not
    # point the worker at another world
    env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] = coord_addr
    env["HOROVOD_GLOO_RENDEZVOUS_PORT"] = str(coord_port)
    env["HVD_TPU_RENDEZVOUS_ADDR"] = coord_addr
    env["HVD_TPU_RENDEZVOUS_PORT"] = str(coord_port)
    return env


def slot_command(slot: SlotInfo, command: List[str], coord_addr: str,
                 coord_port: int, env: Optional[Dict[str, str]] = None,
                 extra_env: Optional[Dict[str, str]] = None
                 ) -> Tuple[List[str], Dict[str, str]]:
    """Build the (argv, env) to execute for one slot: direct exec locally,
    ssh with a fully shell-quoted remote line otherwise (reference:
    ``get_remote_command``, ``gloo_run.py:114-132``)."""
    wenv = build_worker_env(slot, coord_addr, coord_port, env)
    if extra_env:
        wenv.update(extra_env)
    if _is_local(slot.hostname):
        return command, wenv
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in wenv.items()
        if k.startswith(("HOROVOD_", "HVD_TPU_", "HVD_ELASTIC_", "PATH",
                         "PYTHONPATH")))
    remote = (f"cd {shlex.quote(os.getcwd())} && env {exports} "
              + " ".join(shlex.quote(c) for c in command))
    return SSH_COMMAND_PREFIX + [slot.hostname, remote], dict(os.environ)


def probe_coordinator_address(hostnames: List[str],
                              restrict: Optional[List[str]] = None,
                              verbose: bool = False) -> Optional[str]:
    """Multi-NIC bootstrap (reference: ``get_common_interfaces``,
    ``driver/driver_service.py:49-235``): start a task service on every
    distinct host, ring-probe candidate interfaces, return a rendezvous
    address every worker can reach. None = all-local, no probing needed."""
    import secrets as _secrets
    import subprocess

    distinct: List[str] = []
    for h in hostnames:
        if h not in distinct:
            distinct.append(h)
    if all(_is_local(h) for h in distinct):
        return None

    from horovod_tpu_torch.runner.service import (
        TaskClient, TaskService, find_routable_interfaces,
        pick_rendezvous_address)
    secret = _secrets.token_bytes(16)
    services: List[TaskService] = []
    procs: List[subprocess.Popen] = []
    clients_by_idx: Dict[int, TaskClient] = {}
    try:
        # spawn everything first (concurrent ssh session setup), collect
        # ports in parallel with a read deadline — a wedged remote must
        # not hang the launch (probing is best-effort bootstrap)
        pending: List[Tuple[int, str, subprocess.Popen]] = []
        for i, host in enumerate(distinct):
            if _is_local(host):
                svc = TaskService(i, secret).start()
                services.append(svc)
                clients_by_idx[i] = TaskClient("127.0.0.1", svc.port,
                                               secret)
                continue
            remote = (f"{shlex.quote(sys.executable)} -m "
                      f"horovod_tpu_torch.runner.task_server --index {i}")
            proc = subprocess.Popen(
                SSH_COMMAND_PREFIX + ["-o", "ConnectTimeout=15", host,
                                      remote],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            # the secret travels over the ssh channel (stdin), never on a
            # command line where the remote process table would expose it
            proc.stdin.write(secret.hex() + "\n")
            proc.stdin.flush()
            procs.append(proc)
            pending.append((i, host, proc))

        def read_port(i: int, host: str, proc: subprocess.Popen) -> None:
            line = proc.stdout.readline()
            if line.startswith("HVD_TASK_PORT="):
                clients_by_idx[i] = TaskClient(
                    host, int(line.strip().split("=", 1)[1]), secret)

        readers = [threading.Thread(target=read_port, args=p, daemon=True)
                   for p in pending]
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=30)
        missing = [h for i, h, _ in pending if i not in clients_by_idx]
        if missing:
            raise RuntimeError(
                f"task services failed to start on: {missing}")
        clients = [clients_by_idx[i] for i in range(len(distinct))]
        routable = find_routable_interfaces(clients, restrict=restrict)
        addr = pick_rendezvous_address(routable)
        if verbose:
            print(f"[hvdrun] NIC probe: rendezvous via {addr} "
                  f"(routable: {routable})", flush=True)
        return addr
    finally:
        for c in clients_by_idx.values():
            c.shutdown()
        for svc in services:
            svc.stop()
        for proc in procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.terminate()


def launch_static(hosts: List[HostInfo], np: int, command: List[str],
                  env: Optional[Dict[str, str]] = None,
                  coord_addr: Optional[str] = None,
                  coord_port: Optional[int] = None,
                  nics: Optional[List[str]] = None,
                  nic_probe: bool = True,
                  verbose: bool = False,
                  output_dir: Optional[str] = None,
                  timestamp_output: bool = False) -> int:
    """Run ``command`` on every slot; return the exit code of the rank
    that failed first (or 0).

    Reference: ``launch_gloo`` (``gloo_run.py:226``): assignment → env →
    per-slot exec threads; any failure terminates the rest. Multi-host
    launches first resolve a mutually-routable rendezvous address through
    the task-service NIC probe (``probe_coordinator_address``), unless
    ``nic_probe`` is false; ``nics`` restricts it to those interfaces.
    """
    slots = get_host_assignments(hosts, np)
    if coord_addr is None and nic_probe and \
            not all(_is_local(s.hostname) for s in slots):
        try:
            coord_addr = probe_coordinator_address(
                [s.hostname for s in slots], restrict=nics,
                verbose=verbose)
        except Exception as e:  # probing is best-effort bootstrap
            print(f"[hvdrun] NIC probe failed ({e}); falling back to "
                  f"hostname resolution", file=sys.stderr, flush=True)
    coord_addr = coord_addr or (
        "127.0.0.1" if _is_local(slots[0].hostname) else slots[0].hostname)
    held = None
    if coord_port is None:
        held = reserve_port()
        coord_port = held.getsockname()[1]

    failure = threading.Event()
    first: List[int] = []    # the first failure's code, by time
    lock = threading.Lock()

    def run_slot(slot: SlotInfo) -> None:
        rc = 1  # anything that dies before safe_execute is a failure
        out_f = err_f = None
        try:
            cmd, run_env = slot_command(slot, command, coord_addr,
                                        coord_port, env)
            prefix = f"[{slot.rank}]<stdout/err> " if verbose else ""
            if output_dir:
                # reference --output-filename layout: <dir>/rank.N/
                # {stdout,stderr} per worker
                d = os.path.join(output_dir, f"rank.{slot.rank}")
                os.makedirs(d, exist_ok=True)
                out_f = open(os.path.join(d, "stdout"), "w", buffering=1)
                err_f = open(os.path.join(d, "stderr"), "w", buffering=1)
            rc = safe_execute(cmd, env=run_env, prefix=prefix,
                              stdout=out_f, stderr=err_f,
                              events=[failure],
                              timestamp=timestamp_output)
        except Exception as e:
            print(f"[hvdrun] rank {slot.rank} failed to launch: {e}",
                  file=sys.stderr, flush=True)
        finally:
            for f in (out_f, err_f):
                if f:
                    f.close()
            if rc != 0:
                # recorded before the event is set: a rank terminated
                # because of this failure can only fail after it
                with lock:
                    if not first:
                        first.append(rc)
                failure.set()

    threads = [threading.Thread(target=run_slot, args=(s,), daemon=True)
               for s in slots]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        if held is not None:
            held.close()
    return first[0] if first else 0
