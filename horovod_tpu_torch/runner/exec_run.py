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
* **No multi-host NIC probe.** The JAX launcher resolves a rendezvous
  address every host can reach through its task services
  (``probe_coordinator_address``); those services are the agent
  transport, not ported yet (ROADMAP queue 1 item 7), so a multi-host
  launch rendezvouses at rank 0's hostname.
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


def launch_static(hosts: List[HostInfo], np: int, command: List[str],
                  env: Optional[Dict[str, str]] = None,
                  coord_addr: Optional[str] = None,
                  coord_port: Optional[int] = None,
                  verbose: bool = False,
                  output_dir: Optional[str] = None,
                  timestamp_output: bool = False) -> int:
    """Run ``command`` on every slot; return first nonzero exit code (or 0).

    Reference: ``launch_gloo`` (``gloo_run.py:226``): assignment → env →
    per-slot exec threads; any failure terminates the rest.
    """
    slots = get_host_assignments(hosts, np)
    coord_addr = coord_addr or (
        "127.0.0.1" if _is_local(slots[0].hostname) else slots[0].hostname)
    held = None
    if coord_port is None:
        held = reserve_port()
        coord_port = held.getsockname()[1]

    results: List[Optional[int]] = [None] * np
    failure = threading.Event()

    def run_slot(idx: int, slot: SlotInfo) -> None:
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
            results[idx] = rc
            if rc != 0:
                failure.set()

    threads = [threading.Thread(target=run_slot, args=(i, s), daemon=True)
               for i, s in enumerate(slots)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        if held is not None:
            held.close()
    for rc in results:
        if rc:
            return rc
    return 0
