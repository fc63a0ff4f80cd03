"""Process execution with group cleanup and output pumping.

Reference: ``horovod/runner/common/util/safe_shell_exec.py`` — spawn in a new
process group, pump stdout/stderr with threads, kill the whole group on
termination so stray grandchildren don't leak.

A copy of ``horovod_tpu/runner/safe_exec.py``, plus the identity check
(:func:`process_start_time`, :func:`kill_group_of`) that a kill of a pid
read from a record makes first: the JAX package kills such pids unchecked.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

GRACEFUL_TERMINATION_TIME_S = 5


def _pump(stream, out, prefix: str = "", timestamp: bool = False) -> None:
    for line in iter(stream.readline, b""):
        try:
            text = line.decode(errors="replace")
            stamp = ""
            if timestamp:
                # reference: --prefix-output-with-timestamp
                # (safe_shell_exec prepend_context)
                stamp = time.strftime("%Y-%m-%d %H:%M:%S") + " "
            out.write(stamp + prefix + text)
            out.flush()
        except ValueError:
            break
    stream.close()


def safe_execute(command: List[str], env: Optional[Dict[str, str]] = None,
                 stdout=None, stderr=None, prefix: str = "",
                 events: Optional[List[threading.Event]] = None,
                 timestamp: bool = False,
                 on_start=None) -> int:
    """Run command; if any event fires, terminate the process group
    (reference: ``safe_shell_exec.execute``).  ``on_start(pid)`` is
    called right after the spawn — the elastic driver journals worker
    PIDs through it, so a takeover driver can adopt (monitor, and if
    need be kill) workers that outlived the process that spawned them.
    Note the spawn uses ``preexec_fn=os.setsid``: each worker leads its
    OWN process group, which is exactly why it survives its driver."""
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    proc = subprocess.Popen(
        command, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        preexec_fn=os.setsid)
    if on_start is not None:
        try:
            on_start(proc.pid)
        except Exception:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("safe_execute: on_start callback failed",
                                 exc_info=True)
    pumps = [
        threading.Thread(target=_pump,
                         args=(proc.stdout, stdout, prefix, timestamp),
                         daemon=True),
        threading.Thread(target=_pump,
                         args=(proc.stderr, stderr, prefix, timestamp),
                         daemon=True),
    ]
    for t in pumps:
        t.start()

    stop = threading.Event()

    def watch_events() -> None:
        while not stop.is_set():
            for ev in events or []:
                if ev.is_set():
                    terminate_process_group(proc)
                    return
            time.sleep(0.1)

    watcher = None
    if events:
        watcher = threading.Thread(target=watch_events, daemon=True)
        watcher.start()

    rc = proc.wait()
    stop.set()
    for t in pumps:
        t.join(timeout=2)
    if watcher:
        watcher.join(timeout=1)
    return rc


def process_start_time(pid: int) -> Optional[int]:
    """When ``pid`` started, in clock ticks since boot (field 22 of
    ``/proc/<pid>/stat``), or None when no such process runs (a zombie
    has ended). A pid the kernel hands out again comes with another start
    time, so the pair names one process."""
    try:
        with open(f"/proc/{int(pid)}/stat", "rb") as f:
            stat = f.read()
    except (OSError, ValueError):
        return None
    # field 2, the command, is in parentheses and may hold spaces;
    # the fields after it start at field 3 (the state)
    fields = stat[stat.rindex(b")") + 2:].split()
    if fields[0] in (b"Z", b"X"):
        return None
    return int(fields[19])


def is_same_process(pid: int, start: Optional[int]) -> bool:
    """Whether ``pid`` still names the process that started at ``start``
    (:func:`process_start_time`, taken when it was spawned or adopted).
    Confirm this before signalling a pid this process does not hold as a
    ``Popen``: the pid of a process that ended may name another one."""
    return start is not None and process_start_time(pid) == start


def kill_group_of(pid: int, start: Optional[int], sig: int) -> bool:
    """Signal the process group of ``pid`` if ``pid`` is still the
    process that started at ``start``; returns whether it was sent."""
    if not is_same_process(pid, start):
        return False
    try:
        os.killpg(os.getpgid(pid), sig)
    except (ProcessLookupError, PermissionError):
        return False
    return True


def terminate_process_group(proc: subprocess.Popen) -> None:
    """SIGTERM the group, escalate to SIGKILL (reference:
    ``safe_shell_exec`` graceful termination)."""
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.time() + GRACEFUL_TERMINATION_TIME_S
    while time.time() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass
