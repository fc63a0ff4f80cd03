"""Process execution with group cleanup and output pumping.

Reference: ``horovod/runner/common/util/safe_shell_exec.py`` — spawn in a new
process group, pump stdout/stderr with threads, kill the whole group on
termination so stray grandchildren don't leak.

A copy of ``horovod_tpu/runner/safe_exec.py``.
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
