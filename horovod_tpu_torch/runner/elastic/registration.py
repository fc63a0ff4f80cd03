"""Worker state registry: counts per-slot READY/SUCCESS/FAILURE outcomes and
decides when to resume (reference: ``horovod/runner/elastic/registration.py``
``WorkerStateRegistry:28-150``).

A copy of ``horovod_tpu/runner/elastic/registration.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"
# exited nonzero because the driver tore the generation down (collateral of
# another worker's failure or a host change) — not the worker's own fault,
# so it must not count toward host blacklisting
TERMINATED = "TERMINATED"
# exited because a preemption/maintenance drain PLANNED it out of the world
# (docs/ELASTIC.md "Proactive drain & preemption") — an orderly, announced
# departure: never a FAILURE, never charged to host_crashes, never
# blocklisted, and the host is re-admitted after its drain cooldown
DRAINED = "DRAINED"


class WorkerStateRegistry:
    def __init__(self, reset_limit: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._states: Dict[int, str] = {}
        self._hosts: Dict[int, str] = {}
        self._reset_count = 0
        self._reset_limit = reset_limit

    def reset(self, size: int) -> None:
        with self._lock:
            self._states = {}
            self._hosts = {}
            self._reset_count += 1

    @property
    def reset_count(self) -> int:
        return self._reset_count

    def note_reset(self) -> None:
        """Count an IN-PLACE recovery against the same ``--reset-limit``
        budget as generation restarts: a deterministically-crashing
        worker must not respawn forever."""
        with self._lock:
            self._reset_count += 1

    def reset_limit_reached(self) -> bool:
        return (self._reset_limit is not None
                and self._reset_count > self._reset_limit)

    def restore_reset_count(self, count: int) -> None:
        """Adopt a journaled reset count (driver takeover): the
        ``--reset-limit`` budget is the JOB's, not the driver process's
        — a crash-looping worker must not get a fresh allowance every
        time the control plane restarts."""
        with self._lock:
            self._reset_count = max(self._reset_count, int(count))

    def record(self, rank: int, host: str, state: str) -> None:
        with self._lock:
            self._states[rank] = state
            self._hosts[rank] = host

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == state)

    def state_of(self, rank: int) -> Optional[str]:
        with self._lock:
            return self._states.get(rank)

    def failed_hosts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for rank, s in self._states.items():
                if s == FAILURE:
                    h = self._hosts.get(rank, "")
                    out[h] = out.get(h, 0) + 1
            return out
