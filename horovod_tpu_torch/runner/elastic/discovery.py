"""Elastic host discovery.

Reference: ``horovod/runner/elastic/discovery.py`` — ``HostDiscoveryScript``
(user script printing ``host:slots`` lines), ``FixedHosts``, and
``HostManager`` tracking diffs + blacklist. The script prints the hosts a
job may use (e.g. from a cluster scheduler).

A copy of ``horovod_tpu/runner/elastic/discovery.py``.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.runner.hosts import HostInfo


def blocklist_cooldown_s() -> float:
    """``HVD_TPU_BLOCKLIST_COOLDOWN_S``: how long a blocklisted host
    stays excluded before it is retried (maintenance ends, the host
    comes back — a permanent blocklist turns every transient host event
    into permanently lost capacity).  0 = never re-admit (the
    pre-cooldown behavior)."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.0, env_float("BLOCKLIST_COOLDOWN_S", 600.0))


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs the user script; stdout lines ``hostname:slots`` (reference:
    ``HostDiscoveryScript.find_available_hosts_and_slots``). Lines
    without an explicit ``:slots`` get ``default_slots`` (the launcher's
    ``--slots-per-host``)."""

    def __init__(self, script_path: str, default_slots: int = 1) -> None:
        self._script = script_path
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.run([self._script], capture_output=True,
                             timeout=60, check=True, shell=False)
        hosts: Dict[str, int] = {}
        for line in out.stdout.decode().splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                hosts[host] = int(slots)
            else:
                hosts[line] = self._default_slots
        return hosts


class FixedHosts(HostDiscovery):
    def __init__(self, hosts: List[HostInfo]) -> None:
        self._hosts = {h.hostname: h.slots for h in hosts}

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class HostManager:
    """Tracks current/blacklisted/draining hosts and computes ordered
    assignments with rank stability (reference: ``HostManager`` + the
    driver's stable-rank assignment, ``elastic/driver.py:233-275``).

    Two time-bounded exclusion mechanisms ride the discovery refresh:

    * **blocklist cooldown** — a blocklisted host is re-admitted (and
      retried) once ``HVD_TPU_BLOCKLIST_COOLDOWN_S`` has passed; a host
      that was merely under maintenance is capacity again, and a host
      that is genuinely bad earns its way straight back onto the list.
    * **drain reservations** — a preemption drain reserves N slots on
      the doomed host for a cooldown window, so replacement placement
      cannot land workers back on a host that announced its own death;
      expiry re-admits the capacity (→ the growth path re-spawns).
    """

    def __init__(self, discovery: HostDiscovery) -> None:
        self._discovery = discovery
        self._lock = threading.Lock()
        self._current: Dict[str, int] = {}
        self._blacklist: Dict[str, float] = {}   # host -> listed-at
        self._block_evidence: Dict[str, dict] = {}  # host -> why
        self._drained: Dict[str, tuple] = {}     # host -> (slots, expiry)
        self._order: List[str] = []   # stable ordering of known hosts

    def blacklist(self, host: str, evidence: Optional[dict] = None) -> None:
        """``evidence`` is the decision record — what convinced the
        driver this host is bad (failure counts, quarantine finding...).
        It rides into the control-plane journal so a takeover driver can
        show WHY a host is excluded, not just that it is."""
        with self._lock:
            self._blacklist[host] = time.monotonic()
            if evidence is not None:
                self._block_evidence[host] = dict(evidence)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return host in self._blacklist

    def drain(self, host: str, slots: int, cooldown_s: float) -> None:
        """Reserve ``slots`` on ``host`` for ``cooldown_s`` (stacking
        onto any live reservation, capped later against the host's real
        capacity) and apply it to the CURRENT view immediately — the
        drain re-mesh places replacements in the same loop iteration,
        before the discovery thread's next refresh."""
        with self._lock:
            prev_slots, prev_expiry = self._drained.get(host, (0, 0.0))
            now = time.monotonic()
            live = prev_slots if prev_expiry > now else 0
            self._drained[host] = (live + max(0, slots),
                                   now + max(0.0, cooldown_s))
            if host in self._current:
                self._current[host] = max(
                    0, self._current[host] - max(0, slots))

    def undrain(self, host: str, slots: int) -> None:
        """Release ``slots`` of a drain reservation (the driver found no
        viable planned world and is falling back to reactive recovery —
        the doomed host must stay usable until it actually dies)."""
        with self._lock:
            prev_slots, expiry = self._drained.get(host, (0, 0.0))
            left = max(0, prev_slots - max(0, slots))
            if left:
                self._drained[host] = (left, expiry)
            else:
                self._drained.pop(host, None)
            if host in self._current:
                self._current[host] += max(0, slots)

    def _usable(self, found: Dict[str, int]) -> Dict[str, int]:
        """Apply blocklist (with cooldown re-admission) and unexpired
        drain reservations to a discovery result.  Caller holds _lock."""
        now = time.monotonic()
        cooldown = blocklist_cooldown_s()
        for host in [h for h, at in self._blacklist.items()
                     if cooldown > 0 and now - at >= cooldown]:
            del self._blacklist[host]
            self._block_evidence.pop(host, None)
            try:
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().info(
                    "blocklist cooldown expired: re-admitting host %s",
                    host)
            except Exception:
                pass
        for host in [h for h, (_s, exp) in self._drained.items()
                     if exp <= now]:
            del self._drained[host]
        usable = {}
        for h, s in found.items():
            if h in self._blacklist:
                continue
            drained_slots = self._drained.get(h, (0, 0.0))[0]
            usable[h] = max(0, s - drained_slots)
        return usable

    def update_available_hosts(self) -> bool:
        """Refresh; True if the usable host set changed (reference:
        discovery thread, ``driver.py:181-201``)."""
        found = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            usable = self._usable(found)
            changed = usable != self._current
            self._current = usable
            # stable order: keep existing positions, append new hosts
            self._order = [h for h in self._order if h in usable] + \
                [h for h in usable if h not in self._order]
            return changed

    def current_hosts(self) -> List[HostInfo]:
        with self._lock:
            return [HostInfo(h, self._current[h]) for h in self._order
                    if self._current[h] > 0]

    def slot_count(self) -> int:
        with self._lock:
            return sum(self._current.values())

    # -- takeover persistence -------------------------------------------------
    def dump_state(self) -> Dict[str, dict]:
        """Exclusion state as WALL-clock-stamped plain data for the
        control-plane journal.  Monotonic stamps are process-local and
        meaningless to a takeover driver, so each entry converts to the
        wall clock at dump time; :meth:`restore_state` re-ages them back
        to this semantics in the new process.  Format:
        ``{"blocklist": {host: {"ts": wall, "evidence": {...}}},
        "drains": {host: {"slots": n, "remaining_s": secs, "ts": wall}}}``
        """
        now_mono = time.monotonic()
        now_wall = time.time()
        with self._lock:
            return {
                "blocklist": {
                    h: {"ts": now_wall - (now_mono - at),
                        "evidence": self._block_evidence.get(h)}
                    for h, at in self._blacklist.items()},
                "drains": {
                    h: {"slots": slots,
                        "remaining_s": max(0.0, exp - now_mono),
                        "ts": now_wall}
                    for h, (slots, exp) in self._drained.items()},
            }

    def restore_state(self, blocklist: Dict[str, dict],
                      drains: Dict[str, dict]) -> None:
        """Re-adopt journaled exclusion state (takeover).  Wall stamps
        re-age onto this process's monotonic clock: a host blocklisted
        9 minutes before the old driver died, restored 30s later under a
        10-minute cooldown, is re-admitted in ~2.5 minutes — NOT given a
        fresh 10 minutes (the cooldown promise is to the host, not the
        process).  Drain reservations restore only their remaining
        window, aged by the wall time since the dump."""
        now_mono = time.monotonic()
        now_wall = time.time()
        with self._lock:
            for host, rec in blocklist.items():
                elapsed = max(0.0, now_wall - float(rec.get("ts",
                                                            now_wall)))
                self._blacklist[host] = now_mono - elapsed
                ev = rec.get("evidence")
                if ev is not None:
                    self._block_evidence[host] = dict(ev)
            for host, rec in drains.items():
                elapsed = max(0.0, now_wall - float(rec.get("ts",
                                                            now_wall)))
                remaining = float(rec.get("remaining_s", 0.0)) - elapsed
                if remaining <= 0:
                    continue  # the reservation expired during the outage
                slots = int(rec.get("slots", 0))
                prev_slots, prev_exp = self._drained.get(host, (0, 0.0))
                live = prev_slots if prev_exp > now_mono else 0
                self._drained[host] = (max(live, slots),
                                       now_mono + remaining)

    def block_evidence(self, host: str) -> Optional[dict]:
        with self._lock:
            ev = self._block_evidence.get(host)
            return dict(ev) if ev is not None else None
