"""Host list parsing and slot assignment.

Reference: ``horovod/runner/common/util/hosts.py`` (``parse_hosts``,
``SlotInfo`` at :34, ``get_host_assignments`` at :100). In the port a
"slot" is one process driving one card, ``cuda:<local_rank>``.

A copy of ``horovod_tpu/runner/hosts.py``: parity to the byte.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @classmethod
    def from_string(cls, s: str) -> "HostInfo":
        if ":" in s:
            host, slots = s.rsplit(":", 1)
            return cls(host, int(slots))
        return cls(s, 1)


@dataclasses.dataclass
class SlotInfo:
    """Reference: ``SlotInfo`` (``hosts.py:34``)."""
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_env(self) -> Dict[str, str]:
        """Env injected per worker (reference: ``gloo_run.py:65-76``)."""
        return {
            "HOROVOD_HOSTNAME": self.hostname,
            "HOROVOD_RANK": str(self.rank),
            "HOROVOD_SIZE": str(self.size),
            "HOROVOD_LOCAL_RANK": str(self.local_rank),
            "HOROVOD_LOCAL_SIZE": str(self.local_size),
            "HOROVOD_CROSS_RANK": str(self.cross_rank),
            "HOROVOD_CROSS_SIZE": str(self.cross_size),
        }


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """``"h1:4,h2:4"`` → HostInfo list (reference: ``parse_hosts``)."""
    return [HostInfo.from_string(s) for s in hosts_string.split(",") if s]


def parse_hostfile(path: str) -> List[HostInfo]:
    """Hostfile lines ``hostname slots=N`` (reference: hostfile support in
    ``launch.py``)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p[len("slots="):])
            out.append(HostInfo(parts[0], slots))
    return out


def get_host_assignments(hosts: List[HostInfo], np: int,
                         min_np: int = None) -> List[SlotInfo]:
    """Assign np ranks over hosts in order (reference:
    ``get_host_assignments``, ``hosts.py:100``): ranks fill hosts
    sequentially; local/cross ranks derived."""
    total = sum(h.slots for h in hosts)
    if total < np:
        raise ValueError(
            f"Requested np={np} but hosts supply only {total} slots")
    slots: List[SlotInfo] = []
    rank = 0
    cross_size: Dict[int, int] = {}
    for cross_idx, h in enumerate(hosts):
        for local in range(h.slots):
            if rank >= np:
                break
            slots.append(SlotInfo(h.hostname, rank, local, 0, np, 0, 0))
            cross_size[local] = cross_size.get(local, 0) + 1
            rank += 1
    # fill local_size / cross ranks. cross_rank is this host's ordinal among
    # the hosts that HAVE this local_rank (reference semantics: the "cross"
    # communicator groups same-local_rank processes across hosts), so with
    # ragged slot counts cross_rank stays < cross_size.
    per_host: Dict[str, int] = {}
    for s in slots:
        per_host[s.hostname] = per_host.get(s.hostname, 0) + 1
    host_order: List[str] = []
    for s in slots:
        if s.hostname not in host_order:
            host_order.append(s.hostname)
    hosts_with_local: Dict[int, List[str]] = {}
    for s in slots:
        hosts_with_local.setdefault(s.local_rank, [])
        if s.hostname not in hosts_with_local[s.local_rank]:
            hosts_with_local[s.local_rank].append(s.hostname)
    for s in slots:
        s.local_size = per_host[s.hostname]
        s.cross_rank = hosts_with_local[s.local_rank].index(s.hostname)
        s.cross_size = cross_size.get(s.local_rank, 0)
    return slots
