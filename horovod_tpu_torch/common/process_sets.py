"""Process sets: named sub-groups of ranks with their own collectives.

Mirrors ``horovod_tpu/common/process_sets.py`` (reference:
``horovod/common/process_set.h:26-168``, the Python API
``horovod/common/process_sets.py:18-160``, registration at run time
``horovod/common/operations.cc:1194-1260``): ``ProcessSet``,
``global_process_set`` (id 0), the set table, ``add_process_set``,
``remove_process_set``, ``process_set_ids`` and ``get_process_set_by_id``.

A registered set owns the eager backend over its ranks (a core domain, or
a ``torch.distributed`` group under the dist plane) and the torch group
the training API's ``process_set=`` arguments take (:attr:`ProcessSet.group`).
Every process of the world registers every set, in one order: the torch
group is made by all of them (``dist.new_group``), as the core's domain is.
A set's ``ranks`` are ranks of the global set.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist


class ProcessSet:
    """A set of ranks and the ``torch.distributed`` group over them.
    ``ranks=None`` is every rank of the global set."""

    def __init__(self, ranks: Optional[Sequence[int]] = None,
                 group=None) -> None:
        self.process_set_id: Optional[int] = None
        self.ranks: Optional[List[int]] = (sorted(set(ranks))
                                           if ranks is not None else None)
        self._group = group
        self._world_ranks: Optional[List[int]] = None

    @property
    def group(self):
        """The torch process group: the world's for the global set, the
        registered group for a set made by ``add_process_set``."""
        if self._group is not None:
            return self._group
        if self is global_process_set:
            return dist.group.WORLD
        raise NotImplementedError(
            "this process set has no torch group: register it with "
            "add_process_set(ranks) (every rank, in one order), or pass "
            "ProcessSet(ranks, group=torch.distributed.new_group(ranks))")

    def included(self) -> bool:
        from horovod_tpu_torch.common.basics import rank
        return self.ranks is None or rank() in self.ranks

    def rank(self) -> int:
        """Rank of this process within the set (-1 if excluded)."""
        from horovod_tpu_torch.common.basics import rank as global_rank
        if self.ranks is None:
            return global_rank()
        try:
            return self.ranks.index(global_rank())
        except ValueError:
            return -1

    def size(self) -> int:
        from horovod_tpu_torch.common.basics import size as global_size
        return global_size() if self.ranks is None else len(self.ranks)

    def global_rank(self, set_rank: int) -> int:
        """The ``torch.distributed`` world rank of the set's member
        ``set_rank``."""
        if self._world_ranks is not None:
            return self._world_ranks[set_rank]
        return set_rank if self.ranks is None else self.ranks[set_rank]

    def __eq__(self, other) -> bool:
        return (isinstance(other, ProcessSet)
                and self.process_set_id == other.process_set_id
                and self.ranks == other.ranks)

    def __hash__(self) -> int:
        return hash((self.process_set_id, tuple(self.ranks or ())))

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


#: Every rank of the global set (id 0, the reference's slot 0); ``init``
#: fills in its ranks.
global_process_set = ProcessSet()
global_process_set.process_set_id = 0


class _ProcessSetTable:
    """Registry (reference: ``ProcessSetTable``, ``process_set.h:86-168``).
    The global set's backend is the state's, started at first use (see
    :func:`horovod_tpu_torch.common.basics.eager_backend`)."""

    def __init__(self, state) -> None:
        self._state = state
        self._lock = threading.Lock()
        self._next_id = 1
        self._sets: Dict[int, ProcessSet] = {0: global_process_set}
        self._backends: Dict[int, object] = {}

    def register(self, ps: ProcessSet) -> int:
        from horovod_tpu_torch.common.basics import eager_backend
        parent = eager_backend()      # outside the lock: may rendezvous
        with self._lock:
            if ps.ranks is None:
                ps.ranks = list(range(self._state.size))
            for existing in self._sets.values():
                e_ranks = existing.ranks if existing.ranks is not None \
                    else list(range(self._state.size))
                if e_ranks == ps.ranks:
                    ps.process_set_id = existing.process_set_id
                    ps._group = existing.group
                    ps._world_ranks = existing._world_ranks
                    return ps.process_set_id
            if any(not 0 <= r < self._state.size for r in ps.ranks):
                raise ValueError(f"process-set ranks {ps.ranks} out of range "
                                 f"for a global set of {self._state.size}")
            be = parent.make_subset(ps.ranks)
            world = [global_process_set.global_rank(r) for r in ps.ranks]
            from horovod_tpu_torch.ops.dist_backend import DistBackend
            if isinstance(be, DistBackend):     # made its group already
                ps._group = be.group
            else:   # a non-member gets torch's non-member marker
                ps._group = dist.new_group(world)
            ps._world_ranks = world
            psid = self._next_id
            self._next_id += 1
            ps.process_set_id = psid
            self._sets[psid] = ps
            self._backends[psid] = be
            return psid

    def remove(self, ps: ProcessSet) -> None:
        with self._lock:
            if ps.process_set_id in (None, 0):
                raise ValueError(
                    "Cannot remove an unregistered or the global process set.")
            be = self._backends.pop(ps.process_set_id, None)
            self._sets.pop(ps.process_set_id, None)
            if be is not None:
                be.shutdown()
            ps.process_set_id = None

    def backend_for(self, ps: ProcessSet):
        from horovod_tpu_torch.common.basics import eager_backend
        if ps.process_set_id == 0:
            return eager_backend()
        with self._lock:
            if ps.process_set_id is None or ps.process_set_id not in self._sets:
                raise ValueError(f"Unknown process set: {ps!r}")
            return self._backends[ps.process_set_id]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._sets)

    def get(self, psid: int) -> ProcessSet:
        with self._lock:
            return self._sets[psid]

    def shutdown(self) -> None:
        """Drop every registered set (their backends end with the global
        one's)."""
        with self._lock:
            for ps in self._sets.values():
                if ps is not global_process_set:
                    ps.process_set_id = None
            self._sets = {0: global_process_set}
            self._backends.clear()


def _table() -> _ProcessSetTable:
    from horovod_tpu_torch.common.basics import _require_init
    return _require_init().process_set_table


def add_process_set(process_set) -> ProcessSet:
    """Register a new process set (reference: ``add_process_set``,
    ``process_sets.py:100-130`` → ``horovod_add_process_set``,
    ``operations.cc:1194-1229``). Every rank calls it, in one order."""
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    _table().register(process_set)
    return process_set


def remove_process_set(process_set: ProcessSet) -> None:
    """Reference: ``remove_process_set`` (``process_sets.py:133-152``)."""
    _table().remove(process_set)


def process_set_ids() -> List[int]:
    return _table().ids()


def get_process_set_by_id(psid: int) -> ProcessSet:
    return _table().get(psid)
