"""Process sets: the ranks a collective runs over, with their torch group.

Mirrors ``ProcessSet`` and ``global_process_set`` of
``horovod_tpu/common/process_sets.py`` (reference:
``horovod/common/process_sets.py:18-70``), enough for the ``process_set=``
arguments of the training API. Registering further sets at run time
(``add_process_set`` and the set table) arrives with the eager-collectives
slice of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch.distributed as dist


class ProcessSet:
    """A set of ranks and the ``torch.distributed`` group over them.
    ``ranks=None`` is every rank of the world."""

    def __init__(self, ranks: Optional[Sequence[int]] = None,
                 group=None) -> None:
        self.ranks: Optional[List[int]] = (sorted(set(ranks))
                                           if ranks is not None else None)
        self._group = group

    @property
    def group(self):
        """The torch process group: the world's for the global set."""
        if self._group is not None:
            return self._group
        if self is global_process_set:
            return dist.group.WORLD
        raise NotImplementedError(
            "a process set other than the global one needs its torch group "
            "(ProcessSet(ranks, group=torch.distributed.new_group(ranks))); "
            "registering sets arrives with the eager-collectives slice")

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
        """The world rank of the set's member ``set_rank``."""
        return set_rank if self.ranks is None else self.ranks[set_rank]

    def __repr__(self) -> str:
        return f"ProcessSet(ranks={self.ranks})"


#: Every rank of the world; ``init`` fills in its ranks.
global_process_set = ProcessSet()
