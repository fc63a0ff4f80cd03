"""Mesh topology: the (num_hosts × local_size) structure of a mesh axis,
for the hierarchical allreduce.

Mirrors ``horovod_tpu/common/topology.py``: ``MeshTopology`` with its
``intra_groups``/``inter_groups`` (axis positions, the JAX package's
``axis_index_groups``), ``flat_topology``, ``virtual_hosts``
(``HVD_TPU_VIRTUAL_HOSTS``) and ``detect_topology``. The process groups
over those positions are made by :meth:`horovod_tpu_torch.parallel.mesh.
Mesh.split`. Where the JAX package reads each device's process index, a
process here is one rank, and its host is ``rank // local_size`` under the
launcher's host-major layout.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional


class MeshTopology(NamedTuple):
    """Two-level structure of a mesh axis: ``num_hosts`` groups of
    ``local_size`` ranks each, contiguous along the axis (axis position
    ``i`` lives on host ``i // local_size``)."""

    num_hosts: int
    local_size: int

    @property
    def world(self) -> int:
        return self.num_hosts * self.local_size

    @property
    def is_hierarchical(self) -> bool:
        """Both levels non-trivial: the only case where the two-hop
        decomposition beats a flat collective."""
        return self.num_hosts > 1 and self.local_size > 1

    def intra_groups(self) -> List[List[int]]:
        """Axis positions of the intra-host hops: one group per host, its
        ``local_size`` consecutive positions."""
        L = self.local_size
        return [[h * L + i for i in range(L)]
                for h in range(self.num_hosts)]

    def inter_groups(self) -> List[List[int]]:
        """Axis positions of the inter-host hop: one group per local slot,
        the same slot on every host. After the intra-host reduce_scatter,
        member ``l`` of every host holds shard ``l`` of its host's sum;
        reducing across the group completes that shard."""
        L = self.local_size
        return [[h * L + l for h in range(self.num_hosts)]
                for l in range(L)]


def flat_topology(n: int) -> MeshTopology:
    """The degenerate 1×n topology (no hierarchy)."""
    return MeshTopology(1, max(1, int(n)))


def virtual_hosts() -> int:
    """``HVD_TPU_VIRTUAL_HOSTS``: impose this many virtual hosts on the
    axis (0 = derive from the launch). Read live, so tests can sweep
    topologies."""
    from horovod_tpu_torch.common.config import env_int
    return env_int("VIRTUAL_HOSTS", 0)


def detect_topology(mesh=None, axis_name: str = "dp",
                    n: Optional[int] = None) -> MeshTopology:
    """The (num_hosts × local_size) structure of a mesh axis.

    Precedence: ``HVD_TPU_VIRTUAL_HOSTS`` (when it divides the axis) >
    the launch's hosts (``rank // local_size``, when every host's ranks are
    contiguous along the axis in equal counts) > flat. ``mesh=None`` with
    ``n`` set gives the topology of a bare axis size (virtual or flat)."""
    if mesh is not None:
        ranks = mesh.axis(axis_name).ranks
        size = len(ranks)
    else:
        ranks = None
        size = int(n or 0)
    if size <= 1:
        return flat_topology(size or 1)

    vh = virtual_hosts()
    if vh > 0:
        if vh <= size and size % vh == 0:
            return MeshTopology(vh, size // vh)
        import warnings
        warnings.warn(f"HVD_TPU_VIRTUAL_HOSTS={vh} does not evenly divide "
                      f"axis size {size}; ignoring the virtual split")

    if ranks is None:
        return flat_topology(size)
    from horovod_tpu_torch.common.basics import is_homogeneous, local_size
    if not is_homogeneous():
        return flat_topology(size)
    hosts_of = [r // local_size() for r in ranks]
    hosts = sorted(set(hosts_of))
    if len(hosts) <= 1 or size % len(hosts) != 0:
        return flat_topology(size)
    local = size // len(hosts)
    # contiguity + equal counts: host h owns axis slots [h*local, (h+1)*local)
    for i, h in enumerate(hosts_of):
        if hosts_of[(i // local) * local] != h:
            return flat_topology(size)
    return MeshTopology(len(hosts), local)
