"""Process meshes: named axes over the ranks of the world, each axis a
``torch.distributed`` process group.

Mirrors ``horovod_tpu/parallel/mesh.py`` (``AXIS_ORDER``, ``MeshSpec``,
``build_mesh``, ``mesh_axis_size``) and ``shard_batch`` of
``horovod_tpu/models/transformer.py``. A JAX mesh arranges devices and
names its axes for the collectives traced inside ``shard_map``; here one
process drives one device, so a mesh arranges the world's ranks in the
canonical 5-axis order, and :meth:`Mesh.axis` gives, for this rank, the
process group of each axis: the ranks that differ from it in that axis
only. The collectives of :mod:`horovod_tpu_torch.ops.mesh_collectives`
take such an :class:`Axis` where the JAX package takes an axis name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common.basics import rank, size

# Canonical axis order, outermost → innermost.
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "ep", "sp", "tp")

DATA_AXIS = "dp"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. ``-1`` for at most one axis means "absorb all
    remaining ranks" (conventionally ``dp``)."""

    dp: int = -1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {"dp": self.dp, "pp": self.pp, "ep": self.ep,
                 "sp": self.sp, "tp": self.tp}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product "
                    f"{fixed} ({sizes})")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"Mesh spec {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the world ranks along it (in
    axis order, this rank at ``index``) and their process group, whose
    group rank ``i`` is axis position ``i``."""

    mesh: "Mesh"
    name: str
    ranks: Tuple[int, ...]
    group: object

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's position along the axis (``lax.axis_index``)."""
        return self.ranks.index(rank())


def _group_over(ranks: Sequence[int]):
    """A process group over ``ranks`` (the world's own group when they are
    the world). Every rank of the world must call this, in the same order,
    for every group made."""
    if list(ranks) == list(range(size())):
        return dist.group.WORLD
    return dist.new_group(list(ranks))


class Mesh:
    """The world's ranks arranged as ``shape`` in ``AXIS_ORDER``. Building
    it is collective: every rank makes every axis group in one order."""

    def __init__(self, sizes: Dict[str, int]):
        self.shape: Dict[str, int] = {a: sizes[a] for a in AXIS_ORDER}
        self.ranks = np.arange(size()).reshape(
            tuple(self.shape[a] for a in AXIS_ORDER))
        self._axes = {name: self._make_axis(name) for name in AXIS_ORDER}
        self._splits: Dict[tuple, object] = {}
        # the axes whose groups ran a collective before their first batched
        # p2p exchange (parallel/pipeline.py)
        self.p2p_ready: set = set()

    def _lines(self, name: str) -> List[List[int]]:
        """Every run of ranks along axis ``name`` (the other coordinates
        fixed), in one order on every rank."""
        ax = AXIS_ORDER.index(name)
        moved = np.moveaxis(self.ranks, ax, -1)
        return [list(map(int, line))
                for line in moved.reshape(-1, moved.shape[-1])]

    def _make_axis(self, name: str) -> Axis:
        mine = None
        for line in self._lines(name):
            group = _group_over(line)
            if rank() in line:
                mine = Axis(self, name, tuple(line), group)
        return mine

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def split(self, name: str, position_groups: Sequence[Sequence[int]]
              ) -> Axis:
        """This rank's sub-axis among ``position_groups`` (lists of
        positions along axis ``name``, e.g. a topology's intra-host
        groups), made on first use for every run of the axis. Collective:
        every rank of the world calls it with the same groups."""
        key = (name, tuple(tuple(g) for g in position_groups))
        if key not in self._splits:
            mine = None
            for line in self._lines(name):
                for positions in key[1]:
                    ranks = [line[i] for i in positions]
                    group = _group_over(ranks)
                    if rank() in ranks:
                        mine = Axis(self, f"{name}{list(positions)}",
                                    tuple(ranks), group)
            self._splits[key] = mine
        return self._splits[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def build_mesh(spec: Optional[MeshSpec] = None, **axis_sizes: int) -> Mesh:
    """The canonical 5-axis mesh over every rank of the world:
    ``build_mesh(dp=2)`` or ``build_mesh(MeshSpec(dp=2))``. Unspecified
    axes get size 1 (``dp`` defaults to -1 = the remainder). Needs
    ``init()``; every rank must build the same meshes in the same order."""
    if spec is None:
        spec = MeshSpec(**axis_sizes)
    elif axis_sizes:
        raise ValueError("Pass either a MeshSpec or keyword sizes, not both.")
    return Mesh(spec.resolve(size()))


def dp_pp_mesh(dp: int = -1, pp: int = 1) -> Mesh:
    """The two-axis dp x pp mesh of pipelined data-parallel training:
    ``dp`` replicas each running a ``pp``-deep pipeline; ``dp=-1``
    absorbs the remaining ranks (``dp_pp_mesh(pp=4)`` on 8 ranks is 2x4).
    pp is the inner axis, so a pipeline's stages are neighbouring ranks.
    Collective, as :func:`build_mesh`."""
    return build_mesh(MeshSpec(dp=dp, pp=pp))


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def data_sharding_spec(mesh: Mesh) -> Tuple[Tuple[str, ...], Optional[str]]:
    """``(batch axes, sequence axis)``: the batch dim splits over every live
    data-like axis, dp and (expert parallelism subdividing the data-
    parallel groups, DeepSpeed-MoE style) ep, dp outermost; the sequence
    dim over sp when it is live. The JAX ``data_sharding_spec``'s
    ``P(("dp", "ep"), "sp")``."""
    batch = tuple(a for a in ("dp", "ep") if mesh.shape[a] > 1)
    return batch, ("sp" if mesh.shape["sp"] > 1 else None)


def shard_batch(tokens: torch.Tensor, targets: torch.Tensor, mesh: Mesh
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of a global ``[B, S]`` batch, as the JAX
    package's ``shard_batch`` shards it over devices: the rows split into
    equal contiguous blocks over ``(dp, ep)`` (block ``dp_i * ep + ep_i``),
    the sequence over sp (block ``sp_i``); tp and pp ranks get the same
    block."""
    batch_axes, seq_axis = data_sharding_spec(mesh)

    def local(x):
        for a in batch_axes:
            x = _block(x, mesh.axis(a), 0)
        if seq_axis is not None:
            x = _block(x, mesh.axis(seq_axis), 1)
        return x

    return local(tokens), local(targets)


def _block(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    if x.shape[dim] % ax.size:
        raise ValueError(f"a batch of {x.shape[dim]} along dim {dim} does not "
                         f"split over {ax.name}={ax.size}")
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)
