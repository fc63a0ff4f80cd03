"""Adasum: adaptive summation that keeps convergence when the batch grows
(reference: ``horovod/common/ops/adasum/adasum.h:38-180``, the VHDD
recursive vector-halving distance-doubling algorithm, and
``_DistributedAdasumOptimizer``, ``horovod/torch/optimizer.py:335``).

Mirrors ``horovod_tpu/ops/adasum.py``: the pairwise combine

    a' = (1 - dot(a,b) / (2*||a||^2)) * a  +  (1 - dot(a,b) / (2*||b||^2)) * b

folded in a binary tree over every rank's contribution (level k combines
partners at distance 2**k), after one all-gather. The mesh-axis regime
(:func:`adasum_allreduce_along`, ``preduce(op=Adasum)``) and the eager
regime of ``DistributedOptimizer(op=Adasum)`` (:func:`adasum_grads`: each
gradient all-gathered through the eager collectives, then folded) are
both here. The eager core's own ``Adasum`` op (``cpp/adasum.cc``, VHDD,
which folds the ranks past a power of two onto their partners first) is
reached through ``allreduce(op=Adasum)`` on the core.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Adasum of two tensors of one shape, in fp32, returned in
    ``a``'s dtype (reference: ``ComputeDotAndNormSqrds`` + ``ScaledAdd``,
    ``adasum/adasum.h:312-564``)."""
    return _combine_rows(a.reshape(1, -1), b.reshape(1, -1))[0].reshape(
        a.shape).to(a.dtype)


def _combine_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise combine of ``[n, m]`` stacks, in fp32."""
    af, bf = a.float(), b.float()
    dot = (af * bf).sum(1, keepdim=True)
    na = (af * af).sum(1, keepdim=True)
    nb = (bf * bf).sum(1, keepdim=True)
    # a zero norm keeps its partner as it is (the reference guards the
    # division the same way)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, 1.0)),
                     1.0)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, 1.0)),
                     1.0)
    return ca * af + cb * bf


def adasum_tree_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """Fold ``stacked[n, ...]`` with the combine in a binary tree
    (distance 1, 2, 4, ...). A count that is not a power of two is padded
    with zeros, which is exact: ``combine(a, 0) == a``."""
    from horovod_tpu_torch.common.util import next_power_of_two
    n = stacked.shape[0]
    shape, dtype = stacked.shape[1:], stacked.dtype
    rows = stacked.reshape(n, -1).float()
    if n & (n - 1):
        rows = torch.cat([rows, rows.new_zeros(
            (next_power_of_two(n) - n, rows.shape[1]))])
    while rows.shape[0] > 1:
        rows = _combine_rows(rows[0::2], rows[1::2])
    return rows[0].reshape(shape).to(dtype)


def adasum_allreduce_along(x: torch.Tensor, axis) -> torch.Tensor:
    """Adasum of ``x`` over a mesh axis (every rank of the axis calls it)."""
    from horovod_tpu_torch.ops.mesh_collectives import _gathered
    return adasum_tree_reduce(_gathered(x, axis).wait())


def adasum_grads(grads: Sequence[torch.Tensor], process_set=None,
                 axis=None) -> List[torch.Tensor]:
    """The gradient sync of ``DistributedOptimizer(op=Adasum)``: along
    ``axis`` when one is given, else through the eager collectives (each
    gradient all-gathered as ``adasum.<i>`` and folded; ``:76-107`` of the
    JAX module), the identity for a single contributor."""
    from horovod_tpu_torch.common.basics import is_initialized
    from horovod_tpu_torch.common.process_sets import global_process_set
    ps = process_set if process_set is not None else global_process_set
    if axis is not None:
        return [adasum_allreduce_along(g, axis) for g in grads]
    if not is_initialized() or ps.size() <= 1:
        return list(grads)
    from horovod_tpu_torch.ops import collectives as C
    handles = [C.allgather_async(g[None], name=f"adasum.{i}", process_set=ps)
               for i, g in enumerate(grads)]
    return [adasum_tree_reduce(h.wait()) for h in handles]
