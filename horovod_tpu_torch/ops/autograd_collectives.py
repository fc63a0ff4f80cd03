"""Differentiable collectives along one mesh axis, for the model's tensor,
sequence and expert axes.

The JAX package differentiates ``lax.psum``, ``lax.ppermute`` and
``lax.all_to_all`` inside ``shard_map(check_vma=False)``, where a psum
transposes to a psum: the gradients of the data axes come out
``dp·ep·sp`` times too large, and under tp the replicated leaves get
partial gradients (ROADMAP Queue 3). These functions carry the
mathematically correct transpose instead:

* :func:`reduce_from` ("g" in Megatron's terms): sum over the axis
  forward, identity backward. A tp-partial activation becomes replicated,
  and every rank's backward stands for the replicated value downstream.
* :func:`copy_to` ("f"): identity forward, sum over the axis backward. A
  replicated activation enters a tp-sharded product, and its cotangent is
  the sum of every shard's partial cotangent.
* :func:`mean_from`: the average over the axis forward, the cotangent
  over the axis size backward; the layout's loss from each rank's local
  loss, so that each rank's backward is its share of the global gradient.
* :func:`ring_shift`: ``pring_shift`` forward, the reverse shift
  backward.
* :func:`all_to_all`: the tiled all-to-all forward, the all-to-all with
  ``split_dim`` and ``concat_dim`` swapped backward.
* :func:`pmax`: gradient-free (the xent shift stops its gradient first).
* :func:`replicate_from_stage` (the pipeline's loss): the value of one
  position on every rank forward (the masked psum), the cotangent of the
  source position alone backward, delivered once: the JAX package's
  ``replicate_from_stage``. :func:`psum_cotangent` is the JAX name of
  :func:`copy_to` (identity forward, psum backward).

Every function takes an :class:`~horovod_tpu_torch.parallel.mesh.Axis`,
or ``None``; an axis of ``None`` or of size 1 is the identity, as the JAX
``_psum_if`` is.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.ops import mesh_collectives as mc
from horovod_tpu_torch.ops.reduce_op import ReduceOp


def live(axis) -> bool:
    """Whether ``axis`` runs collectives (present, of size > 1)."""
    return axis is not None and axis.size > 1


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, divisor):
        ctx.divisor = divisor
        out = mc.preduce(x, axis, ReduceOp.SUM)
        return out if divisor == 1 else out / divisor

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.divisor == 1 else g / ctx.divisor), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mc.preduce(g.contiguous(), ctx.axis, ReduceOp.SUM), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return mc.pring_shift(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return mc.pring_shift(g.contiguous(), ctx.axis, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return mc.palltoall(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (mc.palltoall(g, ctx.axis, concat_dim, split_dim), None, None,
                None)


class _ReplicateFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, src):
        ctx.axis, ctx.src = axis, src
        mine = x if axis.index == src else torch.zeros_like(x)
        return mc.preduce(mine, axis, ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.axis.index == ctx.src else torch.zeros_like(g),
                None, None)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """"g": ``psum`` forward, identity backward."""
    return _ReduceFrom.apply(x, axis, 1) if live(axis) else x


def mean_from(x: torch.Tensor, axis) -> torch.Tensor:
    """``pmean`` forward (the sum over the axis divided by its size, as
    ``preduce(Average)``), the cotangent divided by the size backward."""
    if not live(axis):
        return x
    return _ReduceFrom.apply(x, axis, axis.size)


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """"f": identity forward, ``psum`` of the cotangent backward."""
    return _CopyTo.apply(x, axis) if live(axis) else x


def ring_shift(x: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """Position ``i`` sends ``x`` to ``(i + shift) % n``; the cotangent
    travels back the other way."""
    return _RingShift.apply(x, axis, shift) if live(axis) else x


def all_to_all(x: torch.Tensor, axis, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """Tiled ``lax.all_to_all``: block ``j`` of ``split_dim`` to position
    ``j``, received blocks concatenated along ``concat_dim``."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim) if live(axis) \
        else x


def replicate_from_stage(x: torch.Tensor, axis, src: int) -> torch.Tensor:
    """Position ``src``'s ``x`` on every rank of the axis (the masked
    psum: the others add zeros, so the value is exact); backward gives the
    source its own cotangent and every other position zero, so a loss
    replicated this way and differentiated on every rank counts once."""
    return _ReplicateFrom.apply(x, axis, src) if live(axis) else x


psum_cotangent = copy_to


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The maximum over the axis, without a gradient."""
    x = x.detach()
    return mc.preduce(x, axis, ReduceOp.MAX) if live(axis) else x
