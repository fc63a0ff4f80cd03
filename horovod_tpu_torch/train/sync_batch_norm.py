"""Batch normalization with moments over the data-parallel ranks.

Mirrors ``horovod_tpu/train/sync_batch_norm.py``: ``_axes_live``,
:func:`sync_batch_norm_spmd` (the functional form, channels last) and
:class:`SyncBatchNorm` (momentum as the running average's decay, the
unbiased ``n/(n-1)`` running variance over the GLOBAL count). The JAX
package takes mesh axis names inside ``shard_map``; here the axes are
:class:`~horovod_tpu_torch.parallel.mesh.Axis` objects (``mesh.axis("dp")``),
and an axis that is ``None`` or of size 1 is the identity, as there.

Both forms sit on one autograd function, written out as reference
Horovod's ``torch/sync_batch_norm.py`` does: the forward all-reduces one
vector ``[Σx, Σx², n]`` over each axis (the biased variance is
``E[x²] − E[x]²``, clipped at 0, as flax's fast variance); the backward
all-reduces the two cotangent sums ``[Σdy, Σdy·x̂]`` the input gradient
needs. Both vectors are fp64 on every device (the card's kernels sum in
fp64; the CPU's sums are widened), and each stage rounds them to the
statistics' dtype. The scale's and bias's gradients stay this rank's own
sums: the train step's gradient sync adds them over the data axes, as it
adds every other leaf's. A loss that is the sum of the ranks' losses (each rank's
share of the global mean, as the port's train steps give it) then has its
true gradient: that of plain batch norm over the concatenated batch in one
process.

The model zoo's BN layer is :class:`SyncBatchNorm` with flax
``nn.BatchNorm``'s running-variance rule (the biased batch variance,
``unbiased_running_var=False``) over the channel dim of NCHW activations;
under a mesh its moments are reduced over the data axes, which is what the
JAX zoo's GSPMD-auto step computes over its sharded global batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.ops.mesh_collectives import preduce
from horovod_tpu_torch.ops.reduce_op import ReduceOp


def _axes_live(axes: Optional[Sequence]) -> Tuple:
    """The axes that run collectives: present and of size > 1."""
    return tuple(a for a in (axes or ()) if a is not None and a.size > 1)


def _allreduce(v: torch.Tensor, axes) -> torch.Tensor:
    for a in axes:
        v = preduce(v, a, ReduceOp.SUM)
    return v


class _BatchNorm(torch.autograd.Function):
    """``y = (x − mean)·rsqrt(var + eps)·scale + bias`` in the statistics'
    dtype, cast to ``out_dtype``, with the moments over every dim of ``x``
    but ``channel_dim`` and over the live ``axes``; ``running`` (a
    :class:`~horovod_tpu_torch.ops.batch_norm.Running` or None) updated in
    place. Returns ``(y, mean, var, n)``, ``n`` in fp64 on every device;
    only ``y`` has a gradient. The stages are ``ops/batch_norm``'s:
    its kernels on the card, its plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, scale, bias, axes, eps, channel_dim, out_dtype,
                running):
        x = bn.kernel_input(x, channel_dim)
        stats = _allreduce(bn.stats(x, channel_dim), axes)
        y, mean, var, rstd = bn.normalize(x, stats, scale, bias, eps,
                                          channel_dim, out_dtype, running)
        n = stats[mean.numel() * 2]
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.axes, ctx.channel_dim, ctx.n = axes, channel_dim, n
        ctx.bias_dtype = bias.dtype
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, dy, _mean, _var, _n):
        x, scale, mean, rstd = ctx.saved_tensors
        cd, C = ctx.channel_dim, mean.numel()
        local = bn.grad_sums(x, dy, mean, rstd, cd)
        glob = _allreduce(local, ctx.axes) if ctx.axes else local
        dx = bn.grad_input(x, dy, mean, rstd, scale, glob, ctx.n, cd)
        dbias, dscale = local.to(scale.dtype).view(2, C).unbind(0)
        return (dx, dscale, dbias.to(ctx.bias_dtype), None, None, None, None,
                None)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     axes=(), eps: float = 1e-5, channel_dim: int = -1,
                     out_dtype: Optional[torch.dtype] = None,
                     running: Optional[bn.Running] = None):
    """Batch norm in training mode: ``(y, mean, var, n)``, with the batch
    moments (fp32 or fp64, biased variance) over every dim of ``x`` but
    ``channel_dim`` and over the live ``axes``, and ``n`` the global count
    they were taken over (fp64). ``running``, when given, is updated in place
    with them (on the card by the forward's second kernel)."""
    return _BatchNorm.apply(x, scale, bias, _axes_live(axes), eps,
                            channel_dim % x.dim(), out_dtype or x.dtype,
                            running)


def sync_batch_norm_spmd(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, axes=(), eps: float = 1e-5
                         ) -> torch.Tensor:
    """Normalize ``x [..., C]`` with moments reduced over the batch dims
    AND the given mesh axes (the sync part); the output in ``x.dtype``."""
    return batch_norm_train(x, scale, bias, axes, eps)[0]


class SyncBatchNorm(nn.Module):
    """Batch norm with cross-rank statistics over ``axes`` (``Axis``
    objects; empty, ``None`` or size-1 axes reduce nothing).

    Parameters ``scale`` (ones) and ``bias`` (zeros), buffers ``mean``
    (zeros) and ``var`` (ones): flax's names. In training mode (or with
    ``use_running_average=False``) it normalizes with the batch moments and
    updates the running averages as ``momentum · old + (1 − momentum) ·
    new``, the variance multiplied by ``n/(n−1)`` over the global count
    when ``unbiased_running_var`` (the JAX ``SyncBatchNorm``, and reference
    Horovod's) or taken biased (flax ``nn.BatchNorm``, the model zoo's
    layer). In eval mode it normalizes with the running averages. The
    output is ``dtype`` (default: the input's). ``channel_dim`` is -1 for
    the JAX layout ``[..., C]``, 1 for NCHW."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 axes: Sequence = (), channel_dim: int = -1,
                 unbiased_running_var: bool = True, device=None,
                 scale_init: float = 1.0):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.axes = tuple(axes or ())
        self.channel_dim = channel_dim
        self.unbiased_running_var = unbiased_running_var
        self.scale_init = scale_init
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.full((num_features,), scale_init,
                                             **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("mean", torch.zeros(num_features, **kw))
        self.register_buffer("var", torch.ones(num_features, **kw))
        # set while torch.utils.checkpoint recomputes a block: the forward
        # already updated the running averages once
        self.recomputing = False

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        if use_running_average is None:
            use_running_average = not self.training
        out_dtype = self.dtype or x.dtype
        cd = self.channel_dim % x.dim()
        if use_running_average:
            shape = [1] * x.dim()
            shape[cd] = x.shape[cd]
            mul = (torch.rsqrt(self.var + self.epsilon) * self.scale
                   ).view(shape)
            y = (x.to(bn.stat_dtype(x)) - self.mean.view(shape)) * mul \
                + self.bias.view(shape)
            return y.to(out_dtype)
        running = None if self.recomputing else bn.Running(
            self.mean, self.var, self.momentum, 1 - self.momentum,
            self.unbiased_running_var)
        return batch_norm_train(x, self.scale, self.bias, self.axes,
                                self.epsilon, cd, out_dtype, running)[0]
