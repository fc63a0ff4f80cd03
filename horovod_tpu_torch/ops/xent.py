"""Fused softmax cross-entropy, differentiable.

Mirrors ``horovod_tpu/ops/pallas_xent.py`` (``fused_softmax_xent``, the
plain ``_xla_xent`` and the custom VJP ``_fused_xent_fwd``/
``_fused_xent_bwd``).

The forward is the hand-written CUDA kernel ``csrc/xent_fwd.cu`` for a
CUDA tensor and the plain version for a CPU tensor; a CUDA tensor of a
dtype other than fp32 or bf16 raises. Both give ``loss = lse - z_label``,
and a label outside ``[0, V)`` contributes no logit, so its loss is
``lse`` (not a clipped gather, and not ``ignore_index``). The backward is
the JAX package's closed form ``g·(exp(logits − lse) − onehot)`` off the
saved lse, with a zero onehot row for an out-of-range label, cast back to
the logits' dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from horovod_tpu_torch.metrics import mfu
from horovod_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain_xent(logits: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version, ``_xla_xent`` plus the lse:
    logits ``[N, V]``, integer labels ``[N]`` → fp32 ``(loss, lse)``."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    v = lf.shape[-1]
    ok = (labels >= 0) & (labels < v)
    z = torch.gather(lf, -1, labels.clamp(0, v - 1).long()[..., None])[..., 0]
    return lse - torch.where(ok, z, torch.zeros((), device=lf.device)), lse


def xent_fwd_cuda(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/xent_fwd.cu`` on CUDA logits ``[N, V]`` and int64
    labels ``[N]``; returns fp32 ``(loss, lse)``. Counts its launches in
    ``xent_fwd_cuda.launches``.

    Replaces ``_xent_kernel`` (``horovod_tpu/ops/pallas_xent.py``). The
    card's bound is its memory (the logits read once: 131 MB, 39 us at
    the flagship's 2048 x 32000 in bf16); the kernel streams each row once
    in 16-byte loads with an online max and sum, and masks the V edge
    instead of padding a copy (the source says more).
    """
    if logits.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"xent_fwd takes fp32 or bf16 logits, got {logits.dtype}")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"xent_fwd takes logits [N, V] and labels [N], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.device.type != "cuda" or labels.device != logits.device:
        raise ValueError("xent_fwd takes logits and labels on one CUDA device")
    if logits.stride(1) != 1:
        raise ValueError(f"xent_fwd needs a contiguous vocab dim, got strides "
                         f"{logits.stride()}")
    n, v = logits.shape
    labels = labels.to(torch.int64).contiguous()
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return loss, lse
    if v == 0:
        raise ValueError("xent_fwd takes a vocab of at least one entry")
    lib = _build.library("xent_fwd")
    err = lib.xent_fwd(
        logits.data_ptr(), logits.stride(0), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), n, v, _KERNEL_DTYPES[logits.dtype],
        logits.device.index, torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(lib, "xent_fwd", err)
    xent_fwd_cuda.launches += 1
    return loss, lse


xent_fwd_cuda.launches = 0


def xent_fwd_flops(n: int, v: int) -> int:
    """FLOPs of one forward as :func:`horovod_tpu_torch.metrics.mfu.
    flops_per_step` counts them (products only, as ``FlopCounterMode``
    does): none. The kernel takes each row's max, exponentials and sum of
    the ``[n, v]`` logits and multiplies nothing; the logits product
    before it is a ``torch.matmul``, counted where it runs."""
    del n, v
    return 0


class _FusedXent(torch.autograd.Function):
    """Per-row loss with the kernel forward and the closed-form backward."""

    @staticmethod
    def forward(ctx, logits, labels):
        mfu.count_kernel_flops(xent_fwd_flops(*logits.shape))
        if logits.is_cuda:
            loss, lse = xent_fwd_cuda(logits, labels)
        else:
            with mfu.uncounted():
                loss, lse = plain_xent(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[:, None])
        cols = torch.arange(logits.shape[1], device=logits.device)
        onehot = cols[None, :] == labels[:, None]
        d = (p - onehot.float()) * g[:, None]
        return d.to(logits.dtype), None


def fused_softmax_xent(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``-log softmax(logits)[label]``: ``[..., V]`` logits and
    integer ``[...]`` labels of any leading shape → fp32 ``[...]``."""
    v = logits.shape[-1]
    lead = logits.shape[:-1]
    flat = logits.reshape(-1, v)
    flat_labels = labels.reshape(-1).to(torch.int64)
    return _FusedXent.apply(flat, flat_labels).reshape(lead)
