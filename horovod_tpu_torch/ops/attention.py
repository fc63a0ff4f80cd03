"""Flash attention with the log-sum-exp residual, differentiable.

Mirrors ``horovod_tpu/ops/pallas_attention.py`` (``flash_attention_with_lse``,
``flash_attention_tpu`` as :func:`flash_attention`, ``attend`` and the
custom VJP ``_flash_fwd``/``_flash_bwd``); the plain version is
``horovod_tpu/parallel/ring_attention.py::_plain_attention`` with the
row log-sum-exp added (:func:`plain_attention_with_lse`).

The forward is the hand-written CUDA kernel ``csrc/flash_attn_fwd.cu`` for
a CUDA tensor and the plain version for a CPU tensor; nothing else chooses.
A CUDA tensor the kernel does not take (a dtype other than fp32 or bf16, a
head dim other than 64 or 128, an unaligned stride) raises. The backward is
the JAX package's blockwise recompute, ported line for line to PyTorch: the
reference leaves it to XLA, and this port leaves it to PyTorch's kernels.

Layouts are the JAX package's: q/k/v/o ``[B, S, H, D]``, lse
``[B*H, Sq]`` fp32 with row ``b*H + h``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from horovod_tpu_torch.metrics import mfu
from horovod_tpu_torch.ops import _build

NEG_INF = -1e30
BLOCK_K = 128          # the backward's key block, as in the JAX package
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else float(1.0 / (q.shape[-1] ** 0.5))


def plain_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``_plain_attention`` in fp32, plus the
    row log-sum-exp the kernel emits. Used for CPU tensors and by the
    checks that hold the kernel to it."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    lse = torch.logsumexp(s, dim=-1)                       # [B, H, Sq]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return o, lse.reshape(B * H, Sq)


def flash_attn_fwd_cuda(q, k, v, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attn_fwd.cu`` on CUDA tensors q/k/v
    ``[B, S, H, D]``; returns ``(o, lse)``. Counts its launches in
    ``flash_attn_fwd_cuda.launches``.

    Replaces ``_flash_kernel`` (``horovod_tpu/ops/pallas_attention.py``).
    At the flagship's shape the card's bound is its memory (about 8.4 MB,
    2.5 us), at long sequences its tensor cores. The bf16 kernel streams
    k/v through a TMA ring over their strides and keeps both products and
    the softmax in registers (``wgmma``); fp32 takes scalar FMAs (the
    source says more).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attn_fwd takes fp32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd takes head dim 64 or 128, got {D}")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match as [B, S, H, D]")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("flash_attn_fwd takes q/k/v on one CUDA device")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(st % vec for st in t.stride()[:3])):
            raise ValueError(f"flash_attn_fwd needs {name} with a contiguous "
                             f"last dim and 16-byte aligned rows, got strides "
                             f"{t.stride()}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.library("flash_attn_fwd")
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, Sq, Sk, D, _KERNEL_DTYPES[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), scale, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attn_fwd", err)
    flash_attn_fwd_cuda.launches += 1
    return o, lse


flash_attn_fwd_cuda.launches = 0


def flash_attn_fwd_flops(B: int, Sq: int, Sk: int, H: int, D: int,
                         causal: bool) -> int:
    """FLOPs of one forward: the products q·kᵀ and p·v, 2·D FLOPs each per
    (query, key) pair and head, over the pairs the kernel computes — under
    ``causal`` query row i meets keys 0..i (half the square and the
    diagonal, as ``chip_smoke.attention_cost`` counts). What
    :func:`horovod_tpu_torch.metrics.mfu.flops_per_step` adds for a call,
    on the card and on the CPU alike."""
    if causal:
        m = min(Sq, Sk)
        pairs = m * (m + 1) // 2 + (Sq - m) * Sk
    else:
        pairs = Sq * Sk
    return 4 * B * H * D * pairs


def _flash_fwd(q, k, v, causal: bool, scale: float):
    B, Sq, H, D = q.shape
    mfu.count_kernel_flops(flash_attn_fwd_flops(B, Sq, k.shape[1], H, D,
                                                causal))
    if q.is_cuda:
        return flash_attn_fwd_cuda(q, k, v, causal, scale)
    with mfu.uncounted():
        return plain_attention_with_lse(q, k, v, causal, scale)


def _flash_bwd(q, k, v, o, lse, do, dlse, causal: bool, scale: float):
    """Blockwise flash backward, ported from ``_flash_bwd``: recompute
    ``p = exp(s - lse)`` one key block at a time; ``dv = pᵀ·do``,
    ``ds = p ⊙ (do·vᵀ − adj)``, ``dq += ds·k``, ``dk = dsᵀ·q``, with
    ``adj = rowsum(do·o) − dlse`` folding the lse cotangent into the row
    term. Under ``causal`` key block j reaches only q rows ≥ j·block, so
    those rows alone are recomputed (the JAX path for ≤ 64 blocks; its
    full-row loop for longer sequences computes the same)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    bk = BLOCK_K

    def fold(x, S):
        return x.transpose(1, 2).reshape(B * H, S, D).float()

    qf, kf, vf = fold(q, Sq), fold(k, Sk), fold(v, Sk)
    of = fold(o, Sq)
    dof = fold(do, Sq) if do is not None else torch.zeros_like(of)
    if dlse is None:
        dlse = torch.zeros_like(lse)
    adj = (dof * of).sum(-1) - dlse.float()                     # [BH, Sq]

    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0k in range(0, Sk, bk):
        r0 = r0k if causal else 0                  # first live q row
        kb, vb = kf[:, r0k:r0k + bk], vf[:, r0k:r0k + bk]
        qs, dos = qf[:, r0:], dof[:, r0:]
        s = torch.einsum("bqd,bkd->bqk", qs, kb) * scale
        if causal:
            qpos = torch.arange(r0, Sq, device=q.device)
            kpos = torch.arange(r0k, r0k + kb.shape[1], device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.full((), NEG_INF, device=q.device))
        p = torch.exp(s - lse[:, r0:, None])
        dv[:, r0k:r0k + bk] = torch.einsum("bqk,bqd->bkd", p, dos)
        dp = torch.einsum("bqd,bkd->bqk", dos, vb)
        ds = p * (dp - adj[:, r0:, None]) * scale
        dq[:, r0:] += torch.einsum("bqk,bkd->bqd", ds, kb)
        dk[:, r0k:r0k + bk] = torch.einsum("bqk,bqd->bkd", ds, qs)

    def unfold(x, S, like):
        return x.reshape(B, H, S, D).transpose(1, 2).to(like.dtype)

    return unfold(dq, Sq, q), unfold(dk, Sk, k), unfold(dv, Sk, v)


class _FlashAttention(torch.autograd.Function):
    """``(o, lse)`` with the kernel forward and the blockwise backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, dlse, ctx.causal,
                                ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: Optional[float] = None):
    """Attention returning ``(o, lse)``: the normalized output
    ``[B, Sq, H, D]`` and the per-row log-partition ``[B*H, Sq]`` fp32.
    Differentiable in both outputs."""
    return _FlashAttention.apply(q, k, v, causal, _scale(q, scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v ``[B, S, H, D]`` → ``[B, S, H, D]``; differentiable."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]


# The JAX ``attend`` picks the Pallas kernel when the TPU's tiling allows and
# XLA otherwise. Here the tensor's device picks (kernel on CUDA, plain on the
# CPU), and a ragged sequence is masked inside the kernel, so the two agree.
attend = flash_attention
