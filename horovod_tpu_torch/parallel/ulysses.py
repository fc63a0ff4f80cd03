"""Ulysses-style sequence parallelism: all-to-all head↔sequence
re-sharding around exact attention.

Mirrors ``horovod_tpu/parallel/ulysses.py``: ``ulysses_attention_spmd``
and ``ulysses_attention``. Sequence-sharded q/k/v are re-sharded to
head-sharded for attention over the full sequence, then re-sharded back:
two all-to-alls a call instead of a ring of exchanges. The all-to-alls
are differentiable (their backward swaps split and concat), and the
attention between them is
:func:`~horovod_tpu_torch.ops.attention.attend`: the ``flash_attn_fwd``
kernel on the card at the full S and ``H/sp`` heads.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops import mesh_collectives as mc
from horovod_tpu_torch.ops.attention import attend
from horovod_tpu_torch.parallel.ring_attention import (_batch_block,
                                                       _plain_attention,
                                                       _seq_block)


def ulysses_attention_spmd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, axis, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """This rank's block: local ``[B, S/sp, H, D]`` → ``[B, S/sp, H, D]``.

    all-to-all #1 scatters heads and gathers the sequence, ``[B, S, H/sp,
    D]`` (q, k and v in one exchange); attention over the full sequence
    for the local head group; all-to-all #2 scatters the sequence and
    gathers heads back."""
    n = axis.size
    H = q.shape[2]
    if H % n:
        raise ValueError(f"Ulysses needs heads ({H}) divisible by axis ({n})")
    qkv = ac.all_to_all(torch.stack([q, k, v]), axis, 3, 2)
    # contiguous heads for the kernel's 16-byte row reads
    qh, kh, vh = (t.contiguous() for t in qkv.unbind(0))
    out = attend(qh, kh, vh, causal, scale)
    return ac.all_to_all(out, axis, 1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "sp", causal: bool = True,
                      scale: Optional[float] = None,
                      batch_axis: Optional[str] = "dp") -> torch.Tensor:
    """Array-level wrapper on every rank: global ``[B, S, H, D]``, S split
    over the axis (and B over ``batch_axis`` when live); the global output,
    gathered back (forward only)."""
    ax = mesh.axis(axis_name)
    if ax.size == 1:
        return _plain_attention(q, k, v, causal, scale)
    b_ax = mesh.axis(batch_axis) if (
        batch_axis and mesh.shape.get(batch_axis, 1) > 1) else None
    ql, kl, vl = (_seq_block(_batch_block(x, b_ax), ax) for x in (q, k, v))
    out = mc.pallgather(ulysses_attention_spmd(ql, kl, vl, ax, causal,
                                               scale), ax, dim=1)
    return mc.pallgather(out, b_ax, dim=0) if b_ax is not None else out
