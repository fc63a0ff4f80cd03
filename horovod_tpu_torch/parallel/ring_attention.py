"""Ring attention: context parallelism over the ``sp`` mesh axis.

Mirrors ``horovod_tpu/parallel/ring_attention.py``: ``_block_attend``,
``_online_update``, ``ring_attention_spmd``, ``_ring_flash``,
``ring_attention`` and ``_plain_attention``. The sequence is split over
sp; K/V blocks travel the ring (``pring_shift``) while each rank
accumulates its queries' attention, so the causal result equals full
attention with a causal mask.

Two forward algebras, as in the JAX package:
* the flash algebra (``_ring_flash``): each step is one call of
  :func:`~horovod_tpu_torch.ops.attention.flash_attention_with_lse`, the
  ``flash_attn_fwd`` kernel on the card and its plain version on the CPU,
  returning a normalized ``(o, lse)`` partial; partials merge by
  ``logaddexp``. An earlier block is attended in full, the own block
  diagonal-causal, and a later block is skipped (no launch). The JAX
  ``lax.switch`` on a traced index is a Python branch here: the rank's
  position on the axis is known on the host;
* the online-softmax algebra (``_block_attend``/``_online_update``) in
  fp32, with an explicit causal bias.
``use_flash=None`` takes the flash algebra for a CUDA tensor (the kernel
takes the flagship's D 64; the JAX default is a TPU tiling gate) and the
online one for a CPU tensor, as the JAX package does off the TPU.

The backward is written out, as one autograd node per call: it replays
the ring from the saved K/V blocks with the blockwise flash backward of
:mod:`~horovod_tpu_torch.ops.attention` (``p = exp(s − lse)`` against the
final lse, so the merge needs no gradient of its own), and the K/V
cotangents travel the ring with their blocks back to their owners. Every
rank issues the same exchanges in the same order whatever blocks the
causal mask skips, which a graph of per-step autograd nodes would not
guarantee (ranks would hold graphs of different shapes).
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops import mesh_collectives as mc
from horovod_tpu_torch.ops.attention import (_flash_bwd, _scale,
                                             flash_attention_with_lse)

NEG_INF = -1e30


def _block_attend(q, k, v, bias, scale):
    """One block's contribution with running-softmax stats: q ``[B, Sq, H,
    D]``, k/v ``[B, Sk, H, D]``, bias ``[B, H, Sq, Sk]`` or None → (row max
    ``[B, H, Sq]``, row sum ``[B, H, Sq]``, un-normalized ``p·v`` ``[B, Sq,
    H, D]``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m, p.sum(-1), pv


def _online_update(acc, m_run, l_run, m_new, l_new, pv_new):
    """Flash-attention merge of two partial softmaxes."""
    m_next = torch.maximum(m_run, m_new)
    a = torch.exp(m_run - m_next)
    b = torch.exp(m_new - m_next)
    l_next = l_run * a + l_new * b
    # acc [B, Sq, H, D]; a/b [B, H, Sq] -> [B, Sq, H, 1]
    acc_next = acc * a.transpose(1, 2)[..., None] \
        + pv_new * b.transpose(1, 2)[..., None]
    return acc_next, m_next, l_next


def _block_kind(causal: bool, src: int, my: int) -> str:
    """How this rank's queries meet the K/V block of ``src``."""
    if not causal or src < my:
        return "full"
    return "diag" if src == my else "skip"


def _online_forward(q, blocks, my, n, causal, scale):
    """The online algebra over the ring's K/V ``blocks`` (block ``t`` is
    source ``(my - t) % n``): ``(o, lse)`` with lse ``[B*H, Sq]``."""
    B, Sq, H, D = q.shape
    acc = q.new_zeros((B, Sq, H, D), dtype=torch.float32)
    m_run = q.new_full((B, H, Sq), NEG_INF, dtype=torch.float32)
    l_run = q.new_zeros((B, H, Sq), dtype=torch.float32)
    qf = q.float()
    for t, (k_t, v_t) in enumerate(blocks):
        src = (my - t) % n
        bias = None
        if causal:
            Sk = k_t.shape[1]
            qpos = my * Sq + torch.arange(Sq, device=q.device)
            kpos = src * Sk + torch.arange(Sk, device=q.device)
            bias = torch.where(qpos[:, None] >= kpos[None, :],
                               torch.zeros((), device=q.device),
                               torch.full((), NEG_INF, device=q.device)
                               )[None, None]
        m_new, l_new, pv = _block_attend(qf, k_t.float(), v_t.float(), bias,
                                         scale)
        acc, m_run, l_run = _online_update(acc, m_run, l_run, m_new, l_new,
                                           pv)
    # guard fully-masked rows, as the JAX package does
    out = acc / l_run.clamp_min(1e-30).transpose(1, 2)[..., None]
    lse = (m_run + torch.log(l_run.clamp_min(1e-30))).reshape(B * H, Sq)
    return out.to(q.dtype), lse


def _ring_flash(q, blocks, my, n, causal, scale):
    """The flash algebra: per step the kernel's normalized ``(o, lse)``,
    merged by ``logaddexp`` (``o = Σ o_t · exp(lse_t − lse)``)."""
    B, Sq, H, D = q.shape
    acc = q.new_zeros((B, Sq, H, D), dtype=torch.float32)
    lse_run = q.new_full((B * H, Sq), NEG_INF, dtype=torch.float32)

    def w(x, lse_new):
        # [B*H, Sq] -> [B, Sq, H, 1] (a finite NEG_INF keeps this NaN-free)
        return torch.exp(x - lse_new).reshape(B, H, Sq).transpose(
            1, 2)[..., None]

    for t, (k_t, v_t) in enumerate(blocks):
        kind = _block_kind(causal, (my - t) % n, my)
        if kind == "skip":
            continue
        o_t, lse_t = flash_attention_with_lse(q, k_t, v_t,
                                              causal=kind == "diag",
                                              scale=scale)
        lse_new = torch.logaddexp(lse_run, lse_t)
        acc = acc * w(lse_run, lse_new) + o_t.float() * w(lse_t, lse_new)
        lse_run = lse_new
    return acc.to(q.dtype), lse_run


def _rotate(kv: torch.Tensor, axis) -> torch.Tensor:
    """The stacked K/V (or their cotangents) one step along the ring."""
    return mc.pring_shift(kv, axis, 1)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale, use_flash):
        n, my = axis.size, axis.index
        kv = torch.stack([k, v])
        blocks = [kv]
        for _ in range(n - 1):          # no rotation after the last block
            blocks.append(_rotate(blocks[-1], axis))
        pairs = [(b[0], b[1]) for b in blocks]
        if use_flash:
            o, lse = _ring_flash(q, pairs, my, n, causal, scale)
        else:
            o, lse = _online_forward(q, pairs, my, n, causal, scale)
        ctx.save_for_backward(q, o, lse, *blocks)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, o, lse, *blocks = ctx.saved_tensors
        axis, n, my = ctx.axis, ctx.axis.size, ctx.axis.index
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # the cotangent of block t's K/V, travelling with it: after step t
        # it moves on to the rank that holds block t + 1's source next
        dkv = torch.zeros(blocks[0].shape, dtype=torch.float32,
                          device=q.device)
        for t, kv in enumerate(blocks):
            if t:
                dkv = _rotate(dkv, axis)
            kind = _block_kind(ctx.causal, (my - t) % n, my)
            if kind == "skip":
                continue
            dq_t, dk_t, dv_t = _flash_bwd(q, kv[0], kv[1], o, lse, do, None,
                                          kind == "diag", ctx.scale)
            dq += dq_t
            dkv[0] += dk_t
            dkv[1] += dv_t
        # home: the accumulator of source (my + 1) % n moves one step on
        dkv = _rotate(dkv, axis)
        dkv = dkv.to(blocks[0].dtype)
        return dq.to(q.dtype), dkv[0], dkv[1], None, None, None, None


def ring_attention_spmd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        axis, causal: bool = True,
                        scale: Optional[float] = None,
                        use_flash: Optional[bool] = None) -> torch.Tensor:
    """This rank's block of attention over a sequence split along
    ``axis``: q/k/v ``[B, S_local, H, D]`` (block ``axis.index`` of the
    sequence) → ``[B, S_local, H, D]``. Every rank of the axis calls it
    together. An axis of size 1 is plain attention over the local block."""
    scale = _scale(q, scale)
    if use_flash is None:
        use_flash = q.is_cuda
    if not ac.live(axis):
        if use_flash:
            return flash_attention_with_lse(q, k, v, causal, scale)[0]
        return _plain_attention(q, k, v, causal, scale)
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), axis, causal, scale,
                                use_flash)


def _seq_block(x: torch.Tensor, ax) -> torch.Tensor:
    n = x.shape[1] // ax.size
    return x[:, ax.index * n:(ax.index + 1) * n]


def _batch_block(x: torch.Tensor, ax) -> torch.Tensor:
    if ax is None:
        return x
    n = x.shape[0] // ax.size
    return x[ax.index * n:(ax.index + 1) * n]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None,
                   batch_axis: Optional[str] = "dp",
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Array-level ring attention on every rank: global ``[B, S, H, D]``
    inputs, S split over ``axis_name`` (and B over ``batch_axis`` when it
    is live); returns the global output, gathered back. Forward only: the
    gather back is not differentiable."""
    ax = mesh.axis(axis_name)
    if ax.size == 1:
        return _plain_attention(q, k, v, causal, scale)
    b_ax = mesh.axis(batch_axis) if (
        batch_axis and mesh.shape.get(batch_axis, 1) > 1) else None
    ql, kl, vl = (_seq_block(_batch_block(x, b_ax), ax) for x in (q, k, v))
    out = ring_attention_spmd(ql, kl, vl, ax, causal, scale, use_flash)
    out = mc.pallgather(out, ax, dim=1)
    return mc.pallgather(out, b_ax, dim=0) if b_ax is not None else out


def _plain_attention(q, k, v, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-device reference attention in fp32 (the oracle of the ring,
    and the sp = 1 path)."""
    S = q.shape[1]
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
