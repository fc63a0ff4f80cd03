"""DeepSeek-V2 (DeepSeek-AI, arXiv:2405.04434), the decoder as deepseek-ai's
``modeling_deepseek.py`` for V2 publishes it: multi-head latent attention
(MLA) and DeepSeekMoE, trained through the port's step.

No JAX counterpart: the JAX package has no such model. Parameter names are
the published checkpoint's (``layers.<i>.self_attn.q_proj.weight`` ...),
``[out, in]`` like ``nn.Linear``, but the routed experts of a layer are
stacked (``layers.<i>.mlp.experts.gate_proj`` ``[experts held, F, M]``).

The equations, for a row of ``S`` tokens ``x`` ``[S, M]``, ``H`` heads:

* RMSNorm: ``n(x) = (x / sqrt(mean(x²) + eps)) ⊙ g``, in fp32, cast back to
  the compute dtype before ``g`` (cast too) multiplies it.
* MLA, no q compression (``q_lora_rank`` null): ``q = x·W_qᵀ`` split per
  head into ``q_nope`` (``d_n`` 128) and ``q_pe`` (``d_r`` 64); ``[c, k_pe]
  = x·W_kv_aᵀ`` (``c`` of ``kv_lora_rank`` 512, ``k_pe`` of ``d_r``, one for
  all heads); ``[k_nope, v] = n(c)·W_kv_bᵀ`` split per head into ``d_n``
  and ``d_v`` (128); ``q_pe`` and ``k_pe`` de-interleaved (the pairs
  ``(2i, 2i+1)`` moved to ``(i, i + d_r/2)``) and rotated by
  ``r(t) = t·cos + rotate_half(t)·sin``; ``q = [q_nope, r(q_pe)]``, ``k =
  [k_nope, r(k_pe)]`` (192 dims); ``o = softmax(q·kᵀ·σ + causal)·v``
  (128 dims) through ``ops.attention.attend``; ``out = o·W_oᵀ``.
* YaRN (``rope_scaling``: factor ``s`` 40, original length ``L0`` 4096,
  ``β_fast`` 32, ``β_slow`` 1, ``mscale`` = ``mscale_all_dim`` = 0.707, θ
  10000): over the ``d_r/2`` frequencies ``f_i = θ^(−2i/d_r)``, ``inv_i =
  (f_i/s)·ramp_i + f_i·(1 − ramp_i)``, ``ramp`` the linear ramp from 0 to 1
  between the correction dims ``⌊d(β_fast)⌋`` and ``⌈d(β_slow)⌉`` with
  ``d(β) = d_r·ln(L0 / (2π·β)) / (2·ln θ)`` (clamped to ``[0, d_r − 1]``);
  ``cos``/``sin`` of ``t·inv`` (the halves repeated), times
  ``m(s, mscale)/m(s, mscale_all_dim)`` = 1, where ``m(s, μ) = 0.1·μ·ln s
  + 1``; the softmax scale ``σ = (d_n + d_r)^(−½)·m(s, mscale_all_dim)²``
  = 0.11472.
* SwiGLU: ``f(x) = (silu(x·W_gateᵀ) ⊙ x·W_upᵀ)·W_downᵀ``.
* DeepSeekMoE: ``p = softmax(x·W_gᵀ)`` in fp32 over all ``E`` routed
  experts, the greedy top-``k`` picks ``(e_j, p_e_j)`` (no renormalisation,
  ``routed_scaling_factor`` 1); ``y = Σ_j p_e_j·f_e_j(x) + f_shared(x)``,
  the shared experts one SwiGLU of ``n_shared·F`` (2 x 1408). The
  sequence-wise balance loss of a row: ``α·Σ_e (E/(S·k))·count_e·mean_t
  p_t,e`` (``count_e`` the picks of e in the row, no gradient), averaged
  over the rows; it joins the objective through the layer's output, as
  the published ``AddAuxiliaryLoss`` does. A rank holds experts ``[first,
  first + held)`` and computes their part alone
  (:func:`horovod_tpu_torch.parallel.moe.dropless_moe`): what the experts
  held elsewhere add is left out here, as their holders would add it.
* Decoder layer (pre-norm): ``h = x + MLA(n(x))``, ``x' = h + FFN(n(h))``,
  the FFN a SwiGLU of ``intermediate_size`` in the first
  ``first_k_dense_replace`` layers and DeepSeekMoE after; then ``n`` and the
  untied head ``logits = n(x)·W_headᵀ``.
* The loss: ``fused_softmax_xent`` over the head's logits, the per-token
  losses weighted by the batch's mask and summed over its count in the
  whole batch, plus every layer's balance loss.

Precision: bf16 compute over fp32 parameters (each cast where it is used);
RMSNorm, the router's logits and softmax, and the loss in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models._flax import sync_grads
from horovod_tpu_torch.ops import attention
from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops.mesh_collectives import preduce
from horovod_tpu_torch.ops.xent import fused_softmax_xent
from horovod_tpu_torch.parallel import moe
from horovod_tpu_torch.parallel.mesh import shard_rows
from horovod_tpu_torch.profiling import annotate, train_step


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """DeepSeek-V2-Lite's published config by default. ``n_routed_experts``
    is the router's width; a rank holds ``held_experts`` of them from
    ``first_expert`` on (None: all)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    first_expert: int = 0
    held_experts: Optional[int] = None
    aux_loss_alpha: float = 0.001
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def held(self) -> int:
        return (self.n_routed_experts if self.held_experts is None
                else self.held_experts)


# -- YaRN ---------------------------------------------------------------------

def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations: float, dim: int, base: float,
                             max_position: int) -> float:
    return (dim * math.log(max_position / (num_rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_find_correction_range(low_rot: float, high_rot: float, dim: int,
                               base: float, max_position: int
                               ) -> Tuple[int, int]:
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base,
                                              max_position))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base,
                                              max_position))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """The ``d_r/2`` rotary frequencies YaRN blends, fp32 on the CPU."""
    dim, base, s = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (s * base ** exps)
    low, high = yarn_find_correction_range(
        cfg.rope_beta_fast, cfg.rope_beta_slow, dim, base,
        cfg.rope_original_max_position)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return freq_inter * (1 - keep) + freq_extra * keep


def rope_mscale(cfg: DeepseekV2Config) -> float:
    """The factor on cos and sin (1 when ``mscale`` = ``mscale_all_dim``)."""
    return yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale) \
        / yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) \
        if cfg.rope_mscale_all_dim else 1.0
    return cfg.q_head_dim ** -0.5 * m * m


def _deinterleave(t: torch.Tensor) -> torch.Tensor:
    *lead, d = t.shape
    return t.view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def _rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    t = _deinterleave(t)
    half = t.shape[-1] // 2
    rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * cos + rot * sin


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return xf.to(x.dtype) * g.to(x.dtype)


# -- blocks -------------------------------------------------------------------

class _Linear(nn.Module):
    """``weight`` ``[out, in]`` in fp32, applied in the input's dtype."""

    def __init__(self, n_in: int, n_out: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, device=device))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype))


class _Norm(nn.Module):
    def __init__(self, n: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class SwiGLU(nn.Module):
    """``(silu(x·W_gateᵀ) ⊙ x·W_upᵀ)·W_downᵀ`` in the input's dtype."""

    def __init__(self, hidden: int, inner: int, device=None):
        super().__init__()
        self.gate_proj = _Linear(hidden, inner, device)
        self.up_proj = _Linear(hidden, inner, device)
        self.down_proj = _Linear(inner, hidden, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MLAttention(nn.Module):
    """Multi-head latent attention without q compression; ``forward(x, cos,
    sin)`` on the normed ``x`` ``[B, S, M]``, ``cos``/``sin`` ``[S, d_r]``
    in the compute dtype."""

    def __init__(self, cfg: DeepseekV2Config, device=None):
        super().__init__()
        self.cfg = cfg
        H, M = cfg.num_attention_heads, cfg.hidden_size
        self.scale = softmax_scale(cfg)
        self.q_proj = _Linear(M, H * cfg.q_head_dim, device)
        self.kv_a_proj_with_mqa = _Linear(
            M, cfg.kv_lora_rank + cfg.qk_rope_head_dim, device)
        self.kv_a_layernorm = _Norm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                    device)
        self.kv_b_proj = _Linear(
            cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            device)
        self.o_proj = _Linear(H * cfg.v_head_dim, M, device)

    def forward(self, x, cos, sin):
        c = self.cfg
        B, S, _ = x.shape
        H, dn, dr = c.num_attention_heads, c.qk_nope_head_dim, \
            c.qk_rope_head_dim
        with annotate("hvd.mla"):
            q = self.q_proj(x).view(B, S, H, dn + dr)
            q_nope, q_pe = q.split([dn, dr], dim=-1)
            ckv, k_pe = self.kv_a_proj_with_mqa(x).split(
                [c.kv_lora_rank, dr], dim=-1)
            kv = self.kv_b_proj(self.kv_a_layernorm(ckv)).view(
                B, S, H, dn + c.v_head_dim)
            k_nope, v = kv.split([dn, c.v_head_dim], dim=-1)
            cos, sin = cos[None, :, None], sin[None, :, None]
            q = torch.cat([q_nope, _rotate(q_pe, cos, sin)], dim=-1)
            k_pe = _rotate(k_pe.view(B, S, 1, dr), cos, sin)
            k = torch.cat([k_nope, k_pe.expand(B, S, H, dr)], dim=-1)
            o = attention.attend(q, k, v, causal=True, scale=self.scale)
            return self.o_proj(o.reshape(B, S, H * c.v_head_dim))


class _AddAuxiliaryLoss(torch.autograd.Function):
    """``x`` unchanged; in backward ``aux`` gets the gradient 1, so the
    balance loss joins the objective (the published ``AddAuxiliaryLoss``)."""

    @staticmethod
    def forward(ctx, x, aux):
        ctx.dtype, ctx.device = aux.dtype, aux.device
        return x

    @staticmethod
    def backward(ctx, g):
        return g, torch.ones((), dtype=ctx.dtype, device=ctx.device)


def seq_balance_loss(scores: torch.Tensor, index: torch.Tensor, rows: int,
                     alpha: float, share: float = 1.0) -> torch.Tensor:
    """The sequence-wise balance loss over ``rows`` rows: ``scores``
    ``[rows·S, E]``, ``index`` ``[rows·S, k]``; ``share`` scales it to this
    rank's part of the global batch's mean."""
    T, E = scores.shape
    S, k = T // rows, index.shape[-1]
    ce = torch.zeros(rows, E, device=scores.device).scatter_add_(
        1, index.view(rows, S * k),
        torch.ones(rows, S * k, device=scores.device)).div_(S * k / E)
    return (ce * scores.view(rows, S, E).mean(1)).sum(1).mean() \
        * (alpha * share)


class HeldExperts(nn.Module):
    """The stacked SwiGLU weights of the routed experts a rank holds."""

    def __init__(self, count: int, hidden: int, inner: int, device=None):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(count, inner, hidden,
                                                  device=device))
        self.up_proj = nn.Parameter(torch.empty(count, inner, hidden,
                                                device=device))
        self.down_proj = nn.Parameter(torch.empty(count, hidden, inner,
                                                  device=device))


class DeepseekMoE(nn.Module):
    """Shared experts plus the held routed experts, routed over all
    ``n_routed_experts`` by the fp32 router ``gate.weight`` ``[E, M]``.
    ``routed_pairs`` (a buffer, not saved) sums the (token, slot) pairs
    each held expert computed over the ``routed_steps`` forwards since
    both were last zeroed, on the device."""

    def __init__(self, cfg: DeepseekV2Config, device=None, ep=None):
        super().__init__()
        self.cfg, self.ep = cfg, ep
        M = cfg.hidden_size
        self.gate = nn.Module()
        self.gate.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, M,
                                                    device=device))
        self.experts = HeldExperts(cfg.held, M, cfg.moe_intermediate_size,
                                   device)
        self.shared_experts = SwiGLU(
            M, cfg.moe_intermediate_size * cfg.n_shared_experts, device)
        self.register_buffer("routed_pairs", torch.zeros(
            cfg.held, dtype=torch.int64, device=device), persistent=False)
        self.register_buffer("routed_steps", torch.zeros(
            (), dtype=torch.int64, device=device), persistent=False)
        self.register_buffer("aux_loss", torch.zeros((), device=device),
                             persistent=False)
        self.share = 1.0

    def forward(self, x):
        c = self.cfg
        B, S, M = x.shape
        xt = x.reshape(B * S, M)
        with annotate("hvd.moe.route"):
            logits = F.linear(xt.float(), self.gate.weight.float())
        y, routing, pairs = moe.dropless_moe(
            xt, logits, c.num_experts_per_tok, c.first_expert, c.held,
            self.experts.gate_proj, self.experts.up_proj,
            self.experts.down_proj, self.ep, c.routed_scaling_factor)
        with annotate("hvd.moe.route"):
            aux = seq_balance_loss(routing.scores, routing.index, B,
                                   c.aux_loss_alpha, self.share)
        with annotate("hvd.moe.shared"):
            shared = self.shared_experts(x)
        self.routed_pairs.add_(pairs.counts)
        self.routed_steps.add_(1)
        self.aux_loss.copy_(aux.detach())
        return _AddAuxiliaryLoss.apply(y.view(B, S, M) + shared, aux)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int, device=None,
                 ep=None):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.input_layernorm = _Norm(cfg.hidden_size, eps, device)
        self.self_attn = MLAttention(cfg, device)
        self.post_attention_layernorm = _Norm(cfg.hidden_size, eps, device)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size, device)
                    if index < cfg.first_k_dense_replace
                    else DeepseekMoE(cfg, device, ep))

    def forward(self, x, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


def _axes(mesh):
    """``(dp, ep)`` of the mesh (either None when absent); DeepSeek-V2
    trains over dp, and ep is left to the MoE layer."""
    if mesh is None:
        return None, None
    other = [a for a in ("pp", "sp", "tp") if mesh.shape[a] > 1]
    if other:
        raise ValueError(f"DeepSeek-V2 trains over dp (and ep in the MoE "
                         f"layers); the mesh {mesh} has {other} live")
    return mesh.axis("dp"), mesh.axis("ep")


class DeepseekV2(nn.Module):
    """``forward(input_ids [B, S]) -> logits [B, S, V]`` in the compute
    dtype. ``device=None`` puts it on this process's card and raises when
    there is none. Parameters are allocated uninitialised:
    :func:`init_deepseek` draws them, or load a ``state_dict``."""

    def __init__(self, cfg: DeepseekV2Config, device=None, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.mesh = cfg, mesh
        dp, ep = _axes(mesh)
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_size, device=dev))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i, dev, ep)
            for i in range(cfg.num_hidden_layers))
        self.norm = _Norm(cfg.hidden_size, cfg.rms_norm_eps, dev)
        self.lm_head = _Linear(cfg.hidden_size, cfg.vocab_size, dev)
        self.register_buffer("inv_freq", yarn_inv_freq(cfg).to(dev),
                             persistent=False)
        self.moe = [layer.mlp for layer in self.layers
                    if isinstance(layer.mlp, DeepseekMoE)]
        for m in self.moe:
            m.share = 1.0 / (dp.size if dp is not None else 1)

    def rope(self, S: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.arange(S, dtype=torch.float32, device=self.inv_freq.device)
        freqs = torch.outer(t, self.inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)
        m = rope_mscale(self.cfg)
        return (emb.cos() * m).to(dtype), (emb.sin() * m).to(dtype)

    def forward(self, input_ids):
        c = self.cfg
        x = F.embedding(input_ids, self.embed_tokens.weight).to(c.dtype)
        cos, sin = self.rope(input_ids.shape[1], c.dtype)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.lm_head(self.norm(x))

    def routed_pairs(self) -> torch.Tensor:
        """``[MoE layers, held experts]``: the pairs each held expert
        computed a forward, averaged over the forwards since
        :meth:`reset_routed_pairs` (or since it was built), on the device
        (read it outside the step: reading waits on the card)."""
        return torch.stack([m.routed_pairs.double()
                            / m.routed_steps.clamp(min=1)
                            for m in self.moe])

    def reset_routed_pairs(self) -> None:
        """Start :meth:`routed_pairs`'s average afresh."""
        for m in self.moe:
            m.routed_pairs.zero_()
            m.routed_steps.zero_()

    def aux_loss(self) -> torch.Tensor:
        """The last forward's balance losses, summed (no gradient)."""
        return torch.stack([m.aux_loss for m in self.moe]).sum()


def lm_loss(logits, labels, loss_mask, mesh=None):
    """This rank's share of the global batch's loss: each token's
    ``fused_softmax_xent`` times its weight in ``loss_mask``, summed over
    the weights of every rank's tokens (at least 1)."""
    dp, _ = _axes(mesh)
    xent = fused_softmax_xent(logits, labels)
    mask = loss_mask.float()
    den = mask.sum()
    if ac.live(dp):
        den = preduce(den, dp)
    return (xent * mask).sum() / torch.clamp_min(den, 1.0)


def init_deepseek(model: DeepseekV2,
                  seed: Union[int, torch.Generator] = 0) -> DeepseekV2:
    """Every matrix normal with std 0.02, every norm's weight 1, in place,
    from one seeded generator on the model's device."""
    g = seed if isinstance(seed, torch.Generator) else None
    with torch.no_grad():
        for name, p in model.named_parameters():
            if g is None:
                g = torch.Generator(device=p.device).manual_seed(int(seed))
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=g)
            else:
                p.fill_(1.0)
    return model


def adamw(params, lr: float = 4.2e-4) -> torch.optim.Optimizer:
    """AdamW after the DeepSeek-V2 paper's pretraining: betas (0.9, 0.95),
    eps 1e-8, weight decay 0.1, no schedule; fused on the card."""
    params = list(params)
    fused = bool(params) and params[0].is_cuda
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=0.1, fused=fused)


def shard_batch(batch: Mapping[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: equal blocks over dp."""
    dp, _ = _axes(mesh)
    return dict(batch) if dp is None else shard_rows(batch, dp)


def make_deepseek_train_step(model: DeepseekV2, mesh=None):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: the
    forward on this rank's rows, :func:`lm_loss` over the global batch plus
    the balance losses (the returned ``loss``, detached), the gradient
    summed over dp (bucketed), one optimizer step, in place, each phase in
    its span (:func:`~horovod_tpu_torch.profiling.train_step`). ``batch``
    holds ``input_ids``, ``labels`` (each position's target) and
    ``loss_mask``. ``model`` must be built with ``mesh``."""
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError(f"the model was built with the mesh {model.mesh} "
                         f"and the step with {mesh}: build both with one")
    dp, _ = _axes(mesh)
    axes = [dp] if dp is not None else []

    def one_step(model, optimizer, batch):
        optimizer.zero_grad(set_to_none=True)

        def forward():
            logits = model(batch["input_ids"])
            lm = lm_loss(logits, batch["labels"], batch["loss_mask"], mesh)
            return lm, lm.detach() + model.aux_loss()

        loss = train_step(forward, lambda: sync_grads(model, axes),
                          optimizer.step)
        return model, optimizer, loss

    return one_step
