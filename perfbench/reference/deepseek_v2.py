"""DeepSeek-V2's language-model step in plain PyTorch, written from
DeepSeek-AI, "DeepSeek-V2: A Strong, Economical, and Efficient
Mixture-of-Experts Language Model" (arXiv:2405.04434) and deepseek-ai's
``modeling_deepseek.py`` for V2: multi-head latent attention (MLA) with YaRN rotary embeddings on a
decoupled key shared by the heads, pre-norm decoder layers, a leading dense
SwiGLU layer and DeepSeekMoE layers after it (shared experts plus routed
experts under a softmax greedy top-k with the sequence-wise balance loss),
an untied output head.

The model is a set of functions over a dict of named tensors, so the same
weights can be handed to it and to the program under test. Names follow
the published checkpoint (``layers.<i>.self_attn.q_proj.weight``,
``layers.<i>.mlp.gate.weight``, ``lm_head.weight``); kernels are ``[out,
in]``. Every operation is float32 (TF32 off, ``common.strict_fp32``);
attention is a materialized softmax, the routed experts a loop over the
experts held, one at a time.

The configuration is one card's share of a deployment that spreads each MoE
layer's routed experts over several cards: ``n_routed_experts`` experts
are held here, from ``first_expert`` on, and the router keeps its published
``router_experts`` outputs and ``num_experts_per_tok`` picks over all of
them. What the experts held elsewhere would add is left out, as the
program leaves it out. The vocabulary is this card's slice.

Departures from the published model, each stated by the configuration
file:

* The routed experts of a layer are stacked: ``layers.<i>.mlp.experts.
  gate_proj`` ``[held, F, M]`` stands for the published per-expert
  ``experts.<e>.gate_proj.weight`` (likewise ``up_proj``, ``down_proj``).
* The balance loss is added to the loss the step reports (the published
  model adds it to the gradient alone, through ``AddAuxiliaryLoss``).
* The loss is each token's cross-entropy weighted by the batch's mask,
  summed over the mask's total in the whole batch: one normalization over
  the global batch, as a data-parallel step computes it.

Routing is per token and dropless, and the balance loss is per row, so
computing the batch a few rows at a time gives the whole batch's loss and
gradient.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.common import operand, result

Tensors = Dict[str, torch.Tensor]


def param_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every trainable tensor: ``name -> (shape, role)``, in a fixed order.
    Roles: ``embedding``, ``dense`` (every matrix) and ``norm``."""
    M, V = cfg["hidden_size"], cfg["vocab_size"]
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "embed_tokens.weight": ((V, M), "embedding")}

    def swiglu(p, inner):
        shapes[f"{p}.gate_proj.weight"] = ((inner, M), "dense")
        shapes[f"{p}.up_proj.weight"] = ((inner, M), "dense")
        shapes[f"{p}.down_proj.weight"] = ((M, inner), "dense")

    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        shapes[f"{p}.input_layernorm.weight"] = ((M,), "norm")
        a = f"{p}.self_attn"
        shapes[f"{a}.q_proj.weight"] = ((H * (dn + dr), M), "dense")
        shapes[f"{a}.kv_a_proj_with_mqa.weight"] = ((R + dr, M), "dense")
        shapes[f"{a}.kv_a_layernorm.weight"] = ((R,), "norm")
        shapes[f"{a}.kv_b_proj.weight"] = ((H * (dn + dv), R), "dense")
        shapes[f"{a}.o_proj.weight"] = ((M, H * dv), "dense")
        shapes[f"{p}.post_attention_layernorm.weight"] = ((M,), "norm")
        if i < cfg["first_k_dense_replace"]:
            swiglu(f"{p}.mlp", cfg["intermediate_size"])
            continue
        F_, n = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
        shapes[f"{p}.mlp.gate.weight"] = ((cfg["router_experts"], M), "dense")
        shapes[f"{p}.mlp.experts.gate_proj"] = ((n, F_, M), "dense")
        shapes[f"{p}.mlp.experts.up_proj"] = ((n, F_, M), "dense")
        shapes[f"{p}.mlp.experts.down_proj"] = ((n, M, F_), "dense")
        swiglu(f"{p}.mlp.shared_experts", F_ * cfg["n_shared_experts"])
    shapes["norm.weight"] = ((M,), "norm")
    shapes["lm_head.weight"] = ((V, M), "dense")
    return shapes


def buffer_names(cfg: dict) -> List[str]:
    """DeepSeek-V2 keeps no running statistics."""
    return []


def init_buffers(cfg: dict, device) -> Tensors:
    return {}


# -- YaRN, written out --------------------------------------------------------

def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    length: int) -> float:
    return dim * math.log(length / (rotations * 2 * math.pi)) \
        / (2 * math.log(base))


def yarn_frequencies(cfg: dict) -> torch.Tensor:
    """The rotary frequencies under YaRN (float32): ``θ^(−2i/d)`` blended
    with the same over the factor by a linear ramp in ``i``, from the
    correction dim of ``beta_fast`` (the published frequency kept below
    it) to that of ``beta_slow`` (divided by the factor above it)."""
    rs = cfg["rope_scaling"]
    d, base, s = cfg["qk_rope_head_dim"], cfg["rope_theta"], rs["factor"]
    length = rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], d, base, length)),
              0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], d, base, length)),
               d - 1)
    if low == high:
        high += 0.001
    i = torch.arange(0, d, 2, dtype=torch.float32)
    extrapolated = 1.0 / base ** (i / d)
    interpolated = 1.0 / (s * base ** (i / d))
    ramp = ((torch.arange(d // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    return interpolated * ramp + extrapolated * (1.0 - ramp)


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def _cos_sin(cfg: dict, S: int, device):
    rs = cfg["rope_scaling"]
    freqs = torch.outer(torch.arange(S, dtype=torch.float32),
                        yarn_frequencies(cfg))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _mscale(rs["factor"], rs["mscale"]) \
        / _mscale(rs["factor"], rs["mscale_all_dim"])
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def _rope(t, cos, sin):
    """``t`` ``[..., S, d]``: its interleaved pairs put in halves, then
    ``t·cos + rotate_half(t)·sin``."""
    d = t.shape[-1]
    t = torch.cat([t[..., 0::2], t[..., 1::2]], dim=-1)
    rot = torch.cat([-t[..., d // 2:], t[..., :d // 2]], dim=-1)
    return t * cos + rot * sin


# -- the layers ---------------------------------------------------------------

def _rms(x, w, cfg):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                           + cfg["rms_norm_eps"]) * w


def _mm(x, w, mode):
    return result(F.linear(operand(x, mode), operand(w, mode)), mode)


def _swiglu(x, gate, up, down, mode):
    return _mm(F.silu(_mm(x, gate, mode)) * _mm(x, up, mode), down, mode)


def _attention(x, params, a, cfg, cos, sin, mode):
    b, S, _ = x.shape
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    q = _mm(x, params[f"{a}.q_proj.weight"], mode).view(b, S, H, dn + dr) \
        .transpose(1, 2)
    ckv = _mm(x, params[f"{a}.kv_a_proj_with_mqa.weight"], mode)
    c, k_pe = ckv[..., :R], ckv[..., R:]
    kv = _mm(_rms(c, params[f"{a}.kv_a_layernorm.weight"], cfg),
             params[f"{a}.kv_b_proj.weight"], mode).view(b, S, H, dn + dv) \
        .transpose(1, 2)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    k_pe = _rope(k_pe[:, None], cos, sin).expand(b, H, S, dr)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    v = kv[..., dn:]
    s = result(torch.matmul(operand(q, mode),
                            operand(k, mode).transpose(-1, -2)), mode) \
        * softmax_scale(cfg)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = result(torch.matmul(operand(torch.softmax(s, dim=-1), mode),
                            operand(v, mode)), mode)
    return _mm(o.transpose(1, 2).reshape(b, S, H * dv),
               params[f"{a}.o_proj.weight"], mode)


def _moe(x, params, p, cfg, rows_total, mode):
    """The held experts' part plus the shared experts, and this block's
    share of the sequence-wise balance loss (its rows over
    ``rows_total``)."""
    b, S, M = x.shape
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    t = x.reshape(b * S, M)
    scores = torch.softmax(t @ params[f"{p}.mlp.gate.weight"].t(), dim=-1)
    weight, index = torch.topk(scores, k, dim=-1)
    weight = weight * cfg["routed_scaling_factor"]
    y = torch.zeros_like(t)
    first = cfg["first_expert"]
    for e in range(cfg["n_routed_experts"]):
        picked = index == first + e                               # [T, k]
        tokens = picked.any(-1).nonzero()[:, 0]
        if tokens.numel() == 0:
            continue
        w = (weight * picked).sum(-1)[tokens]
        out = _swiglu(t[tokens], params[f"{p}.mlp.experts.gate_proj"][e],
                      params[f"{p}.mlp.experts.up_proj"][e],
                      params[f"{p}.mlp.experts.down_proj"][e], mode)
        y = y.index_add(0, tokens, w[:, None] * out)
    s = f"{p}.mlp.shared_experts"
    y = y.view(b, S, M) + _swiglu(x, params[f"{s}.gate_proj.weight"],
                                  params[f"{s}.up_proj.weight"],
                                  params[f"{s}.down_proj.weight"], mode)
    counts = F.one_hot(index.view(b, S * k), E).sum(1).float()   # [b, E]
    ce = counts / (S * k / E)
    aux = (ce * scores.view(b, S, E).mean(1)).sum() / rows_total \
        * cfg["aux_loss_alpha"]
    return y, aux


def loss_share(params: Tensors, batch: dict, cfg: dict, targets: torch.Tensor,
               rows: int, mode: str = "fp32") -> torch.Tensor:
    """These rows' share of the batch loss: their tokens' cross-entropy
    weighted by ``mlm_mask`` and summed over ``targets`` (the mask's total
    over the whole batch, at least 1), plus their share of every layer's
    balance loss (over the batch's ``rows``)."""
    ids = batch["input_ids"]
    S = ids.shape[1]
    cos, sin = _cos_sin(cfg, S, ids.device)
    x = params["embed_tokens.weight"][ids]
    aux = x.new_zeros(())
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        x = x + _attention(_rms(x, params[f"{p}.input_layernorm.weight"],
                                cfg), params, f"{p}.self_attn", cfg, cos, sin,
                           mode)
        h = _rms(x, params[f"{p}.post_attention_layernorm.weight"], cfg)
        if i < cfg["first_k_dense_replace"]:
            x = x + _swiglu(h, params[f"{p}.mlp.gate_proj.weight"],
                            params[f"{p}.mlp.up_proj.weight"],
                            params[f"{p}.mlp.down_proj.weight"], mode)
        else:
            y, a = _moe(h, params, p, cfg, rows, mode)
            x, aux = x + y, aux + a
    logits = _mm(_rms(x, params["norm.weight"], cfg),
                 params["lm_head.weight"], mode)
    xent = F.cross_entropy(logits.flatten(0, 1),
                           batch["mlm_labels"].flatten().long(),
                           reduction="none")
    return (xent * batch["mlm_mask"].flatten().float()).sum() / targets + aux


def grads(params: Tensors, stats: Tensors, batch: dict, cfg: dict,
          mode: str = "fp32", block_rows: int = 1
          ) -> Tuple[float, Tensors]:
    """``(loss, gradient of every parameter)`` over the whole batch, taken
    ``block_rows`` rows at a time (the rows meet only in the two
    normalizations, which are taken over the whole batch first);
    ``stats`` is unused (no running statistics)."""
    targets = batch["mlm_mask"].float().sum().clamp_min(1.0)
    rows = batch["input_ids"].shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    value = 0.0
    for lo in range(0, rows, block_rows):
        part = {k: t[lo:lo + block_rows] for k, t in batch.items()}
        share = loss_share(leaves, part, cfg, targets, rows, mode)
        g = torch.autograd.grad(share, list(leaves.values()),
                                allow_unused=True)
        for k, gk in zip(leaves, g):
            if gk is not None:
                total[k].add_(gk)
        value += float(share.detach())
        del share, g
    return value, total
