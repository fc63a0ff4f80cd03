"""BERT's pretraining step in plain PyTorch, written from Devlin et al.,
"BERT: Pre-training of Deep Bidirectional Transformers for Language
Understanding" (arXiv:1810.04805) and google-research/bert's
``modeling.py`` and ``run_pretraining.py``: word, position and segment
embeddings summed and layer-normalized; post-LN encoder layers
(``x ← LN(x + Attention(x))``, ``x ← LN(x + FFN(x))``, GELU in its tanh
form); a masked-LM head (dense, GELU, LN, then the word embeddings tied as
the output projection) and a next-sentence head on the first token.

The model is a set of functions over a dict of named tensors, so the same
weights can be handed to it and to the program under test. Names follow
the configuration's convention (``layer_<i>.attention.query.kernel``,
``mlm_transform.kernel``, ``nsp.kernel``); dense kernels are
``[out, in]``.

Departures from the published description, each stated by the
configuration file:

* ``hidden_dropout_prob`` and ``attention_probs_dropout_prob`` are 0: the
  benchmark runs no dropout.
* ``layer_norm_eps`` 1e-6 (the published code uses 1e-12).
* ``pooler`` false: the next-sentence classifier reads the first token's
  final hidden state directly (the published head puts a tanh dense
  layer, the pooler, between them).
* ``mlm_output_bias`` false: the tied output projection has no bias.
* The masked-LM loss is the sum over the masked tokens of every row over
  their count in the whole batch (at least 1), plus the next-sentence
  mean: one normalization over the global batch, which is what a
  data-parallel step over several cards computes.

Masked key positions get −10000 added to their scores, as published. The
masked-LM logits are only formed at masked positions, as published; the
loss is the same.

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
    """Every trainable tensor: ``name -> (shape, role)``, in a fixed
    order. Roles: ``embedding``, ``dense``, ``bias``, ``ln_scale``,
    ``ln_bias``."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "word_embeddings.embedding": ((cfg["vocab_size"], H), "embedding"),
        "position_embeddings.embedding":
            ((cfg["max_position_embeddings"], H), "embedding"),
        "token_type_embeddings.embedding":
            ((cfg["type_vocab_size"], H), "embedding")}

    def dense(name, i, o):
        shapes[f"{name}.kernel"] = ((o, i), "dense")
        shapes[f"{name}.bias"] = ((o,), "bias")

    def ln(name):
        shapes[f"{name}.scale"] = ((H,), "ln_scale")
        shapes[f"{name}.bias"] = ((H,), "ln_bias")

    ln("ln_emb")
    for i in range(cfg["num_hidden_layers"]):
        p = f"layer_{i}"
        for m in ("query", "key", "value", "out"):
            dense(f"{p}.attention.{m}", H, H)
        ln(f"{p}.ln_att")
        dense(f"{p}.ffn_in", H, I)
        dense(f"{p}.ffn_out", I, H)
        ln(f"{p}.ln_ffn")
    dense("mlm_transform", H, H)
    ln("mlm_ln")
    dense("nsp", H, 2)
    return shapes


def _dense(x, params, name, mode):
    return result(F.linear(operand(x, mode),
                           operand(params[f"{name}.kernel"], mode)), mode) \
        + params[f"{name}.bias"]


def _ln(x, params, name, cfg):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + cfg["layer_norm_eps"]) \
        * params[f"{name}.scale"] + params[f"{name}.bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))


def _attention(x, keep, params, p, cfg, mode):
    B, S, H = x.shape
    n = cfg["num_attention_heads"]
    d = H // n
    q, k, v = (_dense(x, params, f"{p}.attention.{m}", mode)
               .view(B, S, n, d).transpose(1, 2)
               for m in ("query", "key", "value"))
    s = result(torch.matmul(operand(q, mode),
                            operand(k, mode).transpose(-1, -2)), mode) \
        / math.sqrt(d)
    s = s + (1.0 - keep[:, None, None, :].float()) * -10000.0
    probs = torch.softmax(s, dim=-1)
    o = result(torch.matmul(operand(probs, mode), operand(v, mode)), mode)
    o = o.transpose(1, 2).reshape(B, S, H)
    return _dense(o, params, f"{p}.attention.out", mode)


def encode(params: Tensors, batch: dict, cfg: dict,
           mode: str = "fp32") -> torch.Tensor:
    """The encoder's final hidden states ``[B, S, H]``."""
    ids = batch["input_ids"]
    S = ids.shape[1]
    x = params["word_embeddings.embedding"][ids] \
        + params["position_embeddings.embedding"][:S][None] \
        + params["token_type_embeddings.embedding"][batch["token_type_ids"]]
    x = _ln(x, params, "ln_emb", cfg)
    keep = batch["attention_mask"].bool()
    for i in range(cfg["num_hidden_layers"]):
        p = f"layer_{i}"
        x = _ln(x + _attention(x, keep, params, p, cfg, mode), params,
                f"{p}.ln_att", cfg)
        h = _dense(_gelu(_dense(x, params, f"{p}.ffn_in", mode)), params,
                   f"{p}.ffn_out", mode)
        x = _ln(x + h, params, f"{p}.ln_ffn", cfg)
    return x


def loss_share(params: Tensors, batch: dict, cfg: dict, masked: torch.Tensor,
               rows: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """These rows' share of the batch loss: their masked-LM cross-entropy
    summed over ``masked`` (the masked tokens of the whole batch, at least
    1) plus their next-sentence cross-entropy summed over ``rows``."""
    x = encode(params, batch, cfg, mode)
    sel = batch["mlm_mask"] > 0
    h = _ln(_gelu(_dense(x[sel], params, "mlm_transform", mode)), params,
            "mlm_ln", cfg)
    logits = result(F.linear(operand(h, mode), operand(
        params["word_embeddings.embedding"], mode)), mode)
    mlm = F.cross_entropy(logits, batch["mlm_labels"][sel].long(),
                          reduction="sum")
    nsp = F.cross_entropy(_dense(x[:, 0], params, "nsp", mode),
                          batch["nsp_labels"].long(), reduction="sum")
    return mlm / masked + nsp / rows


def buffer_names(cfg: dict) -> List[str]:
    """BERT keeps no running statistics."""
    return []


def init_buffers(cfg: dict, device) -> Tensors:
    return {}


def grads(params: Tensors, stats: Tensors, batch: dict, cfg: dict,
          mode: str = "fp32", block_rows: int = 16
          ) -> Tuple[float, Tensors]:
    """``(loss, gradient of every parameter)`` over the whole batch, taken
    ``block_rows`` rows at a time (nothing couples the rows but the two
    normalizations, which are taken over the whole batch first);
    ``stats`` is unused (no running statistics)."""
    masked = batch["mlm_mask"].float().sum().clamp_min(1.0)
    rows = torch.tensor(float(batch["nsp_labels"].shape[0]),
                        device=masked.device)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    value = 0.0
    n = batch["input_ids"].shape[0]
    for lo in range(0, n, block_rows):
        part = {k: t[lo:lo + block_rows] for k, t in batch.items()}
        share = loss_share(leaves, part, cfg, masked, rows, mode)
        g = torch.autograd.grad(share, list(leaves.values()),
                                allow_unused=True)
        for k, gk in zip(leaves, g):
            if gk is not None:
                total[k].add_(gk)
        value += float(share.detach())
    return value, total
