"""BERT-Large, the second headline benchmark family: an encoder with an
MLM head tied to the word embeddings and an NSP head on ``[CLS]``.

Mirrors ``horovod_tpu/models/bert.py``: ``BertConfig``, ``bert_large``,
``bert_base``, ``SelfAttention``, ``BertLayer``, ``Bert``,
``pretrain_loss``, ``make_bert_train_step`` and ``init_bert``, with the
flax names (:mod:`horovod_tpu_torch.models._flax`; ``DenseGeneral``
kernels flattened to 2-D ``[out, in]``) and flax's numerics where plain
torch differs: LayerNorm epsilon 1e-6, in fp32 and returning fp32 (so the
residual sums are fp32); ``nn.gelu`` is the tanh approximation; the score
scale is ``sqrt(head_dim)`` in the compute dtype; masked scores are −1e9
before an fp32 softmax; the MLM logits come from the tied embedding in
the compute dtype, then fp32; the NSP head is fp32. Attention is the JAX
code's einsum and softmax in plain torch (the JAX package runs no Pallas
kernel for it, and the port's flash kernel takes no key-padding mask).

The tp axis (flax partitioning ``(None, "tp", None)`` and related, which
the JAX package leaves to GSPMD): the heads of q/k/v and the rows of
``out``, the columns of ``ffn_in`` and the rows of ``ffn_out``, and the
vocabulary of ``word_embeddings`` (with its tied logits) split over tp,
with Megatron's "f"/"g" (:mod:`~horovod_tpu_torch.ops.autograd_collectives`),
the vocab-parallel lookup and the sharded cross-entropy. A vocabulary that
tp does not divide (30522 at tp = 4) is padded to the next multiple, as
GSPMD pads it; the pad rows are zero and their logits are masked out of
the loss. The batch's rows split over dp (``shard_batch``; the JAX
``batch_sharding``); tp ranks take the same rows. The gradient is the true
one of the global loss: each rank's backward gives its share, the
gradients are summed over dp, and under tp the replicated leaves' come
out whole on every rank (ROADMAP Queue 3 item 6 is the JAX flagship's
fault, not GSPMD's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models._flax import (Dense, Embed, LayerNorm,
                                            from_flax,  # noqa: F401
                                            init_state, sync_grads)
from horovod_tpu_torch.models.scan_util import multi_step
from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops.mesh_collectives import preduce
from horovod_tpu_torch.parallel.mesh import shard_rows
from horovod_tpu_torch.profiling import train_step


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024          # BERT-Large
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 512
    type_vocab_size: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_large(dtype=torch.bfloat16) -> BertConfig:
    return BertConfig(dtype=dtype)


def bert_base(dtype=torch.bfloat16) -> BertConfig:
    return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                      intermediate_size=3072, dtype=dtype)


def _tp_axis(mesh):
    """The mesh's tp axis when live; BERT runs over dp and tp only."""
    if mesh is None:
        return None
    other = [a for a in ("pp", "sp", "ep") if mesh.shape[a] > 1]
    if other:
        raise ValueError(f"BERT trains over dp and tp only; the mesh {mesh} "
                         f"has {other} live")
    tp = mesh.axis("tp")
    return tp if tp.size > 1 else None


def _tp_size(mesh) -> int:
    tp = _tp_axis(mesh)
    return tp.size if tp is not None else 1


def padded_vocab(cfg: BertConfig, mesh=None) -> int:
    """The vocabulary padded to a multiple of tp (GSPMD's padding)."""
    tp = _tp_size(mesh)
    return -(-cfg.vocab_size // tp) * tp


class SelfAttention(nn.Module):
    """``query``/``key``/``value`` (``[heads·head_dim, hidden]``, this
    rank's heads) and ``out`` (``[hidden, heads·head_dim]``, its columns)."""

    def __init__(self, cfg: BertConfig, tp_size: int = 1, device=None):
        super().__init__()
        self.cfg = cfg
        local = cfg.num_heads // tp_size * cfg.head_dim
        kw = dict(dtype=cfg.dtype, device=device, init_std=0.02)
        self.query = Dense(cfg.hidden_size, local, **kw)
        self.key = Dense(cfg.hidden_size, local, **kw)
        self.value = Dense(cfg.hidden_size, local, **kw)
        self.out = Dense(local, cfg.hidden_size, **kw)

    def forward(self, x, mask, tp=None):
        c = self.cfg
        B, S, _ = x.shape
        h = ac.copy_to(x, tp)
        q, k, v = (m(h).reshape(B, S, -1, c.head_dim)
                   for m in (self.query, self.key, self.value))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
            torch.tensor(float(c.head_dim), dtype=c.dtype, device=x.device))
        s = torch.where(mask[:, None, None, :], s,
                        torch.tensor(-1e9, dtype=s.dtype, device=s.device))
        p = torch.softmax(s.float(), dim=-1).to(c.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, -1)
        if not ac.live(tp):
            return self.out(o)
        return ac.reduce_from(self.out(o, bias=False), tp) \
            + self.out.bias.to(c.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, tp_size: int = 1, device=None):
        super().__init__()
        self.cfg = cfg
        inter = cfg.intermediate_size // tp_size
        kw = dict(dtype=cfg.dtype, device=device, init_std=0.02)
        self.attention = SelfAttention(cfg, tp_size, device)
        self.ln_att = LayerNorm(cfg.hidden_size, device=device)
        self.ffn_in = Dense(cfg.hidden_size, inter, **kw)
        self.ffn_out = Dense(inter, cfg.hidden_size, **kw)
        self.ln_ffn = LayerNorm(cfg.hidden_size, device=device)

    def forward(self, x, mask, tp=None):
        x = self.ln_att(x + self.attention(x, mask, tp))
        h = F.gelu(self.ffn_in(ac.copy_to(x, tp)), approximate="tanh")
        if ac.live(tp):
            h = ac.reduce_from(self.ffn_out(h, bias=False), tp) \
                + self.ffn_out.bias.to(self.cfg.dtype)
        else:
            h = self.ffn_out(h)
        return self.ln_ffn(x + h)


def _embed_lookup(table, ids, tp, dtype):
    """The vocab-sharded lookup under tp: rows outside this shard masked to
    zero, then summed over tp ("g")."""
    if not ac.live(tp):
        return F.embedding(ids, table).to(dtype)
    Vl = table.shape[0]
    idx = ids - tp.index * Vl
    ok = (idx >= 0) & (idx < Vl)
    x = F.embedding(idx.clamp(0, Vl - 1), table).to(dtype)
    return ac.reduce_from(torch.where(ok[..., None], x, torch.zeros_like(x)),
                          tp)


class Bert(nn.Module):
    """``forward(input_ids, token_type_ids, attention_mask) -> (mlm_logits,
    nsp_logits)`` (fp32); under tp the MLM logits are this rank's block of
    the padded vocabulary (``[B, S, padded_vocab / tp]``).

    ``device=None`` puts it on this process's card and raises when there
    is none; with a ``mesh`` each leaf is this rank's tp shard
    (:func:`shard_state_dict`). Parameters are allocated uninitialised:
    :func:`init_bert` draws them, or load a :func:`from_flax` ``state_dict``
    (sliced with :func:`shard_state_dict` under tp)."""

    def __init__(self, cfg: BertConfig, device=None, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.mesh = cfg, mesh
        tp = _tp_size(mesh)
        for what, n in (("num_heads", cfg.num_heads),
                        ("intermediate_size", cfg.intermediate_size)):
            if n % tp:
                raise ValueError(f"{what} {n} does not split over tp={tp}")
        self.word_embeddings = Embed(padded_vocab(cfg, mesh) // tp,
                                     cfg.hidden_size, cfg.dtype, dev, 0.02)
        self.position_embeddings = Embed(cfg.max_position, cfg.hidden_size,
                                         cfg.dtype, dev)
        self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                           cfg.hidden_size, cfg.dtype, dev)
        self.ln_emb = LayerNorm(cfg.hidden_size, device=dev)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, tp, dev))
        self.mlm_transform = Dense(cfg.hidden_size, cfg.hidden_size,
                                   dtype=cfg.dtype, device=dev)
        self.mlm_ln = LayerNorm(cfg.hidden_size, device=dev)
        self.nsp = Dense(cfg.hidden_size, 2, dtype=torch.float32, device=dev)

    def forward(self, input_ids, token_type_ids, attention_mask):
        c = self.cfg
        tp = _tp_axis(self.mesh)
        x = _embed_lookup(self.word_embeddings.embedding, input_ids, tp,
                          c.dtype)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = x + self.position_embeddings(pos)
        x = x + self.token_type_embeddings(token_type_ids)
        x = self.ln_emb(x)
        mask = attention_mask.bool()
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, tp)
        h = self.mlm_ln(F.gelu(self.mlm_transform(x), approximate="tanh"))
        mlm = F.linear(ac.copy_to(h, tp).to(c.dtype),
                       self.word_embeddings.embedding.to(c.dtype)).float()
        return mlm, self.nsp(x[:, 0].float())


# -- sharding ------------------------------------------------------------------

# leaf suffix → the dim tp splits (the flax partitioning of init_bert)
_TP_DIMS = {"word_embeddings.embedding": 0, "attention.query.kernel": 0,
            "attention.query.bias": 0, "attention.key.kernel": 0,
            "attention.key.bias": 0, "attention.value.kernel": 0,
            "attention.value.bias": 0, "attention.out.kernel": 1,
            "ffn_in.kernel": 0, "ffn_in.bias": 0, "ffn_out.kernel": 1}


def tp_split_dim(key: str) -> Optional[int]:
    """The dim of ``state_dict`` leaf ``key`` that tp splits, or None for
    a leaf every tp rank holds whole."""
    return _TP_DIMS.get(key.split(".", 1)[-1] if key.startswith("layer_")
                        else key)


def shard_state_dict(full_sd: Mapping[str, torch.Tensor], cfg: BertConfig,
                     mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of every leaf of a full ``state_dict`` (e.g.
    :func:`from_flax`'s): block ``tp.index`` of each dim tp splits, the
    word embedding first padded with zero rows to :func:`padded_vocab`."""
    tp = _tp_axis(mesh)
    out = {}
    for key, t in full_sd.items():
        if key == "word_embeddings.embedding":
            pad = padded_vocab(cfg, mesh) - t.shape[0]
            t = torch.cat([t, t.new_zeros(pad, t.shape[1])]) if pad else t
        d = tp_split_dim(key)
        if tp is not None and d is not None:
            n = t.shape[d] // tp.size
            t = t.narrow(d, tp.index * n, n)
        out[key] = t.contiguous()
    return out


def shard_batch(batch: Mapping[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: equal blocks over dp (the JAX
    ``batch_sharding``); tp ranks take the same rows."""
    if mesh is None:
        return dict(batch)
    _tp_axis(mesh)
    return shard_rows(batch, mesh.axis("dp"))


# -- loss and step -------------------------------------------------------------

def _mlm_xent(logits, labels, tp, vocab_size):
    """Per-token fp32 cross-entropy; under tp over the vocab shards, the
    pad columns (global index ≥ ``vocab_size``) masked out."""
    lf = logits.float()
    if not ac.live(tp):
        return F.cross_entropy(lf.flatten(0, -2), labels.flatten().long(),
                               reduction="none").view(labels.shape)
    Vl = lf.shape[-1]
    col = tp.index * Vl + torch.arange(Vl, device=lf.device)
    lf = torch.where(col < vocab_size, lf,
                     torch.tensor(float("-inf"), device=lf.device))
    m = ac.pmax(lf.amax(-1), tp)
    se = ac.reduce_from(torch.exp(lf - m[..., None]).sum(-1), tp)
    idx = labels.long() - tp.index * Vl
    ok = (idx >= 0) & (idx < Vl)
    corr = torch.gather(lf, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
    corr = ac.reduce_from(torch.where(ok, corr, torch.zeros_like(corr)), tp)
    return torch.log(se) + m - corr


def pretrain_loss(mlm_logits, nsp_logits, mlm_labels, mlm_mask, nsp_labels,
                  mesh=None, vocab_size: Optional[int] = None):
    """Masked-LM + next-sentence loss over the GLOBAL batch: the MLM loss
    summed over the masked tokens of every rank over their global count
    (at least 1), plus the NSP mean. Each rank's backward gives its share
    of the gradient; the value is the global loss on every rank. Under tp
    pass ``vocab_size`` (the logits are padded shards)."""
    tp = _tp_axis(mesh)
    dp = mesh.axis("dp") if mesh is not None else None
    mlm = _mlm_xent(mlm_logits, mlm_labels, tp,
                    vocab_size or mlm_logits.shape[-1])
    mask = mlm_mask.float()
    den, rows = mask.sum(), torch.tensor(float(nsp_labels.shape[0]),
                                         device=mask.device)
    if ac.live(dp):
        den, rows = preduce(torch.stack([den, rows]), dp)
    share = (mlm * mask).sum() / torch.clamp_min(den, 1.0) \
        + F.cross_entropy(nsp_logits.float(), nsp_labels.long(),
                          reduction="sum") / rows
    return ac.reduce_from(share, dp)


def init_bert(model: Bert, seed: Union[int, torch.Generator] = 0) -> Bert:
    """Draw the parameters (normal 0.02 for the word embedding and the
    tp-split kernels, flax's defaults elsewhere), in place: JAX's shapes,
    not its values. Every tp rank draws the same sequence, so replicated
    leaves agree."""
    return init_state(model, seed)


def adamw(params, lr: float = 1e-4) -> torch.optim.Optimizer:
    """``optax.adamw(lr)`` (bench.py's BERT optimizer at 1e-4): betas (0.9,
    0.999), eps 1e-8, weight decay 1e-4 (torch's default is 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_bert_train_step(model: Bert, mesh=None, scan_steps: int = 1):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: the
    forward on this rank's rows (``shard_batch``), :func:`pretrain_loss`
    over the global batch, the gradient summed over dp (bucketed), one
    optimizer step, in place, each phase in its span
    (:func:`~horovod_tpu_torch.profiling.train_step`). ``batch`` holds
    ``input_ids``, ``token_type_ids``, ``attention_mask``, ``mlm_labels``,
    ``mlm_mask`` and ``nsp_labels``. ``model`` must be built with ``mesh``.
    ``scan_steps > 1`` chains that many steps on the SAME batch."""
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError(f"the model was built with the mesh {model.mesh} "
                         f"and the step with {mesh}: build both with one")
    _tp_axis(mesh)
    axes = [mesh.axis("dp")] if mesh is not None else []

    def one_step(model, optimizer, batch):
        optimizer.zero_grad(set_to_none=True)

        def forward():
            mlm, nsp = model(batch["input_ids"], batch["token_type_ids"],
                             batch["attention_mask"])
            loss = pretrain_loss(mlm, nsp, batch["mlm_labels"],
                                 batch["mlm_mask"], batch["nsp_labels"], mesh,
                                 model.cfg.vocab_size)
            return loss, loss

        loss = train_step(forward, lambda: sync_grads(model, axes),
                          optimizer.step)
        return model, optimizer, loss.detach()

    return multi_step(one_step, n_carry=2, scan_steps=scan_steps)
