"""Flagship model: a GPT-style (optionally MoE) transformer LM with tied
embedding logits, over the dp, tp, sp and ep axes of a process mesh.

Mirrors ``horovod_tpu/models/transformer.py``: ``TransformerConfig``,
``init_params`` (same numpy draw order and ``[pp, L/pp, ...]`` layout, so
both packages give bit-identical arrays for a seed and a stage count),
``param_shardings``/``shard_params`` (as a per-rank slicer,
:func:`shard_state_dict`), ``_embed_lookup``, ``_sharded_softmax_xent``,
``_softmax_xent``, ``_rmsnorm``, ``_rope``, ``_attention_block``,
``_dense_ffn``, ``_moe_ffn``, ``_block``, ``_stage_fn_factory``,
``forward_loss_spmd``, ``data_sharding_spec``, ``_grad_sync``,
``make_forward``, ``make_grad_fn``, ``make_train_step`` and
``init_opt_state``.

Each rank holds its shards (:class:`Transformer` built with the mesh):
the layers of its pipeline stage (``[pp, L/pp, ...]`` over pp), the vocab
rows of the embedding, the heads of ``wq/wk/wv/wo`` and the columns of
``w1/w2`` over tp, the experts over ep. The batch is split over
``(dp, ep)`` and the sequence over sp (``shard_batch``); pp and tp ranks
take the same block. Under pp the local batch splits into
``cfg.n_microbatches`` microbatches that run GPipe
(:func:`~horovod_tpu_torch.parallel.pipeline.gpipe`): stage 0 does the
embedding lookup, every stage its layers (the MoE aux loss carried beside
the activation), the last stage ``ln_f``, the tied head and the loss,
which :func:`~horovod_tpu_torch.ops.autograd_collectives.replicate_from_stage`
puts on every stage (its backward reaches the last stage once). Attention
takes :func:`~horovod_tpu_torch.parallel.ring_attention.ring_attention_spmd`
under sp and :func:`ops.attention.attend` otherwise, the loss the sharded
xent algebra under tp and :func:`ops.xent.fused_softmax_xent` otherwise:
the port's CUDA kernels on the card. Projections, FFN, experts and the
logits product stay ``torch.matmul``, as the JAX package left them to XLA.

Gradients are the true gradients of the layout's loss, the mean over the
data shards (dp, ep, sp) of each shard's mean token loss plus 0.01 times
the MoE auxiliary loss: tp takes Megatron's "f" (identity forward, psum
backward) where a replicated activation enters a sharded product and "g"
(psum forward, identity backward) where partial sums become replicated;
the loss is averaged over the data axes with a backward that gives each
rank its share, and :func:`_grad_sync` sums each leaf's gradient over the
data axes it is replicated over, and the embedding and ``ln_f`` over pp
(the lookup's part on stage 0, the head's on the last). So a leaf
replicated over an axis gets bit-identical gradients on every rank of it,
and a sharded leaf the slice of the full gradient. The JAX package's
gradients are ``dp·ep·sp`` times that, and partial for the replicated
leaves under tp (ROADMAP Queue 3); its pp gradient is the true one.

State: the JAX package threads a params pytree and an optax state through
pure functions and donates them to each step. Here the parameters live in
a :class:`Transformer` module and the optimizer state in a
``torch.optim`` optimizer, and a train step updates both in place; AdamW
on each rank's shards equals the full AdamW sliced, the update being
elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.tree import flatten_dotted
from horovod_tpu_torch.models.scan_util import multi_step
from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops.attention import attend
from horovod_tpu_torch.ops.mesh_collectives import start_preduce
from horovod_tpu_torch.ops.xent import fused_softmax_xent
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding_spec,
    shard_batch,
)
from horovod_tpu_torch.parallel.moe import moe_layer_spmd
from horovod_tpu_torch.parallel.pipeline import gpipe
from horovod_tpu_torch.parallel.ring_attention import ring_attention_spmd
from horovod_tpu_torch.profiling import train_step

DATA_AXES = ("dp", "ep", "sp")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    n_experts: int = 0          # 0 → dense FFN; >0 → MoE every layer
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    n_microbatches: int = 1     # pipeline microbatches (per pp > 1)
    dtype: torch.dtype = torch.bfloat16        # compute
    param_dtype: torch.dtype = torch.float32   # storage

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _param_shapes(cfg: TransformerConfig, n_stages: int = 1) -> Dict:
    """Full shapes in the JAX package's layout, layers stacked ``[pp,
    L/pp, ...]``. The order of ``layers`` is the order ``init_params``
    draws them in."""
    L, M, HD, F_ = cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    P, L = n_stages, L // n_stages
    layers = {"ln1": (P, L, M), "wq": (P, L, M, HD), "wk": (P, L, M, HD),
              "wv": (P, L, M, HD), "wo": (P, L, HD, M), "ln2": (P, L, M)}
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update({"router": (P, L, M, E), "we1": (P, L, E, M, F_),
                       "we2": (P, L, E, F_, M)})
    else:
        layers.update({"w1": (P, L, M, F_), "w2": (P, L, F_, M)})
    return {"embed": (cfg.vocab_size, M), "ln_f": (M,), "layers": layers}


# which dims of each leaf are split over which axis (``param_shardings``);
# every layer leaf also splits its stage dim 0 over pp
_SPECS = {"embed": {0: "tp"}, "wq": {3: "tp"}, "wk": {3: "tp"},
          "wv": {3: "tp"}, "wo": {2: "tp"}, "w1": {3: "tp"}, "w2": {2: "tp"},
          "we1": {2: "ep", 4: "tp"}, "we2": {2: "ep", 3: "tp"}}


def _stages(mesh) -> int:
    return mesh.shape["pp"] if mesh is not None else 1


def param_shardings(cfg: TransformerConfig, mesh=None) -> Dict[str, Dict]:
    """``state_dict`` key → ``{dim: axis name}`` of the live axes ``mesh``
    splits that leaf over, as the JAX ``param_shardings`` (the layers'
    stage dim over pp, vocab rows over tp, heads and F columns over tp,
    experts over ep; the norms and the router replicated within a
    stage)."""
    out = {}
    for key in flatten_dotted(_param_shapes(cfg)):
        spec = dict(_SPECS.get(key.split(".")[-1], {}))
        if key.startswith("layers."):
            spec = {0: "pp", **spec}
        out[key] = {d: a for d, a in spec.items()
                    if mesh is not None and mesh.shape[a] > 1}
    return out


def _local_shapes(cfg: TransformerConfig, mesh=None) -> Dict[str, tuple]:
    specs = param_shardings(cfg, mesh)
    out = {}
    for key, shape in flatten_dotted(_param_shapes(
            cfg, _stages(mesh))).items():
        shape = list(shape)
        for d, a in specs[key].items():
            n = mesh.shape[a]
            if shape[d] % n:
                raise ValueError(f"{key} dim {d} ({shape[d]}) does not split "
                                 f"over {a}={n}")
            shape[d] //= n
        out[key] = tuple(shape)
    return out


def init_params(rng: np.random.RandomState, cfg: TransformerConfig,
                n_stages: int = 1) -> Dict:
    """Numpy parameters, bit-identical to the JAX package's ``init_params``
    with ``n_stages`` stages (layers ``[n_stages, L/n_stages, ...]``):
    norms are ones, each matrix is ``randn * 1/sqrt(fan_in)`` (``shape[-2]``;
    the router ``randn * 0.02``) in the order wq, wk, wv, wo, then router,
    we1, we2 or w1, w2, then the embedding is ``randn * 0.02``. The draws
    do not depend on ``n_stages``: any layout reshapes to any other."""
    shapes = _param_shapes(cfg, n_stages)

    def w(name, shape):
        if name.startswith("ln"):
            return np.ones(shape, np.float32)
        scale = 0.02 if name == "router" else 1.0 / np.sqrt(shape[-2])
        return (rng.randn(*shape) * scale).astype(np.float32)

    layers = {name: w(name, s) for name, s in shapes["layers"].items()}
    return {
        "embed": (rng.randn(*shapes["embed"]) * 0.02).astype(np.float32),
        "ln_f": np.ones(shapes["ln_f"], np.float32),
        "layers": layers,
    }


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (nested dicts of arrays, as ``init_params`` or
    ``jax.device_get`` give it) → a :class:`Transformer` ``state_dict``,
    keyed by the tree's path joined with dots (``layers.wq``)."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in flatten_dotted(tree).items()}


def shard_state_dict(full_sd: Mapping[str, torch.Tensor],
                     cfg: TransformerConfig, mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of every leaf of a full ``state_dict``: block
    ``axis.index`` of each dim ``param_shardings`` splits. Layer leaves in
    any stage layout (``[s, L/s, ...]``, e.g. ``init_params(rng, cfg)``'s
    ``[1, L, ...]``) are first viewed as the mesh's ``[pp, L/pp, ...]``:
    stage ``i`` holds layers ``i·L/pp`` to ``(i+1)·L/pp − 1``."""
    specs = param_shardings(cfg, mesh)
    shapes = flatten_dotted(_param_shapes(cfg, _stages(mesh)))
    out = {}
    for key, t in full_sd.items():
        if key.startswith("layers.") and tuple(t.shape) != shapes[key]:
            t = t.reshape(shapes[key])
        for d, a in specs[key].items():
            ax = mesh.axis(a)
            n = t.shape[d] // ax.size
            t = t.narrow(d, ax.index * n, n)
        out[key] = t.contiguous()
    return out


def shard_params(params: Mapping, cfg: TransformerConfig, mesh
                 ) -> Dict[str, torch.Tensor]:
    """A JAX-layout numpy tree → this rank's ``state_dict``."""
    return shard_state_dict(from_jax_params(params), cfg, mesh)


def _rmsnorm(x, g):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype) * g.to(x.dtype)


def _rope(x, positions):
    """Rotary embedding on concatenated halves; x [B, S, H, D], positions
    [S] absolute."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (10000 ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[:, None].float() * freqs[None, :]           # [S, half]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _embed_lookup(emb_local, tokens, tp):
    """Vocab-sharded lookup under tp: rows outside this shard masked to
    zero, then summed over tp ("g")."""
    if tp is None:
        return F.embedding(tokens, emb_local)
    Vl = emb_local.shape[0]
    idx = tokens - tp.index * Vl
    ok = (idx >= 0) & (idx < Vl)
    x = torch.where(ok[..., None], F.embedding(idx.clamp(0, Vl - 1),
                                               emb_local),
                    torch.zeros((), dtype=emb_local.dtype,
                                device=emb_local.device))
    return ac.reduce_from(x, tp)


def _sharded_softmax_xent(logits_local, targets, tp):
    """Cross-entropy with the vocab split over tp: logits ``[B, S, V/tp]``
    → ``[B, S]``. The max is a stability shift only, without a gradient
    (it cancels in exact arithmetic)."""
    lf = logits_local.float()
    m = ac.pmax(lf.amax(-1), tp)
    se = ac.reduce_from(torch.exp(lf - m[..., None]).sum(-1), tp)
    Vl = lf.shape[-1]
    idx = targets - tp.index * Vl
    ok = (idx >= 0) & (idx < Vl)
    corr = torch.gather(lf, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
    corr = ac.reduce_from(torch.where(ok, corr, torch.zeros((), device=lf.device)),
                          tp)
    return torch.log(se) + m - corr


def _softmax_xent(logits_local, targets, tp):
    """A tp-split vocab takes the sharded algebra; a full local vocab the
    fused kernel (``xent_fwd`` on the card)."""
    if tp is not None:
        return _sharded_softmax_xent(logits_local, targets, tp)
    return fused_softmax_xent(logits_local, targets)


def _attention_block(p, x, positions, cfg: TransformerConfig, axes):
    """x ``[B', S', M]`` local; ``H/tp`` local heads, the ring under sp."""
    B, S, M = x.shape
    Dh = cfg.head_dim
    tp, sp = axes["tp"], axes["sp"]
    h = ac.copy_to(_rmsnorm(x, p["ln1"]), tp)
    q = (h @ p["wq"].to(h.dtype)).reshape(B, S, -1, Dh)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, S, -1, Dh)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, S, -1, Dh)
    q, k = _rope(q, positions), _rope(k, positions)
    if sp is not None:
        o = ring_attention_spmd(q, k, v, sp, causal=True)
    else:
        o = attend(q, k, v, causal=True)
    o = o.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    return x + ac.reduce_from(o, tp)


def _dense_ffn(p, x, tp):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(ac.copy_to(x, tp) @ p["w1"].to(x.dtype), approximate="tanh")
    return ac.reduce_from(h @ p["w2"].to(x.dtype), tp)


def _moe_ffn(p, x, cfg: TransformerConfig, axes):
    """x ``[B', S', M]`` local → tokens ``[G, M]``, gated with the capacity
    of these G; experts over ep, their inner matrices over tp. Returns the
    output and the aux loss."""
    B, S, M = x.shape
    tp = axes["tp"]

    def expert_fn(ep, t):                       # t [E/ep, N, M]
        h = F.gelu(ac.copy_to(t, tp) @ ep["w1"].to(t.dtype),
                   approximate="tanh")
        return ac.reduce_from(h @ ep["w2"].to(t.dtype), tp)

    y, metrics = moe_layer_spmd(
        x.reshape(-1, M), p["router"].float(), expert_fn,
        {"w1": p["we1"], "w2": p["we2"]}, axis=axes["ep"],
        k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
    return y.reshape(x.shape), metrics.aux_loss


def _block(p, x, positions, cfg: TransformerConfig, axes):
    x = _attention_block(p, x, positions, cfg, axes)
    h = _rmsnorm(x, p["ln2"])
    if cfg.n_experts > 0:
        o, aux = _moe_ffn(p, h, cfg, axes)
    else:
        o = _dense_ffn(p, h, axes["tp"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + o.to(x.dtype), aux


def _mesh_axes(mesh) -> Dict[str, Optional[object]]:
    """The mesh's axes that run collectives (size > 1, as the JAX
    ``_axis_live``), by name, else None."""
    if mesh is None:
        return {a: None for a in ("dp", "pp", "ep", "sp", "tp")}
    return {a: mesh.axis(a) if mesh.shape[a] > 1 else None
            for a in ("dp", "pp", "ep", "sp", "tp")}


def _stage_fn_factory(model: "Transformer", positions, axes):
    """``stage_fn(h, aux, params=...) -> (h, aux)``: this rank's ``L/pp``
    blocks on one microbatch; ``params`` are the layer leaves (``[1, L/pp,
    ...]``, in ``model.layers`` order). The MoE aux loss rides beside the
    activation: each stage adds the sum of its blocks' aux over the
    number of layers, as the JAX ``_stage_fn_factory`` does."""
    cfg = model.cfg
    names = list(model.layers.keys())
    n_local = model.layers[names[0]].shape[1]

    def stage_fn(h, aux, params):
        lp = dict(zip(names, params))
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n_local):
            h, a = _block({n: lp[n][0, i] for n in names}, h, positions, cfg,
                          axes)
            total = total + a
        return h, aux + total / max(cfg.n_layers, 1)

    return stage_fn, [model.layers[n] for n in names]


def _pipelined_layers(model: "Transformer", x, positions, axes, B: int):
    """GPipe over pp: stage 0's embedded ``x [B', S', M]`` in, on the last
    stage ``(h [B', S', M], aux)`` out (aux the mean over microbatches),
    elsewhere a zero pair tied to the pipeline's backward."""
    cfg = model.cfg
    pp = axes["pp"]
    M = cfg.n_microbatches
    if B % M:
        raise ValueError(f"local batch {B} not divisible by "
                         f"n_microbatches={M}")
    stage_fn, params = _stage_fn_factory(model, positions, axes)
    dev = params[0].device
    first = None
    if pp.index == 0:
        first = (x.reshape((M, B // M) + tuple(x.shape[1:])),
                 torch.zeros(M, dtype=torch.float32, device=dev))
    S_, Md = positions.shape[0], cfg.d_model
    spec = [((B // M, S_, Md), cfg.dtype), ((), torch.float32)]
    hs, auxs = gpipe(stage_fn, params, first, pp, M, spec)
    if pp.index == pp.size - 1:
        return hs.reshape((B,) + tuple(hs.shape[2:])), auxs.mean()
    zero = hs.float() * 0 + auxs * 0
    return zero, zero


def forward_loss_spmd(model: "Transformer", tokens: torch.Tensor,
                      targets: torch.Tensor, mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's tokens/targets ``[B', S']`` (block ``sp.index`` of the
    sequence) → the layout's ``(loss, aux)``: each data shard's mean token
    loss and aux loss, averaged over the live data axes."""
    cfg = model.cfg
    axes = _mesh_axes(mesh)
    tp, sp = axes["tp"], axes["sp"]
    S = tokens.shape[1]
    positions = (sp.index * S if sp is not None else 0) + torch.arange(
        S, device=tokens.device)
    emb = model.embed.to(cfg.dtype)
    pp = axes["pp"]
    first = pp is None or pp.index == 0
    last = pp is None or pp.index == pp.size - 1
    x = _embed_lookup(emb, tokens, tp) if first else None         # [B,S,M]
    if pp is not None:
        x, aux = _pipelined_layers(model, x, positions, axes,
                                   tokens.shape[0])
    else:
        per_layer = {name: p.flatten(0, 1).unbind(0)
                     for name, p in model.layers.items()}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x, a = _block({name: ps[i] for name, ps in per_layer.items()}, x,
                          positions, cfg, axes)
            aux = aux + a
        aux = aux / max(cfg.n_layers, 1)
    if last:
        x = _rmsnorm(x, model.ln_f)
        logits = ac.copy_to(x, tp) @ emb.T                    # [B,S,V/tp]
        loss = _softmax_xent(logits, targets, tp).mean()
    else:
        loss = x
    # the layout's loss: the last stage's, on every stage; every data
    # shard's, averaged (ep subdivides the batch, see data_sharding_spec);
    # each rank's backward is its share
    both = torch.stack([loss, aux.to(loss.dtype)])
    if pp is not None:
        both = ac.replicate_from_stage(both, pp, pp.size - 1)
    for a in DATA_AXES:
        both = ac.mean_from(both, axes[a])
    return both[0], both[1]


class Transformer(nn.Module):
    """The flagship's parameters on this rank, ``state_dict`` keys
    ``embed``, ``ln_f`` and ``layers.<name>`` in the JAX layout; with a
    ``mesh``, each leaf is this rank's shard (:func:`shard_state_dict`).
    ``forward`` is the layout's loss.

    ``device=None`` puts it on this process's card and raises when there
    is none; pass ``device="cpu"`` to run on the CPU. The parameters are
    allocated uninitialized: load them, e.g.
    ``model.load_state_dict(shard_params(init_params(rng, cfg), cfg,
    mesh))`` (``from_jax_params`` without a mesh)."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        dev = resolve_device(device)
        shapes = _local_shapes(cfg, mesh)

        def param(key):
            return nn.Parameter(torch.empty(shapes[key], dtype=cfg.param_dtype,
                                            device=dev))

        self.embed = param("embed")
        self.ln_f = param("ln_f")
        self.layers = nn.ParameterDict(
            {name: param(f"layers.{name}")
             for name in _param_shapes(cfg)["layers"]})

    def shard_specs(self) -> Dict[str, Dict]:
        """``state_dict`` key → ``{dim: axis}`` the model's mesh splits it
        over (:func:`param_shardings`): what a checkpoint needs to place
        this rank's blocks in the global leaves."""
        return param_shardings(self.cfg, self.mesh)

    def forward(self, tokens: torch.Tensor, targets: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens/targets ``[B', S']`` → ``(loss, aux)``: the mean token
        cross-entropy and the MoE auxiliary loss (zero for a dense model),
        over the model's mesh."""
        return forward_loss_spmd(self, tokens, targets, self.mesh)


def adamw(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """``optax.adamw(1e-3)`` in torch: lr 1e-3, betas (0.9, 0.999), eps
    1e-8 and weight decay 1e-4 (optax's default; torch's is 1e-2). Fused,
    so the grad guard can skip a step on the device (``found_inf``)."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, fused=True)


def _check_model(model: Transformer, cfg: TransformerConfig, mesh) -> None:
    """The model fits the step: its config, and a mesh of its own (which
    its ``forward`` runs collectives over) is the step's. A model built
    without a mesh holds whole leaves and may run under a data mesh."""
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg} was given a model of "
                         f"{model.cfg}")
    if model.mesh is not None and model.mesh is not mesh:
        raise ValueError(f"the model was built with the mesh {model.mesh} "
                         f"and the step with {mesh}: build both with one")
    want = _local_shapes(cfg, mesh)
    for key, p in model.named_parameters():
        if tuple(p.shape) != want[key]:
            raise ValueError(f"{key} is {tuple(p.shape)} on this rank; the "
                             f"mesh {mesh} gives it {want[key]}: build the "
                             f"model with that mesh")


def make_forward(cfg: TransformerConfig, mesh=None) -> Callable:
    """``fwd(model, tokens, targets) -> loss + 0.01 * aux``, the layout's,
    without gradients; used by :func:`horovod_tpu_torch.entry.entry`."""

    @torch.no_grad()
    def fwd(model: Transformer, tokens, targets):
        _check_model(model, cfg, mesh)
        loss, aux = forward_loss_spmd(model, tokens, targets, mesh)
        return loss + 0.01 * aux

    return fwd


def lm_loss(model: Transformer, batch) -> torch.Tensor:
    """The differentiated objective ``loss + 0.01 * aux`` of a
    ``(tokens, targets)`` batch, the ``loss_fn`` of
    :func:`~horovod_tpu_torch.train.overlap.make_overlap_train_step`,
    whose engines average over dp themselves: a model built with a mesh
    with a live data axis would average once more, and one with pp would
    leave the embedding's stage parts unsummed (the pipeline's step is
    ``make_train_step``, or ``make_pipeline_train_step``); both raise."""
    if model.mesh is not None and any(model.mesh.shape[a] > 1
                                      for a in DATA_AXES + ("pp",)):
        raise ValueError(f"lm_loss takes a model without live data axes "
                         f"and without pp (its mesh is {model.mesh}); the "
                         f"dp engines average over dp themselves")
    loss, aux = model(*batch)
    return loss + 0.01 * aux


def _grad_sync(named_grads: Mapping[str, torch.Tensor],
               cfg: TransformerConfig, mesh) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the data axes (dp, ep, sp) its leaf is
    replicated over; the axes its own sharding names (ep on the experts)
    keep the shard's gradient, as the JAX ``_grad_sync``. With the loss's
    backward giving each rank its share, the sums are the layout's
    gradient. Under pp the leaves every stage holds (the embedding, whose
    lookup is stage 0's and whose tied head is the last stage's, and
    ``ln_f``) are summed over pp too; a stage that did not use one gives
    zeros. Per axis, every leaf's reduction is issued before the first
    wait, in one order on every rank."""
    axes = _mesh_axes(mesh)
    specs = param_shardings(cfg, mesh)
    out = dict(named_grads)
    for a in DATA_AXES + ("pp",):
        if axes[a] is None:
            continue
        keys = [k for k in out if a not in specs[k].values()]
        pending = [start_preduce(out[k], axes[a]) for k in keys]
        out.update(zip(keys, (p.wait() for p in pending)))
    return out


def make_grad_fn(cfg: TransformerConfig, mesh=None) -> Callable:
    """``grad_fn(model, tokens, targets) -> (loss, aux, grads)``, with
    ``grads`` keyed like the model's ``state_dict``: this rank's slice of
    the gradient of the layout's ``loss + 0.01 * aux``. Tokens/targets are
    this rank's block (``shard_batch``); loss and aux come back as the
    layout's, equal on every rank."""

    def grad_fn(model: Transformer, tokens, targets):
        _check_model(model, cfg, mesh)
        loss, aux = forward_loss_spmd(model, tokens, targets, mesh)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss + 0.01 * aux, params,
                                    allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, params)]
        grads = _grad_sync(dict(zip(names, grads)), cfg, mesh)
        return loss.detach(), aux.detach(), grads

    return grad_fn


def init_opt_state(optimizer_factory: Callable, model: Transformer
                   ) -> torch.optim.Optimizer:
    """The optimizer over the model's parameters. A torch optimizer is the
    optax transformation and its state in one object, so the factory (e.g.
    :func:`adamw`) is given here rather than to :func:`make_train_step`."""
    return optimizer_factory(model.parameters())


def make_train_step(cfg: TransformerConfig, mesh=None,
                    scan_steps: int = 1) -> Callable:
    """``step(model, optimizer, tokens, targets) -> (model, optimizer,
    loss, aux)``: forward, backward, the gradient sync of
    :func:`_grad_sync` and one optimizer step on this rank's shards,
    updating the parameters and the optimizer state in place (the JAX step
    donates them), each phase in its span (:func:`~horovod_tpu_torch.
    profiling.train_step`). Tokens/targets are this rank's block; loss and
    aux are the layout's. ``scan_steps > 1`` chains that many steps on the SAME
    batch (:func:`scan_util.multi_step`); loss and aux are the last
    step's."""
    pipelined = _stages(mesh) > 1

    def one_step(model: Transformer, optimizer, tokens, targets):
        _check_model(model, cfg, mesh)
        optimizer.zero_grad(set_to_none=True)

        def forward():
            loss, aux = forward_loss_spmd(model, tokens, targets, mesh)
            return loss + 0.01 * aux, (loss, aux)

        def sync():
            if pipelined:
                # a stage that did not use a leaf (ln_f before the last)
                # still takes part in its sum over pp
                for p in model.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            named = {k: p for k, p in model.named_parameters()
                     if p.grad is not None}
            synced = _grad_sync({k: p.grad for k, p in named.items()}, cfg,
                                mesh)
            for k, p in named.items():
                p.grad = synced[k]

        loss, aux = train_step(forward, sync, optimizer.step)
        return model, optimizer, loss.detach(), aux.detach()

    return multi_step(one_step, n_carry=2, scan_steps=scan_steps)


# ---------------------------------------------------------------------------
# Generative decode: KV-cache forward over the serving engine's paged pool
# ---------------------------------------------------------------------------
# The serving engine (horovod_tpu_torch/serving/generate/) runs the weights
# the training step produced at token granularity: one fixed-shape decode
# step over a static slot array, K/V history in block-granular pages. All
# of it is single-device fp32 math in plain torch, as the JAX package's
# (``horovod_tpu/models/transformer.py:482-684``, XLA code, no Pallas
# kernel): greedy decode is held bit for bit across batching and paging.
# Layout:
#
#   k_pages / v_pages  [L, total_pages + 1, page_tokens, H*Dh]
#       (+1 = the scratch page that inactive and padded lanes write into,
#       so membership churn never changes a shape)
#   page_table         [slots, pages_per_slot] — a slot's j-th page holds
#       its token positions [j*page_tokens, (j+1)*page_tokens); gathered
#       back, position p of a slot lands at flat index p.
#
# Every function here runs without a host synchronization and with shapes
# fixed by its inputs, so the engine can capture it once in a CUDA graph:
# the pools are written in place (``index_put_``), index tensors are
# device tensors (``pos0``/``valid`` 0-d), and lookups are
# ``index_select``s.

def kv_cache_spec(cfg: TransformerConfig) -> Tuple[int, int, torch.dtype]:
    """(n_layers, per-token K width, cache dtype): the model fingerprint
    the page planner sizes pages from."""
    return cfg.n_layers, cfg.n_heads * cfg.head_dim, torch.float32


def flatten_decode_params(params) -> Dict:
    """``{"embed", "ln_f", "layers": {name: [L, ...]}}`` from a
    :class:`Transformer`, its ``state_dict`` (``layers.wq`` keys) or a
    nested parameter tree (numpy or torch): the stacked-stage layout
    ``[pp, L/pp, ...]`` collapsed to ``[L, ...]`` (decode runs every layer
    on one device). Leaves stay where they are; numpy leaves become CPU
    tensors. Refuses MoE, as the JAX function does."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    flat = flatten_dotted(params)
    layers = {k[len("layers."):]: v for k, v in flat.items()
              if k.startswith("layers.")}
    if "w1" not in layers:
        raise NotImplementedError(
            "paged decode supports dense-FFN transformers (n_experts=0)")

    def t(v):
        return v.detach() if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.array(v))

    return {"embed": t(flat["embed"]), "ln_f": t(flat["ln_f"]),
            "layers": {k: t(v).reshape((-1,) + tuple(v.shape[2:]))
                       for k, v in layers.items()}}


def _rope_rows(x, pos):
    """Rotary embedding at per-row positions: x [N, H, D], pos [N] — the
    decode-time counterpart of :func:`_rope` (one token a row, each at its
    own absolute position)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000 ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos[:, None].float() * freqs[None, :]                # [N, half]
    cos = torch.cos(ang)[:, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _paged_layer(lp, x, q_pos, kv_pages, dest_page, offs, gather_rows,
                 key_mask, cfg: TransformerConfig):
    """One block over paged KV: write this call's K/V into the layer's
    pool pages (in place), gather the history back, attend, FFN.

    x [N, M] (N = slots for decode, chunk for prefill); ``dest_page``/
    ``offs`` [N] address each row's write; ``gather_rows`` indexes the
    pages to read back ([N, P] per row for decode, [P] shared for
    prefill); ``key_mask`` [N, T] marks the attended positions. Returns
    the block's output; the pools ``kv_pages`` (one layer's
    ``[total_pages + 1, page_tokens, H*Dh]``) are updated in place."""
    kp, vp = kv_pages
    H, Dh = cfg.n_heads, cfg.head_dim
    N = x.shape[0]
    h = _rmsnorm(x, lp["ln1"].float())
    q = _rope_rows((h @ lp["wq"].float()).reshape(N, H, Dh), q_pos)
    k = _rope_rows((h @ lp["wk"].float()).reshape(N, H, Dh), q_pos)
    v = h @ lp["wv"].float()
    kp.index_put_((dest_page, offs), k.reshape(N, H * Dh))
    vp.index_put_((dest_page, offs), v)
    k_all = kp[gather_rows].reshape(gather_rows.shape[:-1] + (-1, H, Dh))
    v_all = vp[gather_rows].reshape(gather_rows.shape[:-1] + (-1, H, Dh))
    if k_all.dim() == 3:          # shared gather (prefill): [T, H, Dh]
        scores = torch.einsum("nhd,thd->nht", q, k_all)
    else:                         # per-row gather (decode): [N, T, H, Dh]
        scores = torch.einsum("nhd,nthd->nht", q, k_all)
    # Python scalars: a device tensor made from a host number would be a
    # host-to-device copy, which a CUDA graph capture refuses
    scores = scores / float(np.sqrt(Dh).astype(np.float32))
    scores = torch.where(key_mask[:, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if k_all.dim() == 3:
        o = torch.einsum("nht,thd->nhd", probs, v_all)
    else:
        o = torch.einsum("nht,nthd->nhd", probs, v_all)
    x = x + o.reshape(N, H * Dh) @ lp["wo"].float()
    h2 = _rmsnorm(x, lp["ln2"].float())
    f = F.gelu(h2 @ lp["w1"].float(), approximate="tanh")
    return x + f @ lp["w2"].float()


def _layer(params: Dict, li: int) -> Dict:
    return {k: v[li] for k, v in params["layers"].items()}


def decode_step_paged(params: Dict, k_pages, v_pages, page_table, lengths,
                      last_token, active, cfg: TransformerConfig):
    """ONE decode step for every slot at once: the function the engine
    captures once, whatever joins or leaves between calls.

    ``params`` as :func:`flatten_decode_params` gives them; page_table
    [S, P], lengths/last_token [S] (integer), active [S] bool. Each active
    slot embeds its last token, appends its K/V at position
    ``lengths[s]``, attends over its own gathered history, and emits the
    greedy next token. Inactive slots compute masked garbage into the
    scratch page: their lanes exist only to keep the shapes constant.
    Returns ``(next_token [S] int32, k_pages, v_pages)``, the pools
    updated in place."""
    pt = k_pages.shape[2]
    scratch = k_pages.shape[1] - 1
    page_table = page_table.long()
    lengths = lengths.long()
    emb = params["embed"].float()
    x = emb.index_select(0, last_token.long())               # [S, M]
    page_idx = torch.clamp(lengths // pt, 0, page_table.shape[1] - 1)
    dest = torch.gather(page_table, 1, page_idx[:, None])[:, 0]
    dest = torch.where(active, dest, torch.full_like(dest, scratch))
    offs = lengths % pt
    T = page_table.shape[1] * pt
    key_mask = (torch.arange(T, device=lengths.device)[None, :]
                <= lengths[:, None])                          # incl. new token
    for li in range(k_pages.shape[0]):
        x = _paged_layer(_layer(params, li), x, lengths,
                         (k_pages[li], v_pages[li]), dest, offs, page_table,
                         key_mask, cfg)
    x = _rmsnorm(x, params["ln_f"].float())
    logits = x @ emb.T                                        # [S, V]
    return torch.argmax(logits, dim=-1).to(torch.int32), k_pages, v_pages


def prefill_chunk_paged(params: Dict, k_pages, v_pages, page_row, tokens,
                        pos0, valid, cfg: TransformerConfig):
    """Prefill ONE ``chunk``-token slice of ONE slot's prompt (a fixed
    chunk shape: the last chunk arrives padded, ``valid`` counting its
    real tokens). Writes the chunk's K/V into the slot's pages and returns
    the greedy next token after the last VALID position — the first
    generated token once the final chunk lands. ``pos0`` and ``valid`` are
    integers or 0-d tensors. Returns ``(next_token 0-d int32, k_pages,
    v_pages)``, the pools updated in place."""
    C = tokens.shape[0]
    pt = k_pages.shape[2]
    scratch = k_pages.shape[1] - 1
    dev = tokens.device
    page_row = page_row.long()
    pos0 = torch.as_tensor(pos0, device=dev).long()
    valid = torch.as_tensor(valid, device=dev).long()
    emb = params["embed"].float()
    x = emb.index_select(0, tokens.long())                    # [C, M]
    ar = torch.arange(C, device=dev)
    pos = pos0 + ar
    live = ar < valid
    dest = page_row.index_select(
        0, torch.clamp(pos // pt, 0, page_row.shape[0] - 1))
    dest = torch.where(live, dest, torch.full_like(dest, scratch))
    offs = pos % pt
    T = page_row.shape[0] * pt
    # causal within the chunk AND over every earlier chunk's positions
    key_mask = torch.arange(T, device=dev)[None, :] <= pos[:, None]
    for li in range(k_pages.shape[0]):
        x = _paged_layer(_layer(params, li), x, pos,
                         (k_pages[li], v_pages[li]), dest, offs, page_row,
                         key_mask, cfg)
    x = _rmsnorm(x, params["ln_f"].float())
    x_last = x.index_select(0, torch.clamp(valid - 1, 0, C - 1).reshape(1))
    logits = x_last[0] @ emb.T                                # [V]
    return torch.argmax(logits).to(torch.int32), k_pages, v_pages


@torch.no_grad()
def reference_greedy_decode(params, cfg: TransformerConfig, prompt,
                            max_new: int, device=None,
                            return_margins: bool = False):
    """Sequential non-paged oracle: recompute full-history attention for
    every emitted token (no cache, no paging, no batching). Slow on
    purpose: the ground truth the paged continuous engine must match token
    for token. ``params`` as :func:`flatten_decode_params` takes them; the
    math runs on ``device`` (default: where the weights are).

    ``return_margins=True`` returns ``(tokens, margins)`` with one
    ``(top1 - top2 logit, max |logit|)`` pair a step: where the margin is
    a rounding's width, another summation order may pick the other token
    (a near tie)."""
    flat = flatten_decode_params(params)
    dev = torch.device(device) if device is not None \
        else flat["embed"].device
    flat = {"embed": flat["embed"].to(dev), "ln_f": flat["ln_f"].to(dev),
            "layers": {k: v.to(dev) for k, v in flat["layers"].items()}}
    H, Dh, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
    out, margins = [], []
    emb = flat["embed"].float()
    scale = float(np.sqrt(Dh).astype(np.float32))
    for _ in range(int(max_new)):
        ids = torch.tensor(toks, dtype=torch.long, device=dev)
        Tn = ids.shape[0]
        x = emb.index_select(0, ids)
        pos = torch.arange(Tn, device=dev)
        for li in range(L):
            lp = _layer(flat, li)
            h = _rmsnorm(x, lp["ln1"].float())
            q = _rope_rows((h @ lp["wq"].float()).reshape(Tn, H, Dh), pos)
            k = _rope_rows((h @ lp["wk"].float()).reshape(Tn, H, Dh), pos)
            v = (h @ lp["wv"].float()).reshape(Tn, H, Dh)
            scores = torch.einsum("qhd,khd->hqk", q, k) / scale
            mask = pos[None, :] <= pos[:, None]
            scores = torch.where(mask[None, :, :], scores, -1e30)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("hqk,khd->qhd", probs, v).reshape(Tn, H * Dh)
            x = x + o @ lp["wo"].float()
            h2 = _rmsnorm(x, lp["ln2"].float())
            f = F.gelu(h2 @ lp["w1"].float(), approximate="tanh")
            x = x + f @ lp["w2"].float()
        x = _rmsnorm(x, flat["ln_f"].float())
        logits = x[-1] @ emb.T
        nxt = int(torch.argmax(logits))
        if return_margins:
            top = torch.topk(logits, 2).values
            margins.append((float(top[0] - top[1]),
                            float(logits.abs().max())))
        out.append(nxt)
        toks.append(nxt)
    return (out, margins) if return_margins else out
