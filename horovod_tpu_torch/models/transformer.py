"""Flagship model: a GPT-style (optionally MoE) transformer LM with tied
embedding logits, over the dp, tp, sp and ep axes of a process mesh.

Mirrors ``horovod_tpu/models/transformer.py``: ``TransformerConfig``,
``init_params`` (same numpy draw order and ``[pp, L/pp, ...]`` layout,
here with pp = 1, so both packages give bit-identical arrays for a seed),
``param_shardings``/``shard_params`` (as a per-rank slicer,
:func:`shard_state_dict`), ``_embed_lookup``, ``_sharded_softmax_xent``,
``_softmax_xent``, ``_rmsnorm``, ``_rope``, ``_attention_block``,
``_dense_ffn``, ``_moe_ffn``, ``_block``, ``forward_loss_spmd`` without
pp, ``data_sharding_spec``, ``_grad_sync``, ``make_forward``,
``make_grad_fn``, ``make_train_step`` and ``init_opt_state``.

Each rank holds its shards (:class:`Transformer` built with the mesh):
the vocab rows of the embedding, the heads of ``wq/wk/wv/wo`` and the
columns of ``w1/w2`` over tp, the experts over ep. The batch is split
over ``(dp, ep)`` and the sequence over sp (``shard_batch``). Attention
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
data axes it is replicated over. So a leaf replicated over an axis gets
bit-identical gradients on every rank of it, and a sharded leaf the slice
of the full gradient. The JAX package's gradients are ``dp·ep·sp`` times
that, and partial for the replicated leaves under tp (ROADMAP Queue 3).
pp arrives with the pipeline slice; a mesh with pp > 1 raises.

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
from horovod_tpu_torch.parallel.mesh import data_sharding_spec  # noqa: F401
from horovod_tpu_torch.parallel.moe import moe_layer_spmd
from horovod_tpu_torch.parallel.ring_attention import ring_attention_spmd

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
    dtype: torch.dtype = torch.bfloat16        # compute
    param_dtype: torch.dtype = torch.float32   # storage

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _param_shapes(cfg: TransformerConfig) -> Dict:
    """Full shapes in the JAX package's layout, layers stacked ``[1, L,
    ...]``. The order of ``layers`` is the order ``init_params`` draws
    them in."""
    L, M, HD, F_ = cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    layers = {"ln1": (1, L, M), "wq": (1, L, M, HD), "wk": (1, L, M, HD),
              "wv": (1, L, M, HD), "wo": (1, L, HD, M), "ln2": (1, L, M)}
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update({"router": (1, L, M, E), "we1": (1, L, E, M, F_),
                       "we2": (1, L, E, F_, M)})
    else:
        layers.update({"w1": (1, L, M, F_), "w2": (1, L, F_, M)})
    return {"embed": (cfg.vocab_size, M), "ln_f": (M,), "layers": layers}


# which dims of each leaf are split over which axis (``param_shardings``)
_SPECS = {"embed": {0: "tp"}, "wq": {3: "tp"}, "wk": {3: "tp"},
          "wv": {3: "tp"}, "wo": {2: "tp"}, "w1": {3: "tp"}, "w2": {2: "tp"},
          "we1": {2: "ep", 4: "tp"}, "we2": {2: "ep", 3: "tp"}}


def param_shardings(cfg: TransformerConfig, mesh=None) -> Dict[str, Dict]:
    """``state_dict`` key → ``{dim: axis name}`` of the live axes ``mesh``
    splits that leaf over, as the JAX ``param_shardings`` (vocab rows over
    tp, heads and F columns over tp, experts over ep; the norms and the
    router replicated)."""
    out = {}
    for key in flatten_dotted(_param_shapes(cfg)):
        spec = _SPECS.get(key.split(".")[-1], {})
        out[key] = {d: a for d, a in spec.items()
                    if mesh is not None and mesh.shape[a] > 1}
    return out


def _local_shapes(cfg: TransformerConfig, mesh=None) -> Dict[str, tuple]:
    specs = param_shardings(cfg, mesh)
    out = {}
    for key, shape in flatten_dotted(_param_shapes(cfg)).items():
        shape = list(shape)
        for d, a in specs[key].items():
            n = mesh.shape[a]
            if shape[d] % n:
                raise ValueError(f"{key} dim {d} ({shape[d]}) does not split "
                                 f"over {a}={n}")
            shape[d] //= n
        out[key] = tuple(shape)
    return out


def init_params(rng: np.random.RandomState, cfg: TransformerConfig) -> Dict:
    """Numpy parameters, bit-identical to the JAX package's ``init_params``
    with one stage: norms are ones, each matrix is ``randn * 1/sqrt(fan_in)``
    (``shape[-2]``; the router ``randn * 0.02``) in the order wq, wk, wv,
    wo, then router, we1, we2 or w1, w2, then the embedding is
    ``randn * 0.02``."""
    shapes = _param_shapes(cfg)

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
    ``axis.index`` of each dim ``param_shardings`` splits."""
    specs = param_shardings(cfg, mesh)
    out = {}
    for key, t in full_sd.items():
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
    ``_axis_live``), by name, else None. pp is the next slice."""
    if mesh is None:
        return {a: None for a in ("dp", "ep", "sp", "tp")}
    if mesh.shape["pp"] > 1:
        raise NotImplementedError(
            f"pp={mesh.shape['pp']}: pipeline parallelism arrives with the "
            f"pp slice of the port (parallel/pipeline.py, parallel/plan.py, "
            f"train/pipeline.py, train/autotune.py); this slice runs dp, tp, "
            f"sp and ep")
    return {a: mesh.axis(a) if mesh.shape[a] > 1 else None
            for a in ("dp", "ep", "sp", "tp")}


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
    x = _embed_lookup(emb, tokens, tp)                            # [B,S,M]
    per_layer = {name: p.flatten(0, 1).unbind(0)
                 for name, p in model.layers.items()}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _block({name: ps[i] for name, ps in per_layer.items()}, x,
                      positions, cfg, axes)
        aux = aux + a
    aux = aux / max(cfg.n_layers, 1)
    x = _rmsnorm(x, model.ln_f)
    logits = ac.copy_to(x, tp) @ emb.T                        # [B,S,V/tp]
    loss = _softmax_xent(logits, targets, tp).mean()
    # the layout's loss: every data shard's, averaged (ep subdivides the
    # batch, see data_sharding_spec); each rank's backward is its share
    both = torch.stack([loss, aux.to(loss.dtype)])
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
        _mesh_axes(mesh)
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
    _mesh_axes(mesh)

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
    with a live data axis would average once more, and raises."""
    if model.mesh is not None and any(model.mesh.shape[a] > 1
                                      for a in DATA_AXES):
        raise ValueError(f"lm_loss takes a model without live data axes "
                         f"(its mesh is {model.mesh}); the dp engines "
                         f"average over dp themselves")
    loss, aux = model(*batch)
    return loss + 0.01 * aux


def _grad_sync(named_grads: Mapping[str, torch.Tensor],
               cfg: TransformerConfig, mesh) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the data axes (dp, ep, sp) its leaf is
    replicated over; the axes its own sharding names (ep on the experts)
    keep the shard's gradient, as the JAX ``_grad_sync``. With the loss's
    backward giving each rank its share, the sums are the layout's
    gradient. Per axis, every leaf's reduction is issued before the first
    wait, in one order on every rank."""
    axes = _mesh_axes(mesh)
    specs = param_shardings(cfg, mesh)
    out = dict(named_grads)
    for a in DATA_AXES:
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
    _mesh_axes(mesh)

    def grad_fn(model: Transformer, tokens, targets):
        _check_model(model, cfg, mesh)
        loss, aux = forward_loss_spmd(model, tokens, targets, mesh)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss + 0.01 * aux, params)
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
    donates them). Tokens/targets are this rank's block; loss and aux are
    the layout's. ``scan_steps > 1`` chains that many steps on the SAME
    batch (:func:`scan_util.multi_step`); loss and aux are the last
    step's."""
    _mesh_axes(mesh)

    def one_step(model: Transformer, optimizer, tokens, targets):
        _check_model(model, cfg, mesh)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = forward_loss_spmd(model, tokens, targets, mesh)
        (loss + 0.01 * aux).backward()
        named = {k: p for k, p in model.named_parameters()
                 if p.grad is not None}
        synced = _grad_sync({k: p.grad for k, p in named.items()}, cfg, mesh)
        for k, p in named.items():
            p.grad = synced[k]
        optimizer.step()
        return model, optimizer, loss.detach(), aux.detach()

    return multi_step(one_step, n_carry=2, scan_steps=scan_steps)
