"""Flagship model, dense and on one device: a GPT-style transformer LM with
tied embedding logits.

Mirrors ``horovod_tpu/models/transformer.py``: ``TransformerConfig``,
``init_params`` (same numpy draw order and ``[pp, L/pp, ...]`` layout,
here with pp = 1, so both packages give bit-identical arrays for a seed),
``_rmsnorm``, ``_rope``, ``_attention_block``, ``_dense_ffn``, ``_block``,
``forward_loss_spmd`` without pp/tp/sp/ep (:meth:`Transformer.forward`),
``make_forward``, ``make_grad_fn``, ``make_train_step`` and
``init_opt_state``. ``make_grad_fn``/``make_train_step`` take a data-
parallel mesh: each rank runs its rows of the global batch
(:func:`~horovod_tpu_torch.parallel.mesh.shard_batch`), the loss is
averaged over dp, and the gradients are the full-batch mean, the average
over dp of every rank's local-mean gradient (the JAX step ``psum``s
gradients of a dp-``pmean``'d loss, which gives dp times that; ROADMAP
Queue 3). The other parallel axes and MoE arrive with later slices of the
port; a mesh with tp, sp, ep or pp > 1, or ``n_experts > 0``, raises.

Attention goes through :func:`ops.attention.attend` and the loss through
:func:`ops.xent.fused_softmax_xent`, i.e. through the port's CUDA kernels
on the card. The projections, the FFN and the logits product stay
``torch.matmul``, as the JAX package left them to XLA.

State: the JAX package threads a params pytree and an optax state through
pure functions and donates them to each step. Here the parameters live in
a :class:`Transformer` module and the optimizer state in a
``torch.optim`` optimizer, and a train step updates both in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.tree import flatten_dotted
from horovod_tpu_torch.models.scan_util import multi_step
from horovod_tpu_torch.ops.attention import attend
from horovod_tpu_torch.ops.mesh_collectives import start_preduce
from horovod_tpu_torch.ops.reduce_op import Average
from horovod_tpu_torch.ops.xent import fused_softmax_xent


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    n_experts: int = 0          # 0 → dense FFN; MoE is a later slice
    dtype: torch.dtype = torch.bfloat16        # compute
    param_dtype: torch.dtype = torch.float32   # storage

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _param_shapes(cfg: TransformerConfig) -> Dict:
    """Shapes in the JAX package's layout, layers stacked ``[1, L, ...]``.
    The order of ``layers`` is the order ``init_params`` draws them in."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "horovod_tpu_torch ports the dense transformer; MoE (n_experts "
            "> 0) arrives with the expert-parallel slice")
    L, M, HD, F_ = cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    layers = {
        "ln1": (1, L, M),
        "wq": (1, L, M, HD),
        "wk": (1, L, M, HD),
        "wv": (1, L, M, HD),
        "wo": (1, L, HD, M),
        "ln2": (1, L, M),
        "w1": (1, L, M, F_),
        "w2": (1, L, F_, M),
    }
    return {"embed": (cfg.vocab_size, M), "ln_f": (M,), "layers": layers}


def init_params(rng: np.random.RandomState, cfg: TransformerConfig) -> Dict:
    """Numpy parameters, bit-identical to the JAX package's ``init_params``
    with one stage: norms are ones, each matrix is ``randn * 1/sqrt(fan_in)``
    (``shape[-2]``) in the order wq, wk, wv, wo, w1, w2, then the embedding
    is ``randn * 0.02``."""
    shapes = _param_shapes(cfg)

    def w(*shape):
        return (rng.randn(*shape) * (1.0 / np.sqrt(shape[-2]))).astype(np.float32)

    layers = {name: (np.ones(s, np.float32) if name.startswith("ln") else w(*s))
              for name, s in shapes["layers"].items()}
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


def _attention_block(p, x, positions, cfg: TransformerConfig):
    B, S, M = x.shape
    Dh = cfg.head_dim
    h = _rmsnorm(x, p["ln1"])
    q = (h @ p["wq"].to(h.dtype)).reshape(B, S, -1, Dh)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, S, -1, Dh)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, S, -1, Dh)
    q, k = _rope(q, positions), _rope(k, positions)
    o = attend(q, k, v, causal=True)
    return x + o.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def _dense_ffn(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w1"].to(x.dtype), approximate="tanh")
    return h @ p["w2"].to(x.dtype)


def _block(p, x, positions, cfg: TransformerConfig):
    x = _attention_block(p, x, positions, cfg)
    return x + _dense_ffn(p, _rmsnorm(x, p["ln2"])).to(x.dtype)


class Transformer(nn.Module):
    """The flagship's parameters, ``state_dict`` keys ``embed``, ``ln_f``
    and ``layers.<name>`` in the JAX layout; ``forward`` is the loss.

    ``device=None`` puts it on this process's card and raises when there
    is none; pass ``device="cpu"`` to run on the CPU. The parameters are
    allocated uninitialized: load them, e.g.
    ``model.load_state_dict(from_jax_params(init_params(rng, cfg)))``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        shapes = _param_shapes(cfg)

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                            device=dev))

        self.embed = param(shapes["embed"])
        self.ln_f = param(shapes["ln_f"])
        self.layers = nn.ParameterDict(
            {name: param(s) for name, s in shapes["layers"].items()})

    def forward(self, tokens: torch.Tensor, targets: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens/targets ``[B, S]`` → ``(loss, aux)``: the mean token
        cross-entropy and the MoE auxiliary loss, zero for a dense model."""
        cfg = self.cfg
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        emb = self.embed.to(cfg.dtype)
        x = F.embedding(tokens, emb)                              # [B, S, M]
        per_layer = {name: p.flatten(0, 1).unbind(0)
                     for name, p in self.layers.items()}
        for i in range(cfg.n_layers):
            x = _block({name: ps[i] for name, ps in per_layer.items()}, x,
                       positions, cfg)
        x = _rmsnorm(x, self.ln_f)
        logits = x @ emb.T                                        # [B, S, V]
        loss = fused_softmax_xent(logits, targets).mean()
        return loss, torch.zeros((), dtype=torch.float32, device=loss.device)


def adamw(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """``optax.adamw(1e-3)`` in torch: lr 1e-3, betas (0.9, 0.999), eps
    1e-8 and weight decay 1e-4 (optax's default; torch's is 1e-2)."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _check_cfg(model: Transformer, cfg: TransformerConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg} was given a model of "
                         f"{model.cfg}")


def make_forward(cfg: TransformerConfig) -> Callable:
    """``fwd(model, tokens, targets) -> loss + 0.01 * aux``, without
    gradients; used by :func:`horovod_tpu_torch.entry.entry`."""
    @torch.no_grad()
    def fwd(model: Transformer, tokens, targets):
        _check_cfg(model, cfg)
        loss, aux = model(tokens, targets)
        return loss + 0.01 * aux

    return fwd


def lm_loss(model: Transformer, batch) -> torch.Tensor:
    """The differentiated objective ``loss + 0.01 * aux`` of a
    ``(tokens, targets)`` batch, the ``loss_fn`` of
    :func:`~horovod_tpu_torch.train.overlap.make_overlap_train_step`."""
    loss, aux = model(*batch)
    return loss + 0.01 * aux


def _dp_axis(mesh):
    """The mesh's dp axis when it runs collectives (size > 1, as the JAX
    ``_psum_if``), else None; the other axes are later slices."""
    if mesh is None:
        return None
    for a in ("pp", "ep", "sp", "tp"):
        if mesh.shape[a] > 1:
            raise NotImplementedError(
                f"the port's transformer is data-parallel so far; {a}="
                f"{mesh.shape[a]} arrives with the slice that ports it")
    return mesh.axis("dp") if mesh.shape["dp"] > 1 else None


def _dp_average(tensors, axis):
    """Each tensor averaged over ``axis``, all issued before the first
    wait."""
    pending = [start_preduce(t, axis, Average) for t in tensors]
    return [p.wait() for p in pending]


def make_grad_fn(cfg: TransformerConfig, mesh=None) -> Callable:
    """``grad_fn(model, tokens, targets) -> (loss, aux, grads)``, with
    ``grads`` keyed like the model's ``state_dict``. Over a dp mesh,
    tokens/targets are this rank's rows, and loss, aux and grads come back
    averaged over dp (the full-batch values)."""
    dp = _dp_axis(mesh)

    def grad_fn(model: Transformer, tokens, targets):
        _check_cfg(model, cfg)
        loss, aux = model(tokens, targets)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss + 0.01 * aux, params)
        loss, aux = loss.detach(), aux.detach()
        if dp is not None:
            loss, aux, *grads = _dp_average([loss, aux, *grads], dp)
        return loss, aux, dict(zip(names, grads))

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
    loss, aux)``: forward, backward and one optimizer step, updating the
    parameters and the optimizer state in place (the JAX step donates
    them). Over a dp mesh, tokens/targets are this rank's rows; every
    gradient is averaged over dp before the step (each issued as soon as
    backward is done, all waited on before the optimizer reads them), and
    loss and aux are the dp averages. ``scan_steps > 1`` chains that many
    steps on the SAME batch (:func:`scan_util.multi_step`); loss and aux
    are the last step's."""
    dp = _dp_axis(mesh)

    def one_step(model: Transformer, optimizer, tokens, targets):
        _check_cfg(model, cfg)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = model(tokens, targets)
        (loss + 0.01 * aux).backward()
        loss, aux = loss.detach(), aux.detach()
        if dp is not None:
            params = [p for p in model.parameters() if p.grad is not None]
            loss, aux, *grads = _dp_average(
                [loss, aux, *(p.grad for p in params)], dp)
            for p, g in zip(params, grads):
                p.grad = g
        optimizer.step()
        return model, optimizer, loss, aux

    return multi_step(one_step, n_carry=2, scan_steps=scan_steps)
