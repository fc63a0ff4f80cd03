"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis.

Mirrors ``horovod_tpu/parallel/moe.py``: ``MoEMetrics``, ``top_k_gating``,
``moe_layer_spmd`` and ``moe_layer``. GShard/Switch-style capacity-based
dense dispatch, with the tiled all-to-all over ep exchanging tokens
between expert shards.

Dataflow per ep shard (G local tokens, E global experts, C capacity):
  gates = softmax(router(x))                      [G, E]
  dispatch/combine one-hots via top-k + cumsum    [G, E, C]
  xs = einsum(gm,gec->ecm)(x, dispatch)           [E, C, M]   (fp32)
  xs = all_to_all(ep)                             [E/ep, ep*C, M]
  ys = expert_fn(params, xs)   (the local experts, one batched product)
  ys = all_to_all back; y = einsum(ecm,gec->gm)(ys, combine)   (fp32)

Capacity is ``max(1, int(capacity_factor * k * G / E))`` on the local G,
so the same tokens grouped otherwise route otherwise. The all-to-alls are
differentiable (:mod:`horovod_tpu_torch.ops.autograd_collectives`): the
gradient of an expert reaches its owner from every rank's tokens.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops import mesh_collectives as mc
from horovod_tpu_torch.ops.reduce_op import ReduceOp


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor          # load-balancing loss (Switch aux loss)
    fraction_dropped: torch.Tensor


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, MoEMetrics]:
    """Dense dispatch/combine tensors: logits ``[G, E]`` → dispatch
    ``[G, E, C]`` (0/1), combine ``[G, E, C]`` (gate weights), metrics."""
    G, E = logits.shape
    gates = torch.softmax(logits, dim=-1)                     # [G, E]

    # Switch aux loss: E * sum_e (mean_g gates_e * mean_g route_e)
    top1 = torch.argmax(gates, dim=-1)
    density = F.one_hot(top1, E).float().mean(0)
    density_proxy = gates.mean(0)
    aux = E * torch.sum(density * density_proxy)

    dev = logits.device
    dispatch = torch.zeros((G, E, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((G, E, capacity), dtype=torch.float32, device=dev)
    # per-expert fill across the k choices, so slots are not reused
    fill = torch.zeros((E,), dtype=torch.int64, device=dev)
    masked_gates = gates
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(k):
        choice = torch.argmax(masked_gates, dim=-1)                 # [G]
        onehot = F.one_hot(choice, E)                               # [G, E]
        pos_in_expert = (torch.cumsum(onehot, 0) - onehot) + fill[None, :]
        pos = torch.sum(pos_in_expert * onehot, dim=-1)             # [G]
        keep = pos < capacity
        gate_val = torch.gather(gates, 1, choice[:, None])[:, 0]    # [G]
        disp = (onehot.float()[:, :, None]
                * F.one_hot(pos.clamp(0, capacity - 1),
                            capacity).float()[:, None, :]
                * keep.float()[:, None, None])
        dispatch = dispatch + disp
        combine = combine + disp * gate_val[:, None, None]
        dropped = dropped + torch.sum(1.0 - keep.float()) / (G * k)
        fill = fill + torch.sum(onehot * keep[:, None], dim=0)
        masked_gates = masked_gates * (1.0 - onehot.float())
    return dispatch, combine, MoEMetrics(aux, dropped)


def moe_layer_spmd(x: torch.Tensor, router_w: torch.Tensor,
                   expert_fn: Callable, expert_params, axis=None,
                   k: int = 2, capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, MoEMetrics]:
    """This rank's MoE: x ``[G, M]`` local tokens, router_w ``[M, E]``
    (replicated), ``expert_params`` with leading dim ``E/ep`` (this
    shard's experts), ``expert_fn(params, xs [E/ep, N, M]) -> [E/ep, N, M]``
    over all local experts at once. ``axis`` is the ep axis, or None."""
    n = axis.size if axis is not None else 1
    G, M = x.shape
    E = router_w.shape[1]
    if E % n:
        raise ValueError(f"ep axis size ({n}) must divide n_experts ({E})")
    capacity = max(1, int(capacity_factor * k * G / E))

    # bf16 tokens against the fp32 router promote to fp32, as in JAX
    logits = x.float() @ router_w.float()                      # [G, E]
    dispatch, combine, metrics = top_k_gating(logits, k, capacity)

    xs = torch.einsum("gm,gec->ecm", x.float(), dispatch).to(x.dtype)
    # [E, C, M] -> [E/ep, ep*C, M]: the expert dim split over the shards,
    # the source shards gathered into rows
    xs = ac.all_to_all(xs, axis, 0, 1)
    ys = expert_fn(expert_params, xs)                          # [E/ep, n*C, M]
    ys = ac.all_to_all(ys, axis, 1, 0)                         # [E, C, M]
    y = torch.einsum("ecm,gec->gm", ys.float(), combine).to(x.dtype)
    return y, metrics


def _rows(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    """This rank's block of dim 0 split over ``axes`` (outermost first)."""
    for ax in axes:
        n = x.shape[0] // ax.size
        x = x[ax.index * n:(ax.index + 1) * n]
    return x


def _gather_rows(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    for ax in reversed(axes):
        x = mc.pallgather(x, ax)
    return x


def moe_layer(x: torch.Tensor, router_w: torch.Tensor, expert_fn: Callable,
              expert_params, mesh, axis_name: str = "ep", k: int = 2,
              capacity_factor: float = 1.25,
              token_axes: Tuple[Optional[str], ...] = ("dp",)
              ) -> Tuple[torch.Tensor, MoEMetrics]:
    """Array-level MoE on every rank: x ``[T, M]`` global tokens, split
    over the live ``token_axes``; ``expert_params`` global, leading dim E
    split over ``axis_name``. Returns the global ``y`` (gathered back) and
    the metrics averaged over the token shards and the ep shards. Forward
    only: the gather back is not differentiable."""
    ep = mesh.axis(axis_name)
    ep_live = ep if ep.size > 1 else None
    tok = [mesh.axis(a) for a in token_axes
           if a and mesh.shape.get(a, 1) > 1]
    xl = _rows(x, tok)
    local = {key: _rows(v, [ep_live] if ep_live else [])
             for key, v in expert_params.items()}
    y, met = moe_layer_spmd(xl, router_w, expert_fn, local, ep_live, k,
                            capacity_factor)
    for ax in tok + ([ep_live] if ep_live else []):
        met = MoEMetrics(mc.preduce(met.aux_loss, ax, ReduceOp.AVERAGE),
                         mc.preduce(met.fraction_dropped, ax,
                                    ReduceOp.AVERAGE))
    return _gather_rows(y, tok), met
