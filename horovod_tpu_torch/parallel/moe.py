"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis.

Mirrors ``horovod_tpu/parallel/moe.py``: ``MoEMetrics``, ``top_k_gating``,
``moe_layer_spmd`` and ``moe_layer``. GShard/Switch-style capacity-based
dense dispatch, with the tiled all-to-all over ep exchanging tokens
between expert shards. Beside it, with no JAX counterpart, the dropless
layer of fine-grained MoE models (:func:`dropless_moe`, below): sorted by
expert, SwiGLU experts as grouped products, no capacity.

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
from horovod_tpu_torch.profiling import annotate


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


# -- dropless: (token, slot) pairs sorted by expert, grouped products ---------
#
# DeepSeekMoE's routed experts (DeepSeek-V2's ``DeepseekV2MoE``): every token
# picks its top-k experts over all E by its softmax score and keeps every
# pick, whatever the load. A rank holds the experts ``[first, first +
# count)`` and computes their part of the result alone; what the experts it
# does not hold add is left to their holders (an exchange by counts over ep,
# not written yet: a live ep axis raises).
#
# Nothing here waits on the card. The number of pairs on held experts is
# data-dependent, so every buffer is sized for the most there can be
# (T·k rows, sorted held pairs first) and the products read only the rows
# their group offsets cover (``torch._grouped_mm`` takes the offsets on the
# device); rows past the last group are never read as operands and are
# masked out where they are combined.


class Routing(NamedTuple):
    scores: torch.Tensor        # [T, E] fp32 softmax over every expert
    index: torch.Tensor         # [T, k] the experts each token picked
    weight: torch.Tensor        # [T, k] fp32 gate weights of the picks


def softmax_top_k(logits: torch.Tensor, k: int,
                  scaling: float = 1.0) -> Routing:
    """Greedy top-k of the fp32 softmax over all experts, the picks'
    scores as their weights (no renormalisation) times ``scaling``:
    DeepSeek-V2's ``MoEGate`` with ``scoring_func`` softmax,
    ``topk_method`` greedy and ``norm_topk_prob`` false."""
    scores = torch.softmax(logits.float(), dim=-1)
    weight, index = torch.topk(scores, k, dim=-1, sorted=True)
    return Routing(scores, index, weight * scaling)


class HeldPairs(NamedTuple):
    """The (token, slot) pairs sorted by held expert, pairs on other
    experts last; every field on the device."""
    order: torch.Tensor         # [T·k] flat pair of each sorted row
    token: torch.Tensor         # [T·k] its token
    held: torch.Tensor          # [T·k] bool: the row's expert is held
    inverse: torch.Tensor       # [T·k] sorted row of each flat pair
    offs: torch.Tensor          # [count] int32 end of each expert's rows
    counts: torch.Tensor        # [count] int64 pairs each held expert got


def sort_held_pairs(index: torch.Tensor, first: int, count: int) -> HeldPairs:
    """Sort the flat pairs of ``index`` ``[T, k]`` by held expert (stable:
    token order inside an expert), with no host synchronization."""
    T, k = index.shape
    local = index.reshape(-1) - first
    on_held = (local >= 0) & (local < count)
    key = torch.where(on_held, local, torch.full_like(local, count))
    key_sorted, order = torch.sort(key, stable=True)
    experts = torch.arange(1, count + 1, device=index.device,
                           dtype=key_sorted.dtype)
    offs = torch.searchsorted(key_sorted, experts, out_int32=True)
    counts = torch.diff(offs.long(), prepend=offs.new_zeros(1).long())
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return HeldPairs(order, order // k, key_sorted < count, inverse, offs,
                     counts)


def _unsort_sum(rows: torch.Tensor, pairs: HeldPairs, T: int) -> torch.Tensor:
    """Each token's sum over its slots of the sorted ``rows`` ``[T·k, M]``,
    rows of pairs on experts not held (and the unwritten rows past the
    last group) counted as zero; in place on ``rows``. Deterministic: a
    gather and a sum over the k slots, no atomics."""
    rows.masked_fill_(~pairs.held[:, None], 0)
    return rows[pairs.inverse].view(T, -1, rows.shape[-1]).sum(1)


class _Combine(torch.autograd.Function):
    """Sorted pair rows back to their tokens, summed (:func:`_unsort_sum`);
    the gradient of a row is its token's."""

    @staticmethod
    def forward(ctx, rows, pairs, T):
        ctx.pairs = pairs
        return _unsort_sum(rows, pairs, T)

    @staticmethod
    def backward(ctx, dy):
        return dy[ctx.pairs.token], None, None


def _silu_grad(g: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(g)
    return s * (1 + g * (1 - s))


class _HeldExperts(torch.autograd.Function):
    """The held experts' SwiGLU over the sorted pairs, gate-weighted: row
    ``r`` of pair (t, e) is ``w·down_e(silu(gate_e(x_t)) ⊙ up_e(x_t))``
    (rows of pairs on other experts, and past the last group, are not
    computed). Saves only the token-sized input and the sort; the ``[T·k,
    ·]`` intermediates are recomputed in backward."""

    @staticmethod
    def forward(ctx, x, weight, w_gate, w_up, w_down, pairs, dtype):
        T = x.shape[0]
        ctx.pairs, ctx.dtype, ctx.T = pairs, dtype, T
        w13 = torch.cat([w_gate, w_up], dim=1).to(dtype)      # [G, 2F, M]
        w2 = w_down.to(dtype)                                 # [G, M, F]
        w_rows = torch.where(pairs.held, weight.reshape(-1)[pairs.order],
                             weight.new_zeros(()))
        xs = x[pairs.token]
        h = torch._grouped_mm(xs, w13.transpose(1, 2), offs=pairs.offs)
        g, u = h.chunk(2, dim=-1)
        a = F.silu(g) * u * w_rows[:, None].to(dtype)
        ctx.save_for_backward(x, w_rows, w_gate, w_up, w_down)
        return torch._grouped_mm(a, w2.transpose(1, 2), offs=pairs.offs)

    @staticmethod
    def backward(ctx, dys):
        x, w_rows, w_gate, w_up, w_down = ctx.saved_tensors
        pairs, dtype, T = ctx.pairs, ctx.dtype, ctx.T
        offs = pairs.offs
        w13 = torch.cat([w_gate, w_up], dim=1).to(dtype)
        w2 = w_down.to(dtype)
        xs = x[pairs.token]
        g, u = torch._grouped_mm(xs, w13.transpose(1, 2),
                                 offs=offs).chunk(2, dim=-1)
        s = F.silu(g)
        su = s * u
        dys = dys.to(dtype)
        dsu = torch._grouped_mm(dys, w2, offs=offs)             # [P, F]
        dw_rows = (dsu.float() * su.float()).sum(-1)
        dw_rows = torch.where(pairs.held, dw_rows, dw_rows.new_zeros(()))
        wr = w_rows[:, None].to(dtype)
        d_down = torch._grouped_mm((su * wr).t(), dys,
                                   offs=offs).transpose(1, 2)
        dsu = dsu * wr
        dh = torch.cat([dsu * u * _silu_grad(g), dsu * s], dim=-1)
        d13 = torch._grouped_mm(xs.t(), dh,
                                offs=offs).transpose(1, 2)      # [G, 2F, M]
        # a group with no rows can come back unwritten from the 2d x 2d
        # products (garbage seen on the card): an idle expert's gradient is 0
        idle = (pairs.counts == 0)[:, None, None]
        d_down.masked_fill_(idle, 0)
        d13.masked_fill_(idle, 0)
        dx = _unsort_sum(torch._grouped_mm(dh, w13, offs=offs), pairs, T)
        Fw = w_gate.shape[1]
        dweight = w_rows.new_zeros(w_rows.shape).scatter_(
            0, pairs.order, dw_rows).view(T, -1)
        return (dx.to(x.dtype), dweight, d13[:, :Fw].float(),
                d13[:, Fw:].float(), d_down.float(), None, None)


def dropless_moe(x: torch.Tensor, logits: torch.Tensor, k: int, first: int,
                 count: int, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, axis=None, scaling: float = 1.0
                 ) -> Tuple[torch.Tensor, Routing, HeldPairs]:
    """The held experts' part of a dropless MoE layer.

    ``x`` ``[T, M]`` tokens in the compute dtype; ``logits`` ``[T, E]`` the
    router's over ALL ``E`` experts; ``k`` picks a token; this rank holds
    experts ``first .. first + count - 1``, whose SwiGLU weights are
    ``w_gate``/``w_up`` ``[count, F, M]`` and ``w_down`` ``[count, M, F]``
    (``[out, in]`` each, as ``nn.Linear`` keeps them). Returns ``(y,
    routing, pairs)``: ``y`` ``[T, M]`` the gate-weighted sum of the held
    experts' outputs over each token's picks (zero for a token none of
    whose picks is held), the routing over all ``E`` (for a balance loss),
    and the sorted pairs (``pairs.counts``: the pairs each held expert
    computed). No pick is dropped, and nothing waits on the card.
    ``axis`` is the ep axis: live, the pairs of the experts held elsewhere
    would have to be exchanged by counts, which is not written yet."""
    if axis is not None and axis.size > 1:
        raise NotImplementedError(
            "dropless_moe over a live ep axis needs the all-to-all of the "
            "pairs by counts, which is not written yet; run it with the "
            "experts this rank holds and no ep axis")
    E = logits.shape[-1]
    if not 0 <= first < first + count <= E:
        raise ValueError(f"held experts [{first}, {first + count}) do not lie "
                         f"in the router's {E}")
    if w_gate.shape[0] != count or w_down.shape[0] != count:
        raise ValueError(f"{count} held experts, but weights for "
                         f"{w_gate.shape[0]} and {w_down.shape[0]}")
    with annotate("hvd.moe.route"):
        routing = softmax_top_k(logits, k, scaling)
    with annotate("hvd.moe.dispatch"):
        pairs = sort_held_pairs(routing.index, first, count)
    with annotate("hvd.moe.experts"):
        rows = _HeldExperts.apply(x, routing.weight, w_gate, w_up, w_down,
                                  pairs, x.dtype)
    with annotate("hvd.moe.combine"):
        y = _Combine.apply(rows, pairs, x.shape[0])
    return y, routing, pairs
