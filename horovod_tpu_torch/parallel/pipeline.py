"""Pipeline parallelism over the ``pp`` axis: GPipe, 1F1B and interleaved
1F1B.

Mirrors ``horovod_tpu/parallel/pipeline.py``: ``replicate_from_stage`` and
``psum_cotangent`` (in :mod:`horovod_tpu_torch.ops.autograd_collectives`),
``pipeline_apply`` (GPipe, differentiable), ``pipeline_1f1b_apply``,
``pipeline_interleaved_apply`` (forward and backward in one schedule,
returning the loss and this rank's gradients, with the ``dp_reducer``
seam), ``stage_stacked``, the pure-Python ``interleaved_tables`` (a copy:
the same tables), ``schedule_ticks`` and ``bubble_fraction``.

The JAX schedules are one SPMD program in which every device runs every
tick with the invalid units masked out, and the backward rematerializes
each stage forward from a ring of stored inputs. Here each rank holds only
its own stages and runs only the real units, as Megatron does:

* A schedule is a table of ticks (:class:`Schedule`). At tick ``t``
  pipeline position ``d`` runs at most one forward unit (chunk ``j``,
  microbatch ``m``: stage ``q = j·S + d``) and then at most one backward
  unit; then every position sends what the tick produced, the forward
  output to ``(d + 1) % S`` and the input's cotangent to ``(d − 1) % S``,
  and receives what its neighbours produced, all in one batch
  (:func:`~horovod_tpu_torch.ops.mesh_collectives.exchange`) in one order
  on every rank. Every rank runs every tick, so each send meets its
  receive in the same tick and nothing waits on a later one: the schedule
  cannot deadlock on gloo or NCCL. Under gloo the CUDA tensors go through
  the host (gloo's send/recv cannot take them).
* A forward unit keeps its autograd graph (its inputs detached and
  requiring grad) until its backward unit runs ``torch.autograd.grad``
  through it: no rematerialization, so each kernel launches once a unit.
  Under 1F1B stage ``s`` keeps at most ``S − s`` graphs (its warm-up of
  ``S − s − 1`` forwards, then one forward and one backward each, then the
  cool-down); GPipe keeps all ``M``.
* GPipe's backward is one autograd node per call (:func:`pipeline_apply`):
  its forward runs the forward ticks, its backward the backward ticks, so
  a pipelined loss differentiates with ``loss.backward()`` on every rank
  and each rank issues the same exchanges in the same order whatever the
  autograd engine's order inside a stage.

Gradients of the 1F1B family are summed over microbatches and scaled by
``1/M`` at the end, as the JAX package does. The interleaved tick tables
are the JAX package's; 1F1B's are Megatron's order (warm-up, steady,
cool-down) laid on ticks; GPipe's are all forwards, then all backwards in
reverse microbatch order. ``schedule_ticks``/``bubble_fraction`` keep the
JAX package's analytic tick counts, which the plan and the gauges report.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops import mesh_collectives as mc
from horovod_tpu_torch.ops.reduce_op import Average

replicate_from_stage = ac.replicate_from_stage
psum_cotangent = ac.psum_cotangent


# ---------------------------------------------------------------------------
# Tick tables
# ---------------------------------------------------------------------------

def _min_ring(intervals) -> int:
    """Smallest ring size R such that no two live intervals [a, c] whose
    keys collide mod R overlap (slot m%R must not be overwritten while
    its previous occupant is still unconsumed)."""
    if not intervals:
        return 1
    keys = sorted(intervals)
    for R in range(1, max(m for m, _, _ in keys) + 2):
        ok = True
        for i, (m1, a1, c1) in enumerate(keys):
            for (m2, a2, c2) in keys[i + 1:]:
                if m1 % R == m2 % R and a1 <= c2 and a2 <= c1:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return R
    return max(m for m, _, _ in keys) + 1


@functools.lru_cache(maxsize=256)
def interleaved_tables(S: int, v: int, M: int):
    """Static schedule tables for the interleaved 1F1B schedule, the JAX
    package's (the same greedy list scheduler, the same numpy tables).

    Stage ``q = j*S + d`` is virtual chunk ``j`` on device ``d``; each
    device runs at most one forward and one backward unit per tick,
    forwards deepest-stage-first, backwards oldest-microbatch-first.
    Returns a dict of the execution and receive-side tables (``[T, S]``),
    the ring sizes of the JAX remat design, the tick count ``T`` and the
    analytic bubble fraction ``1 - v*M/T``."""
    V = v * S
    ef, eb = {}, {}
    fw_rows, bw_rows = [], []
    t, done_f, done_b, total = 0, 0, 0, V * M
    limit = 4 * (V + M) * max(v, 1) + 64
    while (done_f < total or done_b < total) and t < limit:
        frow, brow = [], []
        for d in range(S):
            cands = []
            for j in range(v):
                q = j * S + d
                for m in range(M):        # microbatches in order per chunk
                    if (q, m) in ef:
                        continue
                    if q == 0 or ef.get((q - 1, m), limit) < t:
                        cands.append((j, m, q))
                    break
            if cands:
                j, m, q = max(cands, key=lambda c: (c[2], -c[1]))
                ef[(q, m)] = t
                done_f += 1
                frow.append((j, m, 1))
            else:
                frow.append((0, 0, 0))
        for d in range(S):
            cands = []
            for j in range(v):
                q = j * S + d
                for m in range(M):
                    if (q, m) in eb:
                        continue
                    if (q, m) not in ef or ef[(q, m)] > t:
                        continue
                    # the last stage seeds its own backward the tick its
                    # forward lands (forward phase before backward phase)
                    if q == V - 1 or eb.get((q + 1, m), limit) < t:
                        cands.append((j, m, q))
                    break
            if cands:
                j, m, q = min(cands, key=lambda c: (c[1], -c[2]))
                eb[(q, m)] = t
                done_b += 1
                brow.append((j, m, 1))
            else:
                brow.append((0, 0, 0))
        fw_rows.append(frow)
        bw_rows.append(brow)
        t += 1
    if done_f != total or done_b != total:
        raise AssertionError(
            f"interleaved scheduler wedged at S={S} v={v} M={M} "
            f"({done_f}/{total} fwd, {done_b}/{total} bwd)")
    T = t

    # receive-side tables: what device d's neighbours sent it at tick t-1
    fr = np.zeros((T, S, 3), np.int32)
    br = np.zeros((T, S, 3), np.int32)
    for tick in range(1, T):
        for d in range(S):
            s = (d - 1) % S
            j_s, m_s, ok = fw_rows[tick - 1][s]
            if ok and j_s * S + s != V - 1:
                fr[tick, d] = (j_s + (1 if s == S - 1 else 0), m_s, 1)
            s = (d + 1) % S
            j_s, m_s, ok = bw_rows[tick - 1][s]
            if ok and j_s * S + s != 0:
                br[tick, d] = (j_s - (1 if s == 0 else 0), m_s, 1)

    act_live, store_live, grad_live, seed_live = [], [], [], []
    for (q, m), tf_ in ef.items():
        if q > 0:
            act_live.append((m, ef[(q - 1, m)] + 1, tf_))
        store_live.append((m, tf_, eb[(q, m)]))
        if q == V - 1:
            seed_live.append((m, tf_, eb[(q, m)]))
        if q < V - 1:
            grad_live.append((m, eb[(q + 1, m)] + 1, eb[(q, m)]))
    tables = {
        "fj": np.asarray([[u[0] for u in row] for row in fw_rows], np.int32),
        "fm": np.asarray([[u[1] for u in row] for row in fw_rows], np.int32),
        "fv": np.asarray([[u[2] for u in row] for row in fw_rows], np.int32),
        "bj": np.asarray([[u[0] for u in row] for row in bw_rows], np.int32),
        "bm": np.asarray([[u[1] for u in row] for row in bw_rows], np.int32),
        "bv": np.asarray([[u[2] for u in row] for row in bw_rows], np.int32),
        "frj": fr[:, :, 0], "frm": fr[:, :, 1], "frv": fr[:, :, 2],
        "brj": br[:, :, 0], "brm": br[:, :, 1], "brv": br[:, :, 2],
    }
    rings = {"act": _min_ring(act_live), "store": _min_ring(store_live),
             "grad": _min_ring(grad_live), "seed": _min_ring(seed_live)}
    return {"tables": tables, "rings": rings, "ticks": T,
            "bubble_fraction": 1.0 - (v * M) / T}


def schedule_ticks(schedule: str, S: int, M: int, v: int = 1):
    """Analytic (ticks, ideal_ticks) for one training step of a schedule,
    the JAX package's tick model (a combined forward+backward tick for the
    1F1B family; forward and transposed backward tick-slots for GPipe).
    ``1 - ideal/ticks`` is the bubble fraction."""
    if S <= 1:
        return max(M, 1), max(M, 1)
    if schedule == "gpipe":
        return 2 * (M + S - 1), 2 * M
    if schedule == "1f1b":
        return M + 2 * S - 2, M
    if schedule == "interleaved":
        sched = interleaved_tables(S, max(int(v), 1), M)
        return sched["ticks"], v * M
    raise ValueError(f"unknown schedule {schedule!r}; expected "
                     "gpipe | 1f1b | interleaved")


def bubble_fraction(schedule: str, S: int, M: int, v: int = 1) -> float:
    """Analytic fill+drain bubble fraction for ``schedule`` at pipeline
    depth ``S``, ``M`` microbatches, ``v`` virtual chunks per device."""
    ticks, ideal = schedule_ticks(schedule, S, M, v)
    return 1.0 - ideal / ticks


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The units each pipeline position runs, tick by tick: ``f[t][d]`` and
    ``b[t][d]`` are ``(chunk, microbatch)`` or None. ``split`` is the first
    tick holding a backward unit when every forward comes before it
    (GPipe), else None."""
    S: int
    v: int
    M: int
    f: Tuple[Tuple[Optional[Tuple[int, int]], ...], ...]
    b: Tuple[Tuple[Optional[Tuple[int, int]], ...], ...]
    split: Optional[int] = None

    @property
    def ticks(self) -> int:
        return len(self.f)

    def in_flight(self, d: int) -> int:
        """The most forward graphs position ``d`` holds at once."""
        live = peak = 0
        for t in range(self.ticks):
            live += self.f[t][d] is not None
            peak = max(peak, live)
            live -= self.b[t][d] is not None
        return peak


def _from_units(S, v, M, f_at, b_at, split=None) -> Schedule:
    """A :class:`Schedule` from ``{(d, j, m): tick}`` maps."""
    T = 1 + max(max(f_at.values()), max(b_at.values()))
    f = [[None] * S for _ in range(T)]
    b = [[None] * S for _ in range(T)]
    for (d, j, m), t in f_at.items():
        assert f[t][d] is None
        f[t][d] = (j, m)
    for (d, j, m), t in b_at.items():
        assert b[t][d] is None
        b[t][d] = (j, m)
    return Schedule(S, v, M, tuple(map(tuple, f)), tuple(map(tuple, b)),
                    split)


@functools.lru_cache(maxsize=256)
def gpipe_schedule(S: int, M: int) -> Schedule:
    """All forwards (stage ``d`` runs microbatch ``m`` at tick ``d + m``),
    then all backwards in reverse microbatch order."""
    T_f = M + S - 1
    f_at = {(d, 0, m): d + m for d in range(S) for m in range(M)}
    b_at = {(d, 0, m): T_f + (S - 1 - d) + (M - 1 - m)
            for d in range(S) for m in range(M)}
    return _from_units(S, 1, M, f_at, b_at, split=T_f)


@functools.lru_cache(maxsize=256)
def one_f_one_b_schedule(S: int, M: int) -> Schedule:
    """Megatron's 1F1B on ticks: stage ``s`` runs ``min(S − s − 1, M)``
    warm-up forwards, then one forward and one backward each, then the
    cool-down backwards, each unit at the first tick its input is there
    (a forward after the backward ahead of it in the stage's order takes
    the next tick: a tick runs its forward before its backward)."""
    order = []
    for s in range(S):
        w = min(S - s - 1, M)
        units = [("F", m) for m in range(w)]
        for i in range(M - w):
            units += [("F", w + i), ("B", i)]
        units += [("B", m) for m in range(M - w, M)]
        order.append(units)
    f_at, b_at = {}, {}
    nxt = [0] * S
    t = 0
    while any(nxt[s] < len(order[s]) for s in range(S)):
        for s in range(S):
            if nxt[s] < len(order[s]) and order[s][nxt[s]][0] == "F":
                m = order[s][nxt[s]][1]
                if s == 0 or f_at.get((s - 1, 0, m), t) < t:
                    f_at[(s, 0, m)] = t
                    nxt[s] += 1
            if nxt[s] < len(order[s]) and order[s][nxt[s]][0] == "B":
                m = order[s][nxt[s]][1]
                if (s == S - 1 and (s, 0, m) in f_at) or \
                        b_at.get((s + 1, 0, m), t) < t:
                    b_at[(s, 0, m)] = t
                    nxt[s] += 1
        t += 1
        if t > 4 * (M + S) + 8:
            raise AssertionError(f"1F1B schedule wedged at S={S} M={M}")
    return _from_units(S, 1, M, f_at, b_at)


@functools.lru_cache(maxsize=256)
def interleaved_schedule(S: int, v: int, M: int) -> Schedule:
    """The JAX package's interleaved tables (:func:`interleaved_tables`)
    as a :class:`Schedule`."""
    tb = interleaved_tables(S, v, M)["tables"]
    f_at, b_at = {}, {}
    for t in range(tb["fv"].shape[0]):
        for d in range(S):
            if tb["fv"][t, d]:
                f_at[(d, int(tb["fj"][t, d]), int(tb["fm"][t, d]))] = t
            if tb["bv"][t, d]:
                b_at[(d, int(tb["bj"][t, d]), int(tb["bm"][t, d]))] = t
    return _from_units(S, v, M, f_at, b_at)


def make_schedule(schedule: str, S: int, M: int, v: int = 1) -> Schedule:
    if schedule == "gpipe":
        return gpipe_schedule(S, M)
    if schedule == "1f1b":
        return one_f_one_b_schedule(S, M)
    if schedule == "interleaved":
        return interleaved_schedule(S, int(v), M)
    raise ValueError(f"unknown schedule {schedule!r}; expected "
                     "gpipe | 1f1b | interleaved")


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

def _p2p_ready(axis) -> None:
    """NCCL wants every rank of a group in its first batched p2p call; a
    pipeline tick may leave some idle, so the axis runs one collective
    before its first exchange (its mesh remembers that it did)."""
    if axis.name in axis.mesh.p2p_ready:
        return
    import torch.distributed as dist
    if dist.get_backend(axis.group) == "nccl":
        mc.preduce(torch.zeros((), device=torch.device(
            "cuda", torch.cuda.current_device())), axis)
    axis.mesh.p2p_ready.add(axis.name)


def _zeros_like_spec(spec, device):
    return tuple(torch.empty(shape, dtype=dtype, device=device)
                 for shape, dtype in spec)


class Units:
    """This rank's forward and backward units: ``chunk_fn(j, *xs) ->
    tuple`` runs chunk ``j`` on one microbatch's payload; chunk ``j``'s
    parameters are ``chunk_params[j]`` (tensors the chunk reads, made
    leaves here so each unit's gradient lands in its chunk); ``first(m)``
    is the payload stage 0 takes, and on the last stage ``loss(m, ys)``
    the microbatch's loss (then its backward is seeded with 1), or, with
    ``loss=None``, the outputs are kept per microbatch and the backward
    seeded by :meth:`seed`. ``input_grads`` keeps the cotangent of stage
    0's inputs per microbatch."""

    def __init__(self, chunk_fn: Callable, chunk_params: Sequence[Sequence[
                 torch.Tensor]], first: Callable[[int], tuple],
                 loss: Optional[Callable] = None, input_grads: bool = False):
        self.chunk_fn, self.first, self.loss = chunk_fn, first, loss
        self.params = [[p.detach().requires_grad_(p.is_floating_point())
                        for p in ps] for ps in chunk_params]
        self.grads: List[List[Optional[torch.Tensor]]] = [
            [None] * len(ps) for ps in self.params]
        self.input_grads = input_grads
        self.saved: Dict[Tuple[int, int], tuple] = {}
        # payloads received from the neighbours, by the unit that takes them
        self.inbox_f: Dict[Tuple[int, int], tuple] = {}
        self.inbox_b: Dict[Tuple[int, int], tuple] = {}
        self.outputs: Dict[int, tuple] = {}
        self.seeds: Dict[int, tuple] = {}
        self.first_grads: Dict[int, tuple] = {}
        self.losses: List[torch.Tensor] = []

    def forward(self, j, m, xs, first: bool, last: bool):
        grad = torch.is_grad_enabled()
        if first:
            xs = tuple(x.detach().requires_grad_(
                self.input_grads and grad and x.is_floating_point())
                for x in self.first(m))
        else:
            xs = tuple(x.requires_grad_(grad and x.is_floating_point())
                       for x in xs)
        ys = tuple(self.chunk_fn(j, *xs, params=self.params[j]))
        if last and self.loss is not None:
            loss = self.loss(m, ys)
            self.losses.append(loss.detach())
            ys = (loss,)
        elif last:
            self.outputs[m] = tuple(y.detach() for y in ys)
        if grad:
            self.saved[(j, m)] = (xs, ys)
        return None if last else tuple(y.detach() for y in ys)

    def seed(self, m, gys) -> None:
        self.seeds[m] = gys

    def backward(self, j, m, gys, first: bool, last: bool):
        xs, ys = self.saved.pop((j, m))
        if last:
            gys = ((torch.ones_like(ys[0]),) if self.loss is not None
                   else self.seeds.pop(m))
        pairs = [(y, g) for y, g in zip(ys, gys) if y.requires_grad]
        inputs = [x for x in xs if x.requires_grad]
        params = [p for p in self.params[j] if p.requires_grad]
        got = torch.autograd.grad([y for y, _ in pairs],
                                  inputs + params,
                                  [g for _, g in pairs], allow_unused=True)
        gx = dict(zip(map(id, inputs), got[:len(inputs)]))
        gxs = tuple(gx.get(id(x)) if gx.get(id(x)) is not None
                    else torch.zeros_like(x) for x in xs)
        k = 0
        for i, p in enumerate(self.params[j]):
            if not p.requires_grad:
                continue
            g = got[len(inputs) + k]
            k += 1
            if g is not None:
                acc = self.grads[j][i]
                self.grads[j][i] = g if acc is None else acc + g
        if first:
            if self.input_grads:
                self.first_grads[m] = gxs
            return None
        return gxs


def run_schedule(sched: Schedule, axis, units: Units, spec: Sequence[Tuple[
                 tuple, torch.dtype]], device, ticks: Optional[range] = None
                 ) -> None:
    """Run ``ticks`` (default: all) of ``sched`` on this rank at position
    ``axis.index`` of the pp ``axis``: each tick's forward unit, backward
    unit, then one batched exchange with the neighbours. ``spec`` is the
    ``(shape, dtype)`` of every tensor of a stage's payload (the same on
    every stage, and for its cotangent)."""
    S, v = sched.S, sched.v
    if axis.size != S:
        raise ValueError(f"schedule for {S} stages on a pp axis of "
                         f"{axis.size}")
    if S < 2:
        raise ValueError("run_schedule needs a pipeline of at least two "
                         "stages")
    _p2p_ready(axis)
    d = axis.index
    V = v * S
    nxt, prv = (d + 1) % S, (d - 1) % S
    nxt_rank, prv_rank = axis.ranks[nxt], axis.ranks[prv]
    inbox_f, inbox_b = units.inbox_f, units.inbox_b
    for t in (ticks if ticks is not None else range(sched.ticks)):
        sends = []
        fu = sched.f[t][d]
        if fu is not None:
            j, m = fu
            q = j * S + d
            out = units.forward(j, m, None if q == 0 else inbox_f.pop(fu),
                                q == 0, q == V - 1)
            if out is not None:
                sends += [(y, nxt_rank) for y in out]
        bu = sched.b[t][d]
        if bu is not None:
            j, m = bu
            q = j * S + d
            gxs = units.backward(j, m, None if q == V - 1
                                 else inbox_b.pop(bu), q == 0, q == V - 1)
            if gxs is not None:
                sends += [(g, prv_rank) for g in gxs]
        recvs = []
        pu = sched.f[t][prv]
        if pu is not None and pu[0] * S + prv != V - 1:
            key = (pu[0] + (1 if prv == S - 1 else 0), pu[1])
            inbox_f[key] = _zeros_like_spec(spec, device)
            recvs += [(x, prv_rank) for x in inbox_f[key]]
        nu = sched.b[t][nxt]
        if nu is not None and nu[0] * S + nxt != 0:
            key = (nu[0] - (1 if nxt == 0 else 0), nu[1])
            inbox_b[key] = _zeros_like_spec(spec, device)
            recvs += [(g, nxt_rank) for g in inbox_b[key]]
        mc.exchange(sends, recvs, axis.group)


# ---------------------------------------------------------------------------
# GPipe: one autograd node a call
# ---------------------------------------------------------------------------

class _GPipe(torch.autograd.Function):
    """Forward: the forward ticks of :func:`gpipe_schedule`; the last stage
    returns its outputs stacked over microbatches, the others a zero
    scalar per payload tensor. Backward: the backward ticks, seeded on the
    last stage by the outputs' cotangent; returns the gradient of stage
    0's input and of this stage's parameters. ``run`` is ``(Units,
    Schedule, pp Axis, payload spec, device)``."""

    @staticmethod
    def forward(ctx, run, x0, *params):
        units, sched, axis, spec, device = run
        with torch.enable_grad():
            run_schedule(sched, axis, units, spec, device,
                         range(sched.split))
        ctx.run = run
        ctx.n_params = len(params)
        if axis.index == sched.S - 1:
            return tuple(torch.stack([units.outputs[m][i]
                                      for m in range(sched.M)])
                         for i in range(len(spec)))
        return tuple(x0.new_zeros((), dtype=dt) for _, dt in spec)

    @staticmethod
    def backward(ctx, *gys):
        units, sched, axis, spec, device = ctx.run
        if axis.index == sched.S - 1:
            for m in range(sched.M):
                units.seed(m, tuple(g[m] for g in gys))
        with torch.enable_grad():
            run_schedule(sched, axis, units, spec, device,
                         range(sched.split, sched.ticks))
        gx0 = None
        if units.input_grads and units.first_grads:
            gx0 = torch.stack([units.first_grads[m][0]
                               for m in range(sched.M)])
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(units.grads[0], units.params[0])]
        ctx.run = None
        return (None, gx0, *grads)


def gpipe(stage_fn: Callable, params: Sequence[torch.Tensor],
          first: Optional[Sequence[torch.Tensor]], axis, M: int,
          spec: Sequence[Tuple[tuple, torch.dtype]]) -> tuple:
    """GPipe over the pp ``axis`` for this rank's stage:
    ``stage_fn(*payload, params=params) -> payload`` on each of ``M``
    microbatches. ``first`` (stage 0 only; None elsewhere) holds the
    payload stacked over microbatches (``[M, ...]`` each); its first
    tensor's gradient flows back. Returns, on the last stage, the outputs
    stacked over microbatches, and elsewhere a zero scalar per payload
    tensor, each differentiable: ``backward`` on every rank runs the
    backward ticks once. Without gradients (``torch.no_grad`` or nothing
    requiring grad) only the forward ticks run, and no graph is kept."""
    sched = gpipe_schedule(axis.size, M)
    device = params[0].device
    first = tuple(first) if first is not None else None
    units = Units(lambda j, *xs, params: stage_fn(*xs, params=params),
                  [params], (lambda m: tuple(x[m] for x in first)),
                  input_grads=first is not None)
    x0 = first[0] if first is not None else torch.zeros(0, device=device)
    grad = torch.is_grad_enabled() and (
        x0.requires_grad or any(p.requires_grad for p in params))
    if not grad:
        with torch.no_grad():
            run_schedule(sched, axis, units, spec, device, range(sched.split))
        if axis.index == axis.size - 1:
            return tuple(torch.stack([units.outputs[m][i] for m in range(M)])
                         for i in range(len(spec)))
        return tuple(torch.zeros((), dtype=dt, device=device)
                     for _, dt in spec)
    return _GPipe.apply((units, sched, axis, tuple(spec), device), x0,
                        *params)


# ---------------------------------------------------------------------------
# The array-level API
# ---------------------------------------------------------------------------

def _leaves(tree) -> Tuple[List[torch.Tensor], Callable]:
    from horovod_tpu_torch.common.tree import tree_flatten
    return tree_flatten(tree)


def _map(fn, tree):
    leaves, unflatten = _leaves(tree)
    return unflatten([fn(x) for x in leaves])


def stage_stacked(params_per_stage: list):
    """Stack a list of per-stage parameter trees into the leading-dim
    layout the array-level schedules take."""
    flat = [_leaves(p) for p in params_per_stage]
    unflatten = flat[0][1]
    return unflatten([torch.stack(ls) for ls in
                      zip(*(leaves for leaves, _ in flat))])


def _data_rows(x, mesh, n_microbatches, batch_axis):
    """``x [T, ...]`` → this rank's ``[M, T/M/dp, ...]``: the microbatches,
    each narrowed to block ``dp.index`` (the JAX ``P(None, "dp")``)."""
    T = x.shape[0]
    if T % n_microbatches != 0:
        raise ValueError(f"batch {T} not divisible by microbatches "
                         f"{n_microbatches}")
    xm = x.reshape((n_microbatches, T // n_microbatches) + tuple(x.shape[1:]))
    b = _batch_axis(mesh, batch_axis)
    if b is not None:
        n = xm.shape[1] // b.size
        xm = xm.narrow(1, b.index * n, n)
    return xm


def _batch_axis(mesh, batch_axis):
    if batch_axis and mesh.shape.get(batch_axis, 1) > 1:
        return mesh.axis(batch_axis)
    return None


def _check_stacked(stage_params, n: int, axis_name: str, what: str):
    leading = {int(t.shape[0]) for t in _leaves(stage_params)[0]}
    if leading != {n}:
        raise ValueError(
            f"stage_params leading dims {sorted(leading)} must all equal {what}"
            f" ({n}); restack the stages for this mesh (stage_stacked) "
            f"instead of silently dropping some.")


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   n_microbatches: int, axis_name: str = "pp",
                   batch_axis: Optional[str] = "dp") -> torch.Tensor:
    """Array-level GPipe: ``stage_fn(params_for_one_stage, microbatch) ->
    microbatch``; ``stage_params`` a tree whose leaves have the leading
    dim ``S`` (this rank runs stage ``pp.index``, a view of its row, so
    its gradient lands there); ``x [T, ...]`` the global batch, split into
    microbatches, each narrowed to this rank's ``batch_axis`` block.
    Returns this rank's rows of the output (``[T/dp, ...]``) on every rank
    of the pipeline (:func:`replicate_from_stage`), differentiable."""
    pp = mesh.axis(axis_name)
    S = pp.size
    _check_stacked(stage_params, S, axis_name,
                   f"the '{axis_name}' mesh axis size")
    xm = _data_rows(x, mesh, n_microbatches, batch_axis)
    if S == 1:
        one = _map(lambda p: p[0], stage_params)
        y = stage_fn(one, xm.reshape((-1,) + tuple(xm.shape[2:])))
        return y
    leaves, unflatten = _leaves(stage_params)
    mine = [p[pp.index] for p in leaves]

    def fn(h, params):
        return (stage_fn(unflatten(list(params)), h),)

    spec = [(tuple(xm.shape[1:]), xm.dtype)]
    ys = gpipe(fn, mine, (xm,) if pp.index == 0 else None, pp,
               n_microbatches, spec)
    ym = ys[0] if pp.index == S - 1 else ys[0] + torch.zeros(
        (n_microbatches,) + spec[0][0], dtype=xm.dtype, device=x.device)
    ym = replicate_from_stage(ym, pp, S - 1)
    return ym.reshape((-1,) + tuple(ym.shape[2:]))


def _dp_reduce(grads, b_ax, dp_reducer):
    """Mean of the gradient tree over the data axis: ``dp_reducer`` when
    given (e.g. the bucketed sync), else one dense ``pmean`` per leaf."""
    if b_ax is None:
        return grads
    if dp_reducer is not None:
        return dp_reducer(grads)
    return _map(lambda g: mc.preduce(g, b_ax, Average), grads)


def _run_array(schedule: str, stage_fn, loss_fn, stage_params, x, targets,
               mesh, n_microbatches, v, axis_name, batch_axis, dp_reducer):
    pp = mesh.axis(axis_name)
    S, M = pp.size, n_microbatches
    V = v * S
    xm = _data_rows(x, mesh, M, batch_axis)
    tm = _data_rows(targets, mesh, M, batch_axis)
    b_ax = _batch_axis(mesh, batch_axis)
    leaves, unflatten = _leaves(stage_params)
    if S == 1:
        params = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            losses = []
            for m in range(M):
                h = xm[m]
                for q in range(V):
                    h = stage_fn(unflatten([p[q] for p in params]), h)
                losses.append(loss_fn(h, tm[m]))
            loss = torch.stack(losses).mean()
            grads = unflatten(list(torch.autograd.grad(loss, params)))
        loss = loss.detach()
    else:
        d = pp.index
        chunks = [[p[j * S + d].detach() for p in leaves] for j in range(v)]

        def chunk_fn(j, h, params):
            return (stage_fn(unflatten(list(params)), h),)

        units = Units(chunk_fn, chunks, lambda m: (xm[m],),
                      loss=lambda m, ys: loss_fn(ys[0], tm[m]))
        with torch.enable_grad():
            run_schedule(make_schedule(schedule, S, M, v), pp, units,
                         [(tuple(xm.shape[1:]), xm.dtype)], x.device)
        local = (torch.stack(units.losses).sum() if units.losses
                 else torch.zeros((), device=x.device))
        loss = mc.preduce(local, pp) / M
        grads = unflatten([torch.stack([
            (units.grads[j][i] if units.grads[j][i] is not None
             else torch.zeros_like(chunks[j][i])) / M for j in range(v)])
            for i in range(len(leaves))])
    if b_ax is not None:
        loss = mc.preduce(loss, b_ax, Average)
        grads = _dp_reduce(grads, b_ax, dp_reducer)
    return loss, grads


def pipeline_1f1b_apply(stage_fn: Callable, loss_fn: Callable, stage_params,
                        x: torch.Tensor, targets: torch.Tensor, mesh,
                        n_microbatches: int, axis_name: str = "pp",
                        batch_axis: Optional[str] = "dp",
                        dp_reducer: Optional[Callable] = None):
    """Array-level 1F1B: ``(mean_loss, grads)``. ``stage_params`` has the
    leading dim ``S``; ``grads`` is this rank's stage (leaves ``[1, ...]``,
    the row ``pp.index`` of the stacked gradient), at the scale of the
    gradient of the microbatch-mean loss, averaged over ``batch_axis``
    (``dp_reducer``, e.g. the bucketed sync, or one dense pmean a leaf).
    With a pp axis of 1 the grads are the whole stack."""
    S = mesh.axis(axis_name).size
    _check_stacked(stage_params, S, axis_name,
                   f"the '{axis_name}' mesh axis size")
    return _run_array("1f1b", stage_fn, loss_fn, stage_params, x, targets,
                      mesh, n_microbatches, 1, axis_name, batch_axis,
                      dp_reducer)


def pipeline_interleaved_apply(stage_fn: Callable, loss_fn: Callable,
                               stage_params, x: torch.Tensor,
                               targets: torch.Tensor, mesh,
                               n_microbatches: int, virtual_stages: int = 2,
                               axis_name: str = "pp",
                               batch_axis: Optional[str] = "dp",
                               dp_reducer: Optional[Callable] = None):
    """Array-level interleaved 1F1B: ``stage_params`` has the leading dim
    ``V = virtual_stages · S`` in stage order (stage ``q`` is chunk
    ``q // S`` on pipeline position ``q % S``); ``grads`` holds this rank's
    chunks, leaves ``[v, ...]`` (chunk ``j`` = stage ``j·S + pp.index``),
    or the whole stack when the pp axis is 1. Scale and ``dp_reducer`` as
    in :func:`pipeline_1f1b_apply`."""
    v = int(virtual_stages)
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    S = mesh.axis(axis_name).size
    _check_stacked(stage_params, v * S, axis_name,
                   f"virtual_stages * {axis_name} size")
    return _run_array("interleaved", stage_fn, loss_fn, stage_params, x,
                      targets, mesh, n_microbatches, v, axis_name,
                      batch_axis, dp_reducer)
