"""The program's own spans, read from the benchmark's side: the step's
phases on the host clock and, under the profiler, what each phase
launched on the card, each rank's collective kernels on the wall clock,
and the wait of one rank for the others.

The program opens ``hvd.step`` around ``hvd.forward``, ``hvd.backward``,
``hvd.sync_grads`` and ``hvd.optimizer``, and each gradient bucket's
``hvd.pack``, ``hvd.reduce`` and ``hvd.unpack``
(``horovod_tpu_torch.profiling``): ``torch.profiler`` ranges while a
profiler runs, kept in memory under ``profiling.record_spans()``.

:func:`capture` is ``trace.capture`` with these spans read too, and
:func:`report` turns every rank's record into the readings; ``spans_run.py``
runs a cell with both in place of the harness's own. What they keep, in
the record's ``trace``:

* from the host steps before the profiler (an idle card, alternately
  without and with the recorder): ``host_ms_off``, ``host_ms_on`` and
  ``host_spans`` (:func:`phase_ms`, milliseconds a step of each phase);
* from the first traced span (device activity only): ``collectives``,
  the collective kernels on the wall clock (:func:`collectives`), for
  :func:`cross_rank_waits`;
* from the second (the host's operations too): :func:`program_events`'
  keys, each device operation booked to every program span whose host
  interval holds its launch call, from any thread (backward launches
  from autograd's).

The readings (:func:`readings`, :data:`METRICS`): ``host_forward_ms``,
``host_backward_ms``, ``host_sync_ms`` and ``host_optimizer_ms`` (the
median of ``host_spans``), ``sync_grads_ms`` (device milliseconds a step
launched inside ``hvd.sync_grads``), ``launches_per_step`` and
``host_syncs_per_step`` (device operations and host syncs inside
``hvd.step``, a step) and, across ranks, ``collective_wait_ms``.
"""

from __future__ import annotations

import bisect
import statistics
import time
from contextlib import ExitStack
from typing import Callable, Dict, List, Optional, Sequence

import torch

from perfbench import trace

PROGRAM = "hvd."
STEP = PROGRAM + "step"
PHASES = {"host_forward_ms": "hvd.forward", "host_backward_ms": "hvd.backward",
          "host_sync_ms": "hvd.sync_grads", "host_optimizer_ms": "hvd.optimizer"}
METRICS = (*PHASES, "sync_grads_ms", "launches_per_step",
           "host_syncs_per_step", "collective_wait_ms")
SYNCS = frozenset({"cudaDeviceSynchronize", "cudaStreamSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
ALIGNED_US = 100.0   # matched all-reduce kernels end within this across ranks
HOST_PAIRS = 6       # host steps timed without and with the recorder, each


def _profiled(step: Callable[[int], None], first: int, steps: int,
              acts, barrier: Callable[[], None]):
    """``trace._profiled``'s window, keeping the events, and the trace's
    start on the wall clock (ns; None where the profiler does not say)."""
    torch.cuda.synchronize()
    barrier()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            with torch.autograd.profiler.record_function(trace.PREFIX
                                                         + "step"):
                step(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    try:
        start_ns = prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        start_ns = None
    return prof.events(), window, start_ns


def host_phases(step: Callable[[int], None], pairs: int = HOST_PAIRS) -> dict:
    """Steps started on an idle card, alternately without and with the
    program's spans recorded: each side's host milliseconds and the
    phases of the recorded ones (``{}`` where the program cannot
    record)."""
    from horovod_tpu_torch import profiling
    record = getattr(profiling, "record_spans", None)
    off, on, phases = [], [], []
    for k in range(2 * pairs):
        recorded = record is not None and k % 2 == 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        if recorded:
            with record() as rec:
                step(k)
            phases.append(phase_ms(rec.spans))
        else:
            step(k)
        (on if recorded else off).append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    names = sorted({n for p in phases for n in p})
    return {"host_ms_off": off, "host_ms_on": on,
            "host_spans": {n: [x for p in phases for x in p.get(n, [0.0])]
                           for n in names}}


def capture(step: Callable[[int], None], steps: int,
            modules: Dict[str, Sequence[torch.nn.Module]], optimizer,
            barrier: Callable[[], None] = lambda: None) -> dict:
    """``trace.capture``'s record, the same two traced spans of ``steps``
    steps, after :func:`host_phases` (on the steps' own batches), with
    ``collectives`` from the first span and :func:`program_events`' keys
    from the second."""
    host = host_phases(step)
    cuda = [torch.profiler.ProfilerActivity.CUDA]
    both = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    events, window, start_ns = _profiled(step, 0, steps, cuda, barrier)
    out = trace.reduce_events(events, steps, window)
    out["collectives"] = collectives(events, start_ns)
    with ExitStack() as stack:
        trace.hook_ranges(stack, modules, optimizer)
        events, window, _ = _profiled(step, steps, steps, both, barrier)
    ranged = trace.reduce_events(events, steps, window)
    out["range_us"] = ranged["range_us"]
    out["breakdown"]["idle_gaps"] = ranged["breakdown"]["idle_gaps"]
    out.update(program_events(events))
    out.update(host)
    return out


def _device_ops(events) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events
            if e.device_type == cuda and not e.is_user_annotation]


def _is_collective(name: str) -> bool:
    return "nccl" in name.lower()


class _Intervals:
    """A union of host intervals, for membership by bisection."""

    def __init__(self, intervals: List[List[float]]):
        self.spans = trace._union(intervals)
        self.starts = [a for a, _ in self.spans]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def program_events(events) -> dict:
    """The program's spans (host events named ``hvd.*``) against the
    device operations and the host's syncs: each device operation is
    booked, by the host time of its launch call (the runtime event of
    the same correlation id), to every span name one of whose intervals
    holds it. A sync is a runtime call in ``SYNCS``. Returns
    ``program_steps`` (the ``hvd.step`` spans), ``program_us``,
    ``program_launches`` and ``program_syncs`` by span name,
    ``program_unbooked`` (device operations whose launch call the trace
    lacks), ``sync_sites`` (where each sync inside a step was called),
    ``collective_spans`` (the innermost span that launched each
    collective kernel, in the order they ran) and ``collective_us``
    (their device microseconds by that span)."""
    cpu = torch.autograd.DeviceType.CPU
    spans: Dict[str, list] = {}
    runtime: Dict[int, float] = {}
    syncs, host = [], []
    for e in events:
        if e.device_type != cpu:
            continue
        r = e.time_range
        if e.name.startswith(PROGRAM) and e.is_user_annotation:
            spans.setdefault(e.name, []).append([r.start, r.end])
        elif e.name.startswith("cu"):
            runtime[e.id] = r.start
            if e.name in SYNCS:
                syncs.append(e)
        elif not e.is_user_annotation:
            host.append(e)
    if STEP not in spans:
        return {"program_steps": 0}
    within = {n: _Intervals(iv) for n, iv in spans.items()}
    us = dict.fromkeys(spans, 0.0)
    launches = dict.fromkeys(spans, 0)
    calls = dict.fromkeys(spans, 0)
    coll, coll_us, unbooked = [], {}, 0
    for k in sorted(_device_ops(events), key=lambda e: e.time_range.start):
        t = runtime.get(k.id)
        if t is None:
            unbooked += 1
            continue
        for n, iv in within.items():
            if t in iv:
                us[n] += k.time_range.elapsed_us()
                launches[n] += 1
        if _is_collective(k.name):
            coll.append(_innermost(spans, t))
            coll_us[coll[-1]] = coll_us.get(coll[-1], 0.0) \
                + k.time_range.elapsed_us()
    sites: Dict[str, int] = {}
    for e in syncs:
        t = e.time_range.start
        for n, iv in within.items():
            if t in iv:
                calls[n] += 1
        if t in within[STEP]:
            # the innermost program span, then the outermost and the
            # innermost operation around the call on its thread
            ops = sorted((h for h in host if h.thread == e.thread
                          and h.time_range.start <= t <= h.time_range.end),
                         key=lambda h: h.time_range.start)
            where = [_innermost(spans, t)] + [h.name for h in ops[:1]]
            if len(ops) > 1:
                where.append(ops[-1].name)
            site = " > ".join(where + [e.name])
            sites[site] = sites.get(site, 0) + 1
    return {"program_steps": len(spans[STEP]), "program_us": us,
            "program_launches": launches, "program_syncs": calls,
            "program_unbooked": unbooked, "sync_sites": sites,
            "collective_spans": coll, "collective_us": coll_us}


def _innermost(spans: Dict[str, list], t: float) -> Optional[str]:
    best, start = None, None
    for n, iv in spans.items():
        for a, b in iv:
            if a <= t <= b and (start is None or a >= start):
                best, start = n, a
    return best


def collectives(events, start_ns: Optional[int]) -> Optional[list]:
    """The collective kernels (NCCL's, by name), in the order they ran,
    as ``[start_ns, end_ns, name]`` on the wall clock: the profiler's
    times (us from the trace's start) plus the trace's start. None when
    the trace's start is unknown."""
    if start_ns is None:
        return None
    out = []
    for k in _device_ops(events):
        if _is_collective(k.name):
            r = k.time_range
            out.append([start_ns + round(r.start * 1e3),
                        start_ns + round(r.end * 1e3), k.name[:160]])
    return sorted(out)


def cross_rank_waits(per_rank: List[Optional[list]],
                     labels: Optional[list] = None) -> Optional[dict]:
    """Each rank's time in collective kernels before the last rank's
    matching kernel started: the k-th collective kernel of every rank is
    matched (every rank launches the same collectives in one order), and
    rank r's kernel k waited ``min(end, last start) − start``. The clocks
    are checked on the matched all-reduce kernels, which end together on
    every rank: ``aligned`` when the median spread of their ends is
    within ``ALIGNED_US``. ``labels``, the span that launched each
    kernel (one a kernel), splits the wait over the ranks' mean. None
    when a rank has no record or the ranks' counts differ."""
    if not per_rank or any(not c for c in per_rank) \
            or len({len(c) for c in per_rank}) != 1:
        return None
    wait_ns = [0] * len(per_rank)
    if labels is not None and len(labels) != len(per_rank[0]):
        labels = None
    by_span: Dict[str, float] = {}
    spread = []
    for k, matched in enumerate(zip(*per_rank)):
        last = max(c[0] for c in matched)
        for r, (a, b, _) in enumerate(matched):
            w = max(0, min(b, last) - a)
            wait_ns[r] += w
            if labels:
                tag = str(labels[k])
                by_span[tag] = by_span.get(tag, 0.0) + w / len(per_rank)
        if "allreduce" in matched[0][2].lower():
            ends = [c[1] for c in matched]
            spread.append(max(ends) - min(ends))
    med = statistics.median(spread) / 1e3 if spread else None
    return {"wait_us": [w / 1e3 for w in wait_ns],
            "wait_us_by_span": {k: v / 1e3 for k, v in by_span.items()},
            "matched": len(per_rank[0]),
            "end_spread_us_median": med,
            "end_spread_us_max": max(spread) / 1e3 if spread else None,
            "aligned": med is not None and med <= ALIGNED_US}


def phase_ms(spans) -> Dict[str, List[float]]:
    """Milliseconds a step of each of the step's spans, from
    ``profiling.record_spans``' spans: ``hvd.step``'s own, and for each
    name its children carry, their sum in each step."""
    steps = [s for s in spans if s.name == STEP]
    out: Dict[str, List[float]] = {STEP: [(s.end_ns - s.start_ns) / 1e6
                                          for s in steps]}
    index = {s.id: i for i, s in enumerate(steps)}
    for s in spans:
        if s.parent in index:
            row = out.setdefault(s.name, [0.0] * len(steps))
            row[index[s.parent]] += (s.end_ns - s.start_ns) / 1e6
    return out


def readings(t: Optional[dict]) -> Dict[str, float]:
    """One rank's readings from its ``trace`` (:func:`capture`'s); a
    reading with nothing to read is left out."""
    out: Dict[str, float] = {}
    if not t:
        return out
    for name, span in PHASES.items():
        ms = t.get("host_spans", {}).get(span)
        if ms:
            out[name] = statistics.median(ms)
    n = t.get("program_steps")
    if n:
        if "hvd.sync_grads" in t["program_us"]:
            out["sync_grads_ms"] = t["program_us"]["hvd.sync_grads"] / 1e3 / n
        out["launches_per_step"] = t["program_launches"][STEP] / n
        out["host_syncs_per_step"] = t["program_syncs"][STEP] / n
    return out


def report(records: List[dict]) -> dict:
    """Every rank's readings, their mean over the ranks, and across ranks
    the collective waits (``collective_wait_ms`` where the clocks
    agree), the cost of recording, and rank 0's sync sites."""
    records = sorted(records, key=lambda r: r["rank"])
    traces = [r.get("trace") or {} for r in records]
    per_rank = [readings(t) for t in traces]
    waits = None
    if len(records) > 1:
        waits = cross_rank_waits([t.get("collectives") for t in traces],
                                 traces[0].get("collective_spans"))
        if waits is not None and waits["aligned"]:
            for x, t, us in zip(per_rank, traces, waits["wait_us"]):
                x["collective_wait_ms"] = us / 1e3 / t["steps"]
    mean = {m: statistics.fmean(x[m] for x in per_rank) for m in METRICS
            if per_rank and all(m in x for x in per_rank)}
    t0 = traces[0]
    return {"metrics": mean, "per_rank": per_rank, "collectives": waits,
            "host_ms_off": t0.get("host_ms_off"),
            "host_ms_on": t0.get("host_ms_on"),
            "host_spans": t0.get("host_spans"),
            "sync_sites": t0.get("sync_sites"),
            "program_us": t0.get("program_us"),
            "program_launches": t0.get("program_launches"),
            "program_unbooked": t0.get("program_unbooked"),
            "collective_us": t0.get("collective_us")}
