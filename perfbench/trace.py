"""The traced part of a ``--trace 1`` run: a few steady steps under
``torch.profiler``, twice (:func:`capture`), reduced in memory to what the
per-layer metrics read.

Ranges are opened from the benchmark's side, around the calls into a
layer, and never inside the program: forward pre- and post-hooks and full
backward pre- and post-hooks on the modules a configuration names (the
batch norms, the attention blocks), and step pre- and post-hooks on the
optimizer. A kernel belongs to a range when the host launched it inside
the range; the profiler books it there (a range's ``device_time_total``).

The reduction (:func:`reduce_events`) keeps:

* ``steps`` and ``window_s``: the traced steps, and the host-clock span
  from the synchronize before the first to the synchronize after the last;
* ``busy_s``: the union of the device's activity (kernels, copies, sets)
  in that span;
* ``launches`` and ``kernel_us``: the device operations, and their
  microseconds by name;
* ``range_us``: device microseconds inside each range tag;
* ``breakdown``: the result line's ten longest device operations and ten
  longest spans with nothing on the device, each named by the innermost
  host operation running at its middle.
"""

from __future__ import annotations

import time
from contextlib import ExitStack
from typing import Callable, Dict, List, Sequence

import torch

PREFIX = "perfbench."
_TOP = 10


class _Range:
    """A profiler range opened by one hook and closed by another, so it
    can span a module's backward pass."""

    def __init__(self, name: str):
        self.name, self.open = name, []

    def enter(self, *_):
        r = torch.autograd.profiler.record_function(self.name)
        r.__enter__()
        self.open.append(r)

    def exit(self, *_):
        if self.open:
            self.open.pop().__exit__(None, None, None)


def hook_ranges(stack: ExitStack, modules: Dict[str, Sequence[torch.nn.Module]],
                optimizer) -> None:
    """Register the ranges' hooks; ``stack`` removes them."""
    handles = []
    for tag, mods in modules.items():
        fwd, bwd = _Range(PREFIX + tag), _Range(PREFIX + tag)
        for m in mods:
            handles += [m.register_forward_pre_hook(fwd.enter),
                        m.register_forward_hook(fwd.exit),
                        m.register_full_backward_pre_hook(bwd.enter),
                        m.register_full_backward_hook(bwd.exit)]
    opt = _Range(PREFIX + "optimizer")
    handles += [optimizer.register_step_pre_hook(opt.enter),
                optimizer.register_step_post_hook(opt.exit)]
    stack.callback(lambda: [h.remove() for h in handles])


def _profiled(step: Callable[[int], None], first: int, steps: int,
              acts, barrier: Callable[[], None]):
    torch.cuda.synchronize()
    barrier()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            with torch.autograd.profiler.record_function(PREFIX + "step"):
                step(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return reduce_events(prof.events(), steps, window)


def capture(step: Callable[[int], None], steps: int,
            modules: Dict[str, Sequence[torch.nn.Module]], optimizer,
            barrier: Callable[[], None] = lambda: None) -> dict:
    """Two traced spans of ``steps`` steps each (``step(i)`` for ``i <
    2·steps``). The first records the device's activity alone, which
    costs the host little: the window, the busy time, the kernels. The
    second records the host's operations too, with the ranges hooked:
    each range's device time (a kernel's time does not change with the
    host's pace), and the names of the idle gaps (which the host's
    recording lengthens). Returns :func:`reduce_events`'s record."""
    cuda = [torch.profiler.ProfilerActivity.CUDA]
    both = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = _profiled(step, 0, steps, cuda, barrier)
    with ExitStack() as stack:
        hook_ranges(stack, modules, optimizer)
        ranged = _profiled(step, steps, steps, both, barrier)
    out["range_us"] = ranged["range_us"]
    out["breakdown"]["idle_gaps"] = ranged["breakdown"]["idle_gaps"]
    return out


def _union(intervals: List[List[float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, steps: int, window_s: float) -> dict:
    """What the readers need from the profiler's events (duck-typed:
    ``name``, ``device_type``, ``is_user_annotation``, ``time_range``,
    ``thread``, ``device_time_total``)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = [e for e in events
               if e.device_type == cuda and not e.is_user_annotation]
    kernel_us: Dict[str, float] = {}
    for e in kernels:
        kernel_us[e.name] = kernel_us.get(e.name, 0.0) \
            + e.time_range.elapsed_us()
    busy = _union([[e.time_range.start, e.time_range.end] for e in kernels])
    range_us: Dict[str, float] = {}
    host = []
    step_thread = None
    for e in events:
        if e.device_type != cpu:
            continue
        if e.name.startswith(PREFIX):
            tag = e.name[len(PREFIX):]
            range_us[tag] = range_us.get(tag, 0.0) + e.device_time_total
            if tag == "step":
                step_thread = e.thread
        host.append(e)
    gaps = [[busy[i][1], busy[i + 1][0]] for i in range(len(busy) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    main = [e for e in host if e.thread == step_thread]
    for a, b in gaps[:_TOP]:
        mid, best = (a + b) / 2, None
        for e in main:
            r = e.time_range
            if r.start <= mid <= r.end and (best is None
                                            or r.start >= best.time_range.start):
                best = e
        named.append([best.name if best is not None else "host: none",
                      (b - a) / 1e6])
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:_TOP]
    return {"steps": steps, "window_s": window_s,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "launches": len(kernels),
            "kernel_us": kernel_us, "range_us": range_us,
            "breakdown": {"device_ops": [[n[:160], us / 1e6] for n, us in top],
                          "idle_gaps": named}}
