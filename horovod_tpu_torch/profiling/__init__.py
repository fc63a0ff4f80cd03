"""Deep-profiling subsystem: evidence of *why*, captured exactly when
the cheap always-on layer says something is wrong.

Mirrors ``horovod_tpu/profiling/__init__.py``. Layers:

* :mod:`horovod_tpu_torch.profiling.manager` — bounded, step-windowed
  ``torch.profiler`` device traces (scheduled, or fired by the anomaly
  engine);
* :mod:`horovod_tpu_torch.profiling.compile_watch` — the ``nvcc`` builds
  of the kernel libraries as compile metrics;
* :mod:`horovod_tpu_torch.profiling.memory` — the card's memory gauges
  and the ``hbm_growth`` slow-leak detector;
* :mod:`horovod_tpu_torch.profiling.attribution` — ``1 − MFU`` split over
  the goodput ledger's categories.

This package owns the two cross-cutting seams:

* the **step seam** — :func:`on_step_begin` / :func:`on_step_end`,
  called by :class:`horovod_tpu_torch.train.callbacks.StepTimer` on every
  step (cheap no-ops unless a capture is pending/active or the memory
  sampler has a card to read);
* the **anomaly seam** — :func:`on_anomaly`, called by the anomaly
  engine for every finding: when ``HVD_TPU_PROFILE_ON_ANOMALY`` is on
  (default), a finding arms a capture of the next
  ``HVD_TPU_PROFILE_STEPS`` steps and stamps the planned trace path
  into the finding itself.

Also here: :func:`start_trace` / :func:`stop_trace` / :func:`trace`, one
unmanaged trace into a directory of the caller's (``<log_dir>/trace.json``,
a Chrome trace like a capture's, where the JAX package writes an XProf
trace), and :func:`annotate` / :func:`annotate_fn`, named spans
(``torch.profiler.record_function`` while a profiler runs, where the JAX
package uses ``jax.profiler.TraceAnnotation``). A span costs one call and
one flag test when neither a profiler nor :func:`record_spans` is on.
The library marks with them the phases of every train step
(:func:`train_step`: ``hvd.step`` around ``hvd.forward``,
``hvd.backward``, ``hvd.sync_grads`` and ``hvd.optimizer``), each
gradient bucket's ``hvd.pack``, ``hvd.reduce`` (issuing its collective) and
``hvd.unpack`` (its wait and unpack), the microbatch sums
(``hvd.accumulate``) and the guard's verdict (``hvd.guard``).
:func:`record_spans` keeps the spans in memory on the host clock, without
a profiler.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Any, Callable, Iterator, List, NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

from horovod_tpu_torch.profiling.manager import (ProfileManager,
                                                 default_manager,
                                                 profile_dir, start_profiler,
                                                 stop_profiler)
from horovod_tpu_torch.profiling import compile_watch, memory

__all__ = [
    "ProfileManager", "default_manager", "profile_dir",
    "compile_watch", "memory",
    "on_step_begin", "on_step_end", "on_anomaly",
    "recent_captures", "finalize_open_capture", "reset",
    "start_trace", "stop_trace", "trace", "annotate", "annotate_fn",
    "record_spans", "Span", "SpanRecorder", "train_step",
]


# -- step seam (called from StepTimer; must never raise) ---------------------
def on_step_begin(step: int) -> None:
    try:
        default_manager().on_step_begin(step)
    except Exception:
        pass


def on_step_end(step: int) -> None:
    try:
        default_manager().on_step_end(step)
    except Exception:
        pass
    try:
        finding = memory.default_sampler().on_step(step)
        if finding is not None:
            from horovod_tpu_torch.metrics.anomaly import report_finding
            report_finding(**finding)
    except Exception:
        pass


# -- anomaly seam (called from AnomalyEngine._flag) --------------------------
def on_anomaly(finding: dict) -> Optional[dict]:
    """A fresh anomaly finding: arm a rate-limited capture of the next
    K steps and stamp the planned path into the finding (the engine
    stores the same dict, so the path shows up in
    ``recent_findings()`` and the flight event)."""
    from horovod_tpu_torch.profiling.manager import on_anomaly_enabled
    if not on_anomaly_enabled():
        return None
    try:
        info = default_manager().request_capture(
            reason=f"anomaly:{finding.get('kind', 'unknown')}",
            trigger=finding, rate_limited=True)
    except Exception:
        return None
    if info is not None:
        finding["profile"] = info["path"]
    return info


def recent_captures() -> list:
    """Completed (and aborted-but-flushed) capture records."""
    from horovod_tpu_torch.profiling import manager as _m
    mgr = _m._MANAGER
    return mgr.recent_captures() if mgr is not None else []


def finalize_open_capture(reason: str = "aborted") -> Optional[dict]:
    """Close a mid-window capture NOW (end-of-run paths): a job that
    degraded, started its trace, and then stopped still keeps the
    trace."""
    from horovod_tpu_torch.profiling import manager as _m
    mgr = _m._MANAGER
    return mgr.finalize_open_capture(reason) if mgr is not None else None


def reset() -> None:
    """Drop process-wide state so env is re-read (tests, re-init)."""
    from horovod_tpu_torch.profiling import manager as _m
    _m.reset()
    memory.reset()
    compile_watch.reset_counts()


# the trace that start_trace opened: one a process, as jax.profiler's
_trace_lock = threading.Lock()
_open_trace: list = []   # [(profiler, log_dir)] while one is open


def start_trace(log_dir: str) -> None:
    """Begin a device trace of everything this process runs until
    :func:`stop_trace`, which writes it as ``<log_dir>/trace.json`` (the
    device-side counterpart of ``hvd.start_timeline``).  Prefer
    :class:`ProfileManager` for bounded, managed captures.  Raises if a
    trace is open already."""
    with _trace_lock:
        if _open_trace:
            raise RuntimeError("a trace is already open (start_trace)")
        _open_trace.append((start_profiler(), log_dir))


def stop_trace() -> None:
    """End the trace :func:`start_trace` opened and write it.  Raises if
    none is open."""
    with _trace_lock:
        if not _open_trace:
            raise RuntimeError("no trace is open (start_trace)")
        prof, log_dir = _open_trace.pop()
    stop_profiler(prof, log_dir)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


# -- spans: the step's phases on the profiler's clock, or kept in memory -------

class Span(NamedTuple):
    """One closed span: ``parent`` is the ``id`` of the span that was open
    on the same thread when it opened (None at the top), ``start_ns`` and
    ``end_ns`` are ``time.monotonic_ns()`` readings."""
    id: int
    name: str
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


class SpanRecorder:
    """The spans :func:`record_spans` keeps: at most ``limit``, the rest
    counted in ``dropped``. ``anchor`` is a ``(wall s, monotonic s)`` pair
    read when recording began (:func:`~horovod_tpu_torch.diagnostics.clock.
    wall_monotonic_pair`): a span's wall time is ``anchor[0] + start_ns /
    1e9 - anchor[1]``. ``spans`` is filled when the recording closes."""

    def __init__(self, limit: int):
        from horovod_tpu_torch.diagnostics.clock import wall_monotonic_pair
        self.limit, self.dropped = limit, 0
        self.anchor = wall_monotonic_pair()
        self.spans: List[Span] = []
        self._kept: List[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._stacks = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._stacks, "ids", None)
        if stack is None:
            stack = self._stacks.ids = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._kept) < self.limit:
                self._kept.append(span)
            else:
                self.dropped += 1


_recorder: Optional[SpanRecorder] = None
_recorder_lock = threading.Lock()


class _Span:
    __slots__ = ("name", "rec", "range", "id", "parent", "start")

    def __init__(self, name: str, rec: Optional[SpanRecorder]):
        self.name, self.rec, self.range = name, rec, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        if self.rec is not None:
            stack = self.rec._stack()
            self.parent = stack[-1] if stack else None
            self.id = next(self.rec._ids)
            stack.append(self.id)
            self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            end = time.monotonic_ns()
            self.rec._stack().pop()
            self.rec._keep(Span(self.id, self.name, self.parent,
                                threading.get_ident(), self.start, end))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named span, for ``with``: a ``torch.profiler.record_function``
    range while a profiler runs (on the device trace's clock, booking the
    kernels its thread launches), kept by the open :func:`record_spans`
    too. With neither on it is one shared no-op context."""
    rec = _recorder
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, rec)


@contextlib.contextmanager
def record_spans(limit: int = 1 << 16) -> Iterator[SpanRecorder]:
    """Keep every span the process opens, on any thread, while the block
    runs; the yielded :class:`SpanRecorder` holds them (at most ``limit``,
    the rest counted) once it closes. One recording at a time."""
    global _recorder
    rec = SpanRecorder(limit)
    with _recorder_lock:
        if _recorder is not None:
            raise RuntimeError("spans are already being recorded "
                               "(record_spans)")
        _recorder = rec
    try:
        yield rec
    finally:
        with _recorder_lock:
            _recorder = None
        with rec._lock:
            rec.spans = sorted(rec._kept, key=lambda s: s.start_ns)
            rec._kept = []


def train_step(forward: Callable[[], Any], sync: Callable[[], None],
               update: Callable[[], Any]):
    """One optimizer step in its spans, the train-step factories' shared
    frame: ``hvd.step`` around ``hvd.forward`` (``forward() -> (objective,
    out)``, the model and the loss), ``hvd.backward``
    (``objective.backward()``), ``hvd.sync_grads`` (``sync()``) and
    ``hvd.optimizer`` (``update()``). Returns ``out``."""
    with annotate("hvd.step"):
        with annotate("hvd.forward"):
            objective, out = forward()
        with annotate("hvd.backward"):
            objective.backward()
        with annotate("hvd.sync_grads"):
            sync()
        with annotate("hvd.optimizer"):
            update()
    return out


def annotate_fn(name: Optional[str] = None):
    """Decorator form: ``@annotate_fn("allreduce.grads")``."""
    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any):
            with annotate(label):
                return fn(*args, **kwargs)
        return wrapped
    return deco
