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
trace), and :func:`annotate` / :func:`annotate_fn`, named ranges on the
trace (``torch.profiler.record_function``, where the JAX package uses
``jax.profiler.TraceAnnotation``); the library marks ``hvd.pack``,
``hvd.reduce``, ``hvd.accumulate`` and ``hvd.guard`` with them.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Iterator, Optional

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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range on the trace (NVTX-range analog)."""
    from torch.profiler import record_function
    with record_function(name):
        yield


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
