"""Hang watchdog: a daemon thread that turns a silent stall into an
autopsy bundle.

A copy of ``horovod_tpu/diagnostics/watchdog.py``.

The reference's stall inspector logs a warning on rank 0 and (optionally)
aborts; at pod scale the job usually just sits there, every rank waiting
on a different thing, until a human attaches a debugger to N hosts.  The
watchdog watches step progress (fed by the train-loop telemetry
callbacks and any explicit :func:`notify_progress` call); when no
progress lands for ``HVD_TPU_WATCHDOG_SECONDS`` (default 600; ``0``
disarms) it writes an autopsy bundle
(:func:`horovod_tpu_torch.diagnostics.autopsy.write_autopsy`) — stacks
for every thread, flight-recorder ring, engine state, metrics snapshot,
merged timeline shards — and, on rank 0, every peer's evidence over the
exporter's ``/debug/*`` endpoints.

One bundle per stall: after triggering, the watchdog re-arms with the
trigger time as the new baseline, so a *persisting* hang produces one
bundle (plus one per subsequent watchdog period only if
``HVD_TPU_WATCHDOG_REPEAT=1``), not a bundle per check interval.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from horovod_tpu_torch.common.logging import get_logger

DEFAULT_TIMEOUT_S = 600.0


def _env_timeout() -> float:
    from horovod_tpu_torch.common.config import env_float
    return env_float("WATCHDOG_SECONDS", DEFAULT_TIMEOUT_S)


class Watchdog:
    """Progress watchdog with an autopsy trigger.

    Args:
      timeout_s: no-progress window before triggering; default from
        ``HVD_TPU_WATCHDOG_SECONDS``; <= 0 means the watchdog never
        starts (``start()`` is a no-op).
      autopsy_dir: bundle directory (default ``HVD_TPU_AUTOPSY_DIR``).
      on_trigger: replaces the default autopsy writer (tests).
      check_interval_s: poll period (default ``min(timeout/4, 10)``).
    """

    def __init__(self, timeout_s: Optional[float] = None,
                 autopsy_dir: Optional[str] = None,
                 on_trigger: Optional[Callable[[str], None]] = None,
                 check_interval_s: Optional[float] = None) -> None:
        self.timeout_s = _env_timeout() if timeout_s is None \
            else float(timeout_s)
        self.autopsy_dir = autopsy_dir
        self._on_trigger = on_trigger
        self._interval = check_interval_s or max(
            0.05, min(self.timeout_s / 4.0, 10.0))
        self._last_progress = time.monotonic()
        self._last_step: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.trigger_count = 0
        self.last_bundle: Optional[str] = None
        self._repeat = os.environ.get(
            "HVD_TPU_WATCHDOG_REPEAT", "") not in ("", "0")

    @property
    def armed(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Watchdog":
        if self.timeout_s <= 0 or self.armed:
            return self
        self._last_progress = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def notify_progress(self, step: Optional[int] = None) -> None:
        """Record a unit of forward progress (a completed train step, a
        committed checkpoint, ...). Cheap enough for hot loops."""
        self._last_progress = time.monotonic()
        if step is not None:
            self._last_step = step

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            idle = time.monotonic() - self._last_progress
            if idle <= self.timeout_s:
                continue
            self.trigger(f"no step progress for {idle:.0f}s "
                         f"(threshold {self.timeout_s:.0f}s, last step "
                         f"{self._last_step})")
            if not self._repeat:
                # a persisting hang: one bundle, then only log
                self._last_progress = time.monotonic() + self.timeout_s * 99
            else:
                self._last_progress = time.monotonic()

    def trigger(self, reason: str) -> Optional[str]:
        """Fire the autopsy now (also callable directly, e.g. from a
        signal handler). Returns the bundle path (None with a custom
        ``on_trigger``)."""
        self.trigger_count += 1
        get_logger().error("watchdog triggered: %s", reason)
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event("watchdog_trigger", reason=reason)
        if self._on_trigger is not None:
            try:
                self._on_trigger(reason)
            except Exception as e:
                get_logger().warning("watchdog on_trigger failed: %r", e)
            return None
        try:
            from horovod_tpu_torch.diagnostics.autopsy import write_autopsy
            self.last_bundle = write_autopsy(self.autopsy_dir, reason)
        except Exception as e:
            get_logger().warning("watchdog autopsy failed: %r", e)
        return self.last_bundle


_WATCHDOG: Optional[Watchdog] = None
_SUSPENDED = False
_LOCK = threading.Lock()
# module-level progress stamp, kept even when no watchdog is armed —
# /healthz reports last-step age regardless of autopsy configuration
_LAST_PROGRESS_TS: Optional[float] = None
_LAST_STEP: Optional[int] = None


def ensure_watchdog() -> Optional[Watchdog]:
    """The process-wide watchdog, started on first call (armed by
    default from the train callbacks). Returns None when disarmed
    (``HVD_TPU_WATCHDOG_SECONDS=0``)."""
    global _WATCHDOG, _SUSPENDED
    with _LOCK:
        if _WATCHDOG is None:
            wd = Watchdog()
            if wd.timeout_s <= 0:
                return None
            _WATCHDOG = wd.start()
        _SUSPENDED = False
        return _WATCHDOG


def notify_progress(step: Optional[int] = None) -> None:
    """Feed the process-wide watchdog (no-op when none is armed) and
    stamp the module-level liveness clock either way."""
    global _LAST_PROGRESS_TS, _LAST_STEP
    _LAST_PROGRESS_TS = time.monotonic()
    if step is not None:
        _LAST_STEP = step
    wd = _WATCHDOG
    if wd is not None:
        wd.notify_progress(step)


def liveness() -> dict:
    """What ``/healthz`` reports beyond process-up: watchdog armed
    state + configured threshold, the last completed step and how long
    ago progress was last stamped (None before the first stamp — a
    process still compiling is not 'stalled')."""
    wd = _WATCHDOG
    age = None if _LAST_PROGRESS_TS is None \
        else time.monotonic() - _LAST_PROGRESS_TS
    return {"armed": bool(wd is not None and wd.armed),
            "timeout_s": _env_timeout(),
            "last_step": _LAST_STEP,
            "last_step_age_s": round(age, 3) if age is not None else None}


def suspend() -> None:
    """Stop the watchdog across a world teardown but REMEMBER it was
    armed (``hvd.shutdown``): an elastic shutdown→init cycle must not
    silently disarm hang detection for the recovered world."""
    global _SUSPENDED
    with _LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
            _SUSPENDED = True


def resume() -> None:
    """Re-arm a suspended watchdog with a fresh baseline
    (``hvd.init`` after an elastic re-mesh)."""
    with _LOCK:
        if _SUSPENDED and _WATCHDOG is not None:
            _WATCHDOG.notify_progress()
            _WATCHDOG.start()


def reset() -> None:
    """Stop and drop the process-wide watchdog (tests)."""
    global _WATCHDOG, _SUSPENDED, _LAST_PROGRESS_TS, _LAST_STEP
    with _LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
            _WATCHDOG = None
        _SUSPENDED = False
        _LAST_PROGRESS_TS = None
        _LAST_STEP = None
