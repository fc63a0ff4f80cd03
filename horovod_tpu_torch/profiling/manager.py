"""ProfileManager: bounded, programmatic ``torch.profiler`` device traces.

A copy of ``horovod_tpu/profiling/manager.py`` with ``jax.profiler``
replaced by ``torch.profiler``. The always-on observability layers are
cheap by design and can only say *that* something is wrong; the device
trace says *why*, but it is far too heavy to leave running. This manager
makes capture an *event*, not a mode: a capture is a **window measured in
steps**, opened at the next step boundary and closed after N completed
steps, with two drivers:

* scheduled — ``TelemetryCallback(profile_steps=N)`` captures the first
  N steps of training;
* **automatic** — the anomaly engine's findings
  (:mod:`horovod_tpu_torch.metrics.anomaly`) trigger a capture of the next
  ``HVD_TPU_PROFILE_STEPS`` steps;
* **on demand** — ``GET /debug/profile?steps=N`` on the worker exporter
  (:mod:`horovod_tpu_torch.metrics.exporter`) arms a capture from the
  HTTP thread; the window itself opens on the training thread.

A capture is one ``torch.profiler.profile`` with the CPU activity and, when
the process has a card, the CUDA one (CUPTI): opened at ``on_step_begin``,
closed at the window's last ``on_step_end``, and exported as a Chrome trace
(``trace.json``) into the capture directory. Kernels launched inside the
window, the hand-written ones included, appear in it by name.

Bounded by construction: one capture at a time, anomaly-triggered
captures rate-limited to one per ``HVD_TPU_PROFILE_COOLDOWN_S``
(findings already carry per-episode hysteresis — together: one capture
per anomaly episode), and total retention under ``HVD_TPU_PROFILE_DIR``
size-rotated to ``HVD_TPU_PROFILE_MAX_BYTES`` (oldest captures deleted
first, the newest always kept).  Every completed capture lands as a
``profile_captured`` flight event, an ``hvd_profile_captures_total``
counter tick, and a record in :meth:`ProfileManager.recent_captures`.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_PROFILE_STEPS = 5
DEFAULT_MAX_BYTES = 256 * 1024 * 1024
DEFAULT_COOLDOWN_S = 300.0
MAX_CAPTURE_RECORDS = 64


def profile_dir() -> str:
    """``HVD_TPU_PROFILE_DIR`` (default ``./hvd_profile`` — gitignored).
    Read live: re-init and tests change env under a long-lived process."""
    from horovod_tpu_torch.common.config import env_str
    return env_str("PROFILE_DIR") or os.path.join(os.getcwd(),
                                                  "hvd_profile")


def default_steps() -> int:
    from horovod_tpu_torch.common.config import env_int
    return max(1, env_int("PROFILE_STEPS", DEFAULT_PROFILE_STEPS))


def on_anomaly_enabled() -> bool:
    from horovod_tpu_torch.common.config import env_bool
    return env_bool("PROFILE_ON_ANOMALY", True)


def _env_float(name: str, default: float) -> float:
    from horovod_tpu_torch.common.config import env_float
    return env_float(name, default)


def _env_int(name: str, default: int) -> int:
    from horovod_tpu_torch.common.config import env_int
    return env_int(name, default)


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _best_effort_rank() -> int:
    from horovod_tpu_torch.diagnostics.flight_recorder import _best_effort_rank
    return _best_effort_rank()


class ProfileManager:
    """Step-windowed trace capture with retention and rate limiting.

    Thread-safe: requests may arrive from any thread (the anomaly
    engine); the profiler itself is only started/stopped on the training
    thread via the :meth:`on_step_begin` / :meth:`on_step_end` seam (a
    profiler is process-global and must not be toggled concurrently with
    the steps it measures).
    """

    def __init__(self, directory: Optional[str] = None,
                 registry=None) -> None:
        self._dir_opt = directory
        self._reg = registry
        self._lock = threading.Lock()
        self._pending: Optional[Dict[str, Any]] = None
        self._active: Optional[Dict[str, Any]] = None
        self._last_anomaly_capture = 0.0
        self.captures: List[dict] = []
        self.dropped_requests = 0
        self._prof = None          # the open torch.profiler.profile
        self._prof_path: Optional[str] = None

    # -- env/config -----------------------------------------------------------
    @property
    def directory(self) -> str:
        return self._dir_opt or profile_dir()

    def _registry(self):
        if self._reg is None:
            from horovod_tpu_torch.metrics.registry import default_registry
            self._reg = default_registry()
        return self._reg

    # -- request side ---------------------------------------------------------
    def request_capture(self, steps: Optional[int] = None,
                        reason: str = "on_demand",
                        trigger: Optional[dict] = None,
                        rate_limited: bool = False) -> Optional[dict]:
        """Arm a capture of the next ``steps`` completed steps; returns
        the planned capture record (its ``path`` is where the trace will
        land) or ``None`` when refused (a capture is already pending /
        active, or — for ``rate_limited=True`` callers, the anomaly
        trigger — the cooldown has not elapsed)."""
        steps = int(steps) if steps else default_steps()
        if steps <= 0:
            return None
        now = time.time()
        with self._lock:
            if self._pending is not None or self._active is not None:
                self.dropped_requests += 1
                return None
            if rate_limited:
                cooldown = _env_float("PROFILE_COOLDOWN_S",
                                      DEFAULT_COOLDOWN_S)
                if now - self._last_anomaly_capture < cooldown:
                    self.dropped_requests += 1
                    return None
                # the cooldown is charged when the trace actually
                # STARTS (on_step_begin): a capture that fails to open
                # (unwritable dir, profiler busy) must not burn the
                # episode's only window for the next PROFILE_COOLDOWN_S
            rank = _best_effort_rank()
            path = os.path.join(
                self.directory,
                f"capture_{time.strftime('%Y%m%d_%H%M%S')}"
                f"_{int(now * 1000) % 1000:03d}_rank{rank}")
            self._pending = {"path": path, "steps": steps,
                            "reason": reason, "requested_at": now,
                            "trigger": trigger,
                            "rate_limited": bool(rate_limited)}
            return dict(self._pending)

    # -- step seam (training thread) ------------------------------------------
    def on_step_begin(self, step: int) -> None:
        with self._lock:
            req, self._pending = self._pending, None
            if req is None:
                return
            # claim the slot in the same critical section: between
            # consuming the request and starting the trace a concurrent
            # request_capture must still see the manager busy, or its
            # accepted capture (and a rate-limited caller's cooldown
            # credit) would be silently lost to "already tracing"
            req["first_step"] = int(step)
            req["remaining"] = req["steps"]
            req["started_at"] = time.time()
            req["started"] = False
            self._active = req
        try:
            os.makedirs(req["path"], exist_ok=True)
            self._start_trace(req["path"])
        except Exception as e:  # profiler busy / unwritable dir: degrade
            self._prof = None
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("profile capture could not start: %r", e)
            with self._lock:
                if self._active is req:
                    self._active = None
            return
        with self._lock:
            if self._active is req:
                req["started"] = True
        if req.get("started") is not True:
            # finalize_open_capture/reset raced us between the claim
            # and the trace start and dropped the (then trace-less)
            # record: the capture is abandoned — close the trace we
            # just opened or the profiler runs unbounded forever and
            # every later capture fails with "already active"
            try:
                self._stop_trace()
            except Exception:
                pass
            return
        if req.get("rate_limited"):
            with self._lock:
                self._last_anomaly_capture = time.time()
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().info(
            "profiling the next %d step(s) into %s (%s)", req["steps"],
            req["path"], req["reason"])

    def on_step_end(self, step: int) -> None:
        with self._lock:
            act = self._active
            if act is None:
                return
            act["remaining"] -= 1
            if act["remaining"] > 0:
                return
            self._active = None
        self._finalize(act, last_step=int(step))

    def finalize_open_capture(self, reason: str = "aborted") -> Optional[dict]:
        """Close a capture whose window never completed (the job hung or
        is crashing, or the manager is reset): whatever trace was open is
        still stopped and kept."""
        with self._lock:
            act, self._active = self._active, None
            self._pending = None
            if act is not None and not act.get("started", True):
                # claimed but the trace never opened (we raced
                # on_step_begin's start): nothing to flush — the
                # training thread detects the steal and closes the
                # trace itself
                return None
        if act is None:
            return None
        act["aborted"] = reason
        return self._finalize(act, last_step=None)

    # -- internals ------------------------------------------------------------
    def _start_trace(self, path: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self._prof, self._prof_path = prof, path

    def _stop_trace(self) -> None:
        """Stop the open profiler (it waits for the card) and export its
        Chrome trace into the capture directory."""
        prof, path = self._prof, self._prof_path
        self._prof = self._prof_path = None
        if prof is None:
            return
        prof.stop()
        prof.export_chrome_trace(os.path.join(path, "trace.json"))

    def _finalize(self, act: dict, last_step: Optional[int]) -> dict:
        try:
            self._stop_trace()
        except Exception as e:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("profiler stop failed: %r", e)
        record = {
            "path": act["path"],
            "reason": act["reason"],
            "steps": act["steps"] - max(0, act.get("remaining", 0)),
            "first_step": act.get("first_step"),
            "last_step": last_step,
            "bytes": _dir_bytes(act["path"]),
            "seconds": round(time.time() - act.get("started_at",
                                                   time.time()), 3),
            "ts": round(time.time(), 3),
        }
        if act.get("trigger"):
            record["trigger"] = {k: v for k, v in act["trigger"].items()
                                 if k in ("kind", "function", "rank",
                                          "step", "category")}
        if act.get("aborted"):
            record["aborted"] = act["aborted"]
        retained = self._rotate(keep=act["path"])
        with self._lock:
            self.captures.append(record)
            del self.captures[:-MAX_CAPTURE_RECORDS]
        try:
            reg = self._registry()
            reg.counter("hvd_profile_captures_total",
                        help="completed device-trace captures").inc()
            reg.gauge("hvd_profile_retained_bytes",
                      help="bytes of trace captures retained under "
                           "the profile dir after rotation",
                      agg="max").set(float(retained))
        except Exception:
            pass
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import record_event
            record_event("profile_captured", **{
                k: v for k, v in record.items() if k != "trigger"})
        except Exception:
            pass
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().info("profile captured: %s (%d bytes, %s)",
                          record["path"], record["bytes"],
                          record["reason"])
        return record

    def _rotate(self, keep: str) -> int:
        """Delete oldest capture dirs until total retention fits
        ``HVD_TPU_PROFILE_MAX_BYTES``; the just-written capture is never
        deleted (one over-budget capture beats zero evidence).  Returns
        retained bytes."""
        base = self.directory
        max_bytes = _env_int("PROFILE_MAX_BYTES", DEFAULT_MAX_BYTES)
        try:
            entries = []
            for name in os.listdir(base):
                p = os.path.join(base, name)
                if not os.path.isdir(p) or not name.startswith("capture_"):
                    continue
                entries.append((os.path.getmtime(p), p, _dir_bytes(p)))
        except OSError:
            return 0
        entries.sort()  # oldest first
        total = sum(b for _t, _p, b in entries)
        for _t, p, b in entries:
            if total <= max_bytes or os.path.abspath(p) == \
                    os.path.abspath(keep):
                continue
            try:
                shutil.rmtree(p)
                total -= b
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().info(
                    "profile retention: dropped %s (%d bytes)", p, b)
            except OSError:
                pass
        return total

    # -- introspection --------------------------------------------------------
    def recent_captures(self, last_n: int = MAX_CAPTURE_RECORDS) -> List[dict]:
        with self._lock:
            return [dict(c) for c in self.captures[-last_n:]]

    def status(self) -> dict:
        with self._lock:
            return {
                "dir": self.directory,
                "pending": dict(self._pending) if self._pending else None,
                "active": {k: v for k, v in self._active.items()
                           if k != "trigger"} if self._active else None,
                "captures": len(self.captures),
                "dropped_requests": self.dropped_requests,
            }


_MANAGER: Optional[ProfileManager] = None
_MANAGER_LOCK = threading.Lock()


def default_manager() -> ProfileManager:
    """The process-wide manager (created on first use; :func:`reset`
    drops it so tests / elastic re-init re-read env)."""
    global _MANAGER
    if _MANAGER is None:
        with _MANAGER_LOCK:
            if _MANAGER is None:
                _MANAGER = ProfileManager()
    return _MANAGER


def reset() -> None:
    global _MANAGER
    with _MANAGER_LOCK:
        m, _MANAGER = _MANAGER, None
    if m is not None:
        m.finalize_open_capture(reason="reset")
