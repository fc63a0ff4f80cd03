"""Always-on flight recorder: a bounded ring of recent control-plane events.

A copy of ``horovod_tpu/diagnostics/flight_recorder.py``: when a job
crashes or hangs, the last few thousand control-plane events (step
begin/end, guard skips, codec choices, goodput windows, anomaly findings,
profile captures) are what turn "it stopped" into an account of how.
Event kinds and fields are the JAX package's.

Design constraints:

* **bounded** — ``HVD_TPU_FLIGHT_RECORDER_SIZE`` events (default 4096),
  drop-oldest; memory use is O(capacity), independent of run length;
* **lock-cheap** — one short critical section per event (a deque append
  + a counter); no allocation beyond the event dict itself, no I/O;
* **always dumpable** — :meth:`FlightRecorder.dump` from any thread at
  any time (the watchdog calls it mid-hang), :func:`install_crash_hooks`
  wires an excepthook so an uncaught exception leaves a dump on disk.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 4096


def _env_capacity() -> int:
    from horovod_tpu_torch.common.config import env_int
    cap = env_int("FLIGHT_RECORDER_SIZE", DEFAULT_CAPACITY)
    return max(cap, 1)


class FlightRecorder:
    """Thread-safe bounded event ring (drop-oldest)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = int(capacity) if capacity else _env_capacity()
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dropped = 0
        self._seq = 0

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event; never raises, never blocks on I/O.  The
        thread's ACTIVE trace context (docs/OBSERVABILITY.md "Causal
        tracing") is stamped in as ``trace``/``span`` unless the caller
        already carries explicit trace fields."""
        ev = {"ts": time.time(), "kind": kind}
        if fields:
            ev.update(fields)
        if "trace" not in ev:
            try:
                from horovod_tpu_torch import tracing
                ctx = tracing.current()
                if ctx is not None:
                    ev.update(ctx.fields())
            except Exception:
                pass
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(ev)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self) -> List[dict]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def dump(self) -> Dict[str, Any]:
        """Self-describing dump document (what lands in the autopsy
        bundle and on ``/debug/flight``)."""
        with self._lock:
            events = list(self._ring)
            dropped = self._dropped
        return {
            "rank": _best_effort_rank(),
            "capacity": self.capacity,
            "dropped": dropped,
            "recorded": len(events),
            "dumped_at": time.time(),
            # the same per-rank wall offset the timeline shards carry
            # (diagnostics/clock.py): the merged timeline maps flight
            # evidence onto the coordinator's clock with it, so
            # cross-rank flight events align with shard spans instead
            # of drifting by host clock skew
            "wall_offset_s": wall_offset(),
            "events": events,
        }

    def dump_to(self, path: str) -> str:
        doc = self.dump()
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0


def _best_effort_rank() -> int:
    try:
        from horovod_tpu_torch.common.basics import _state
        if _state.initialized:
            return _state.rank
    except Exception:
        pass
    v = os.environ.get("HVD_TPU_RANK", os.environ.get("HOROVOD_RANK", "0"))
    try:
        return int(v)
    except ValueError:
        return 0


_WALL_OFFSET = 0.0


def set_wall_offset(seconds: float) -> None:
    """Record this rank's estimated ``my_wall - coordinator_wall``
    (measured once at init by :mod:`horovod_tpu_torch.diagnostics.clock`
    and shared with the timeline shards) so flight dumps are mergeable
    onto the coordinator's clock."""
    global _WALL_OFFSET
    _WALL_OFFSET = float(seconds)


def wall_offset() -> float:
    """The recorded offset, with ``HVD_TPU_CLOCK_OFFSET_S`` overriding
    live (same contract as the shard anchor: tests inject known skew,
    operators pin NTP-disciplined fleets to 0)."""
    forced = os.environ.get("HVD_TPU_CLOCK_OFFSET_S")
    if forced not in (None, ""):
        try:
            return float(forced)
        except ValueError:
            pass
    return _WALL_OFFSET


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-wide flight recorder (created on first use)."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def record_event(kind: str, **fields: Any) -> None:
    """Module-level convenience used by the instrumented call sites
    (callbacks, guard, codec metrics, goodput, anomaly, profiling,
    checkpoint store, watchdog)."""
    try:
        recorder().record(kind, **fields)
    except Exception:
        pass  # the recorder must never take down the caller


def crash_dump_path() -> str:
    """Where crash hooks drop the flight dump: the autopsy directory
    (``HVD_TPU_AUTOPSY_DIR``, default ``./hvd_autopsy`` — one contained
    place, not loose files in the CWD), created on demand."""
    from horovod_tpu_torch.common.config import env_str
    base = env_str("AUTOPSY_DIR") or os.path.join(os.getcwd(),
                                                  "hvd_autopsy")
    try:
        os.makedirs(base, exist_ok=True)
    except OSError:
        base = "."
    return os.path.join(base, f"hvd_flight_rank{_best_effort_rank()}.json")


_hooks_installed = False


def install_crash_hooks() -> None:
    """Chain excepthooks (main thread + threading) so an uncaught
    exception dumps the flight ring to disk before the process dies;
    idempotent.  ``HVD_TPU_FLIGHT_DUMP_ON_EXIT=1`` additionally dumps at
    every interpreter exit (atexit), crash or not."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    prev_hook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            record_event("crash", error=repr(exc))
            recorder().dump_to(crash_dump_path())
        except Exception:
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _hook

    prev_thook = threading.excepthook

    def _thook(args):
        try:
            record_event("thread_crash", error=repr(args.exc_value),
                         thread=getattr(args.thread, "name", "?"))
            recorder().dump_to(crash_dump_path())
        except Exception:
            pass
        prev_thook(args)

    threading.excepthook = _thook

    if os.environ.get("HVD_TPU_FLIGHT_DUMP_ON_EXIT", "") not in ("", "0"):
        import atexit

        def _atexit_dump():
            try:
                recorder().dump_to(crash_dump_path())
            except Exception:
                pass

        atexit.register(_atexit_dump)
