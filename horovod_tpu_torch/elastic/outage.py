"""Worker-side driver-outage grace window (ride-through).

Part of "driver restart is not a job restart" (docs/ELASTIC.md "Driver
failover & takeover"): when the elastic driver crashes, every worker's
world poll and notice publish starts failing at once.  Without a
declared grace window each failure escalates the way any transport
failure does — ``hvd_retry_exhausted_total`` alarms, noisy logs, and
(past the shrink-wait deadline) workers giving up on a job whose data
plane is perfectly healthy.  The driver holds no training state; its
death should cost the fleet NOTHING but control-plane latency while the
supervisor respawns it into a journal takeover.

This module is the worker's accounting of that window:

* ``note_failure()`` on the first failed world poll opens the outage —
  flight event ``driver_outage``, gauge ``hvd_driver_outage_seconds``
  starts aging;
* ``note_success()`` on the first poll that lands again closes it —
  flight event ``driver_recovered`` with the measured outage, gauge
  back to zero, and the notification listener marked stale so the
  worker re-registers with the takeover driver (whose freshly rebound
  KV has no ``notify`` scope yet);
* ``exceeded()`` answers "has the driver been dark longer than
  ``HVD_TPU_DRIVER_OUTAGE_GRACE_S``?" — the autopsy names that finding
  ("driver dead > grace"), and it is the operator's cue that the
  supervisor is NOT coming back.

Everything here is advisory bookkeeping on the worker's poll path: it
must never raise into training, so every emission is exception-proofed.
State is process-global (one driver per worker process) and guarded by
a lock — the poll loop and the notification listener can both touch it.

A copy of ``horovod_tpu/elastic/outage.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


def grace_s() -> float:
    """``HVD_TPU_DRIVER_OUTAGE_GRACE_S``: how long world-poll failures
    accrue quietly before the outage counts as exceeded (default 60s —
    comfortably above a supervisor respawn + journal replay + KV rebind,
    well below any human's reaction time).  0 disables the grace
    machinery entirely: failures escalate exactly as before."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.0, env_float("DRIVER_OUTAGE_GRACE_S", 60.0))


def enabled() -> bool:
    return grace_s() > 0.0


_lock = threading.Lock()
_started_at: Optional[float] = None      # monotonic; None = no outage
_last_recovery: Optional[float] = None   # monotonic stamp of last heal


def note_failure() -> None:
    """A world poll (or notice publish) failed to reach the driver."""
    global _started_at
    first = False
    with _lock:
        if _started_at is None:
            _started_at = time.perf_counter()
            first = True
        age = time.perf_counter() - _started_at
    _set_gauge(age)
    if first:
        _record_flight("driver_outage", grace_s=grace_s())
        try:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning(
                "driver unreachable: entering outage grace window "
                "(HVD_TPU_DRIVER_OUTAGE_GRACE_S=%.0fs); training "
                "continues on the cached world", grace_s())
        except Exception:
            pass


def note_success() -> None:
    """A world poll reached the driver.  Cheap no-op outside an
    outage; inside one, closes it and forces the notification listener
    to re-register (the takeover driver's KV starts with an empty
    ``notify`` scope)."""
    global _started_at, _last_recovery
    with _lock:
        if _started_at is None:
            return
        outage = time.perf_counter() - _started_at
        _started_at = None
        _last_recovery = time.perf_counter()
    _set_gauge(0.0)
    _record_flight("driver_recovered", outage_s=round(outage, 3))
    try:
        from horovod_tpu_torch.elastic import notification
        notification.mark_stale()
    except Exception:
        pass
    try:
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().info("driver reachable again after %.1fs outage",
                          outage)
    except Exception:
        pass


def active() -> bool:
    with _lock:
        return _started_at is not None


def age_s() -> float:
    with _lock:
        if _started_at is None:
            return 0.0
        return time.perf_counter() - _started_at


def exceeded() -> bool:
    """True when the driver has been dark longer than the grace window
    — the autopsy's "driver dead > grace" finding."""
    return enabled() and age_s() > grace_s()


def last_recovery_perf() -> Optional[float]:
    """``time.perf_counter()`` stamp of the most recent recovery, or
    None.  The re-mesh timeline uses it to mark episodes that spanned a
    takeover (``history --remesh``)."""
    with _lock:
        return _last_recovery


def reset() -> None:
    """Tests: drop all outage state without emitting."""
    global _started_at, _last_recovery
    with _lock:
        _started_at = None
        _last_recovery = None


def _set_gauge(value: float) -> None:
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        default_registry().gauge(
            "hvd_driver_outage_seconds",
            help="age of the current driver outage as seen from this "
                 "worker's world polls (0 = driver reachable)",
            agg="max").set(value)
    except Exception:
        pass


def _record_flight(kind: str, **fields) -> None:
    try:
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event(kind, **fields)
    except Exception:
        pass
