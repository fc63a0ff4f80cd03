"""Goodput ledger: closed-books wall-clock attribution.

A copy of ``horovod_tpu/metrics/goodput.py``: a per-rank ledger that
attributes EVERY second of job wall time to a closed category set:

* ``compute``          — in-step time not claimed by any cost below;
* ``exposed_comm``     — collective time the overlap schedule failed
                         to hide (``hvd_overlap_exposed_comm_seconds``,
                         the eager gradient sync's blocked seconds);
* ``compile``          — kernel builds (compile_watch: the port's
                         compiles are the ``nvcc`` builds of
                         ``ops/_build.py``), whether they landed inside a
                         step (the first call that needs a library) or
                         between steps;
* ``remesh_recovery``  — elastic re-mesh episodes;
* ``checkpoint_stall`` — the train-thread-blocking slice of the
                         checkpoint store;
* ``input_wait``       — inter-step gaps not explained by any of the
                         above: the host loop waiting on data;
* ``guard_skipped``    — steps the numeric guardrail threw away
                         (``hvd_guard_skipped_steps_total``): wall time
                         spent computing an update that was dropped;
* ``idle_other``       — the residual.  Books must close: the residual
                         is itself a reported category, never silently
                         dropped, and a window whose categories fail to
                         sum to wall time within
                         ``HVD_TPU_GOODPUT_TOLERANCE`` is flagged
                         loudly (flight event + warning), never
                         papered over.

The checkpoint store (``checkpoint/store.py``) feeds
:func:`note_checkpoint_stall` with the seconds a save or a restore held
its caller. The port has no elastic re-mesh yet (ROADMAP queue 1 item
7): nothing calls :func:`note_remesh`, so ``remesh_recovery`` reads zero
until that slice wires its seam in. The category stays, so the books
have the JAX package's shape.

Everything is fed from seams that already exist — the StepTimer step
envelope, the exposed-comm gauge, compile_watch totals, the guard-skip
counter — no new instrumentation on the hot path.  The ledger closes
a window every ``HVD_TPU_GOODPUT_WINDOW`` completed steps and emits
each closed window four ways:

* ``hvd_goodput_seconds_total{category=...}`` counters;
* the ``hvd_goodput_fraction`` gauge — the productive (compute)
  fraction of the window, ``agg="mean"`` across ranks;
* a ``goodput_window`` flight-recorder event;
* one ``{"goodput": ...}`` point in the step time-series store.

The anomaly engine's ``goodput_regression`` detector observes the
productive fraction per window; a sustained drop flags a finding
naming the dominating non-compute category, which the anomaly→profile
hook turns into a device-trace capture of the regression itself.

``HVD_TPU_GOODPUT=0`` disables the whole plane at near-zero cost.
Every emission path is exception-proofed: accounting must never break
training.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from horovod_tpu_torch.common.config import env_bool, env_float, env_int

CATEGORIES = ("compute", "exposed_comm", "compile", "remesh_recovery",
              "checkpoint_stall", "input_wait", "guard_skipped",
              "idle_other")

_LOCK = threading.Lock()
_LEDGER: Optional["GoodputLedger"] = None


def _compile_seconds_total() -> float:
    try:
        from horovod_tpu_torch.profiling import compile_watch
        return float(compile_watch.totals().get("seconds_total", 0.0))
    except Exception:
        return 0.0


class GoodputLedger:
    """Per-rank wall-clock accountant over fixed step windows.

    The clock runs from the FIRST ``note_step_begin`` (setup before the
    loop is the bench's business, not the steady-state ledger's); from
    then on every perf_counter second between window open and window
    close lands in exactly one category.
    """

    def __init__(self, window_steps: Optional[int] = None,
                 tolerance: Optional[float] = None) -> None:
        self.window_steps = max(1, int(
            window_steps if window_steps is not None
            else env_int("GOODPUT_WINDOW", 50)))
        self.tolerance = float(
            tolerance if tolerance is not None
            else env_float("GOODPUT_TOLERANCE", 0.01))
        self._lock = threading.Lock()
        # cumulative closed-window totals (seconds per category)
        self.totals: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self.wall_total = 0.0
        self.steps_total = 0
        self.windows_closed = 0
        self.books_violations = 0
        self.max_residual_frac = 0.0
        self.recent: deque = deque(maxlen=32)  # closed window records
        self._reset_window()

    # -- window state ---------------------------------------------------
    def _reset_window(self) -> None:
        self._t_open: Optional[float] = None
        self._steps = 0
        self._in_step = 0.0
        self._exposed = 0.0
        self._guard = 0.0
        self._gap = 0.0
        self._ckpt = 0.0
        self._remesh = 0.0
        self._compile0 = 0.0
        self._guard_count0: Optional[float] = None
        self._last_end: Optional[float] = None
        self._step_open = False

    def _open_window(self, now: float) -> None:
        self._reset_window()
        self._t_open = now
        self._compile0 = _compile_seconds_total()

    # -- feeds (all cheap; all exception-proofed by the module seams) ---
    def note_step_begin(self) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t_open is None:
                self._open_window(now)
            elif self._last_end is not None:
                self._gap += max(0.0, now - self._last_end)
            self._step_open = True
            self._guard_count0 = self._read_guard_count()

    def note_step_end(self, dt: float) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t_open is None or not self._step_open:
                return
            self._step_open = False
            dt = max(0.0, float(dt))
            self._in_step += dt
            exposed = self._read_exposed()
            if exposed is not None:
                self._exposed += min(max(0.0, exposed), dt)
            guard_now = self._read_guard_count()
            if (guard_now is not None and self._guard_count0 is not None
                    and guard_now > self._guard_count0):
                # the whole step was spent on an update the guard zeroed
                self._guard += dt
            self._last_end = now
            self._steps += 1
            if self._steps >= self.window_steps:
                self._close_window_locked(now)

    def note_checkpoint_stall(self, seconds: float) -> None:
        """Train-thread seconds blocked on the checkpoint store (inline
        snapshot, waited save, restore)."""
        with self._lock:
            if self._t_open is not None:
                self._ckpt += max(0.0, float(seconds))

    def note_remesh(self, seconds: float) -> None:
        """A completed elastic re-mesh episode's total recovery time (no
        caller until the elastic slice)."""
        with self._lock:
            if self._t_open is not None:
                self._remesh += max(0.0, float(seconds))

    def _read_exposed(self) -> Optional[float]:
        try:
            from horovod_tpu_torch.metrics.registry import default_registry
            g = default_registry().get("hvd_overlap_exposed_comm_seconds")
            return float(g.value) if g is not None else None
        except Exception:
            return None

    def _read_guard_count(self) -> Optional[float]:
        try:
            from horovod_tpu_torch.metrics.registry import default_registry
            c = default_registry().get("hvd_guard_skipped_steps_total")
            return float(c.value) if c is not None else None
        except Exception:
            return None

    # -- closing the books ----------------------------------------------
    def flush(self) -> Optional[Dict[str, Any]]:
        """Close the current window early (end of run: the partial
        window's evidence matters more than cadence).
        Returns the closed record, or None if no step has landed."""
        with self._lock:
            if self._t_open is None or self._steps == 0:
                return None
            return self._close_window_locked(time.perf_counter())

    def _close_window_locked(self, now: float) -> Dict[str, Any]:
        wall = max(0.0, now - self._t_open)
        compile_delta = max(
            0.0, _compile_seconds_total() - self._compile0)
        # Sequential clamping: each claimed cost is capped by the time
        # actually left to claim, so the categories sum to wall time by
        # construction — the tolerance only has to absorb float error.
        in_step = min(self._in_step, wall)
        guard = min(self._guard, in_step)
        rest = in_step - guard
        exposed = min(self._exposed, rest)
        rest -= exposed
        compile_in = min(compile_delta, rest)
        compute = rest - compile_in
        compile_out = compile_delta - compile_in
        out_step = wall - in_step
        ckpt = min(self._ckpt, out_step)
        rem = out_step - ckpt
        remesh = min(self._remesh, rem)
        rem -= remesh
        co = min(compile_out, rem)
        rem -= co
        input_wait = min(
            max(0.0, self._gap - ckpt - remesh - co), rem)
        rem -= input_wait
        idle_other = max(0.0, rem)
        cats = {
            "compute": compute,
            "exposed_comm": exposed,
            "compile": compile_in + co,
            "remesh_recovery": remesh,
            "checkpoint_stall": ckpt,
            "input_wait": input_wait,
            "guard_skipped": guard,
            "idle_other": idle_other,
        }
        residual = wall - sum(cats.values())
        residual_frac = abs(residual) / wall if wall > 0 else 0.0
        closed = residual_frac <= self.tolerance
        fraction = compute / wall if wall > 0 else 0.0
        record = {
            "wall_s": wall,
            "steps": self._steps,
            "seconds": cats,
            "fractions": {c: (v / wall if wall > 0 else 0.0)
                          for c, v in cats.items()},
            "fraction": fraction,
            "residual_s": residual,
            "closed": closed,
        }
        self.wall_total += wall
        self.steps_total += self._steps
        for c, v in cats.items():
            self.totals[c] += v
        self.windows_closed += 1
        self.max_residual_frac = max(self.max_residual_frac,
                                     residual_frac)
        if not closed:
            self.books_violations += 1
        self.recent.append(record)
        # window state rolls over; the clock keeps running so the gap
        # between windows is itself accounted (next window opens NOW)
        self._open_window(now)
        self._emit(record)
        return record

    @staticmethod
    def dominating(record: Dict[str, Any]) -> Optional[str]:
        """The non-compute category claiming the most wall time."""
        secs = record.get("seconds") or {}
        loss = {c: v for c, v in secs.items() if c != "compute"}
        if not loss:
            return None
        return max(loss, key=loss.get)

    def _emit(self, record: Dict[str, Any]) -> None:
        cats = record["seconds"]
        try:
            from horovod_tpu_torch.metrics.registry import default_registry
            reg = default_registry()
            for c, v in cats.items():
                reg.counter(
                    "hvd_goodput_seconds_total",
                    help="wall seconds attributed per goodput category",
                    labels={"category": c}).inc(v)
            reg.gauge(
                "hvd_goodput_fraction",
                help="productive (compute) fraction of the last "
                     "goodput window", agg="mean").set(record["fraction"])
        except Exception:
            pass
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import \
                record_event
            record_event(
                "goodput_window", wall_s=round(record["wall_s"], 4),
                steps=record["steps"],
                closed=record["closed"],
                residual_s=round(record["residual_s"], 6),
                **{f"{c}_s": round(v, 4) for c, v in cats.items()})
        except Exception:
            pass
        if not record["closed"]:
            try:
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning(
                    "goodput books did NOT close: window wall %.3fs vs "
                    "categories %.3fs (residual %.4fs > tolerance %.3f)",
                    record["wall_s"], sum(cats.values()),
                    record["residual_s"], self.tolerance)
            except Exception:
                pass
        try:
            from horovod_tpu_torch.metrics import timeseries
            timeseries.record_point({
                "goodput": {c: round(v, 4) for c, v in cats.items()},
                "goodput_wall_s": round(record["wall_s"], 4),
                "goodput_fraction": round(record["fraction"], 4),
                "goodput_steps": record["steps"],
                "goodput_closed": record["closed"]})
        except Exception:
            pass
        try:
            from horovod_tpu_torch.metrics.anomaly import default_engine
            eng = default_engine()
            if eng is not None:
                eng.observe_goodput(record["fraction"],
                                    dominating=self.dominating(record))
        except Exception:
            pass

    # -- views -----------------------------------------------------------
    def last_window(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self.recent[-1]) if self.recent else None

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative closed-window account — the end-of-run view."""
        with self._lock:
            wall = self.wall_total
            secs = dict(self.totals)
            residual = wall - sum(secs.values())
            return {
                "windows": self.windows_closed,
                "steps": self.steps_total,
                "wall_s": round(wall, 4),
                "seconds": {c: round(v, 4) for c, v in secs.items()},
                "fractions": {c: round(v / wall, 4) if wall > 0 else 0.0
                              for c, v in secs.items()},
                "fraction": round(secs["compute"] / wall, 4)
                if wall > 0 else 0.0,
                "residual_s": round(residual, 6),
                "closed": self.max_residual_frac <= self.tolerance,
                "books_violations": self.books_violations,
                "tolerance": self.tolerance,
                "last_window": dict(self.recent[-1])
                if self.recent else None,
            }


# -- module seams (every caller goes through these; all no-op when the
#    plane is disabled or nothing has started) ---------------------------
def enabled() -> bool:
    return env_bool("GOODPUT", True)


def ledger(create: bool = True) -> Optional[GoodputLedger]:
    global _LEDGER
    if _LEDGER is None and create:
        with _LOCK:
            if _LEDGER is None:
                _LEDGER = GoodputLedger()
    return _LEDGER


def note_step_begin() -> None:
    if not enabled():
        return
    try:
        ledger().note_step_begin()
    except Exception:
        pass


def note_step_end(dt: Optional[float]) -> None:
    if not enabled() or dt is None:
        return
    try:
        ledger().note_step_end(dt)
    except Exception:
        pass


def note_checkpoint_stall(seconds: float) -> None:
    led = _LEDGER
    if led is None or not enabled():
        return
    try:
        led.note_checkpoint_stall(seconds)
    except Exception:
        pass


def note_remesh(seconds: float) -> None:
    led = _LEDGER
    if led is None or not enabled():
        return
    try:
        led.note_remesh(seconds)
    except Exception:
        pass


def flush() -> Optional[Dict[str, Any]]:
    led = _LEDGER
    if led is None:
        return None
    try:
        return led.flush()
    except Exception:
        return None


def snapshot(flush_open: bool = False) -> Optional[Dict[str, Any]]:
    """The cumulative ledger account, or None when the plane never ran.
    ``flush_open=True`` first folds the in-progress window in (end of
    run)."""
    led = _LEDGER
    if led is None:
        return None
    if flush_open:
        flush()
    try:
        return led.snapshot()
    except Exception:
        return None


def fleet_summary() -> Optional[Dict[str, Any]]:
    """Small per-rank doc for the fleet fan-in tree: the last closed
    window's productive fraction + dominating loss category."""
    led = _LEDGER
    if led is None:
        return None
    rec = led.last_window()
    if rec is None:
        return None
    return {"fraction": round(rec["fraction"], 4),
            "dominating": GoodputLedger.dominating(rec),
            "wall_s": round(rec["wall_s"], 4)}


def reset() -> None:
    """Tests: drop the singleton (a fresh ledger re-reads the knobs)."""
    global _LEDGER
    with _LOCK:
        _LEDGER = None
