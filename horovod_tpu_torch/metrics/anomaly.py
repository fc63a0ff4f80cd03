"""Online anomaly engine: EWMA+MAD detectors over the step time-series.

A copy of the training and serving detectors of
``horovod_tpu/metrics/anomaly.py``.
The live metrics answer *is the job healthy now*; this layer answers
**was it degrading before anyone noticed?**  Four detectors run over the
points the train loop records:

* ``step_time_drift`` — step wall time drifts above its rolling
  baseline (an EWMA with a MAD-style robust deviation estimate);
* ``throughput_regression`` — units/s falls below the rolling baseline;
* ``exposed_comm_growth`` — the exposed-communication fraction of the
  step (``hvd_overlap_exposed_comm_seconds`` / step time) grows;
* ``goodput_regression`` — the goodput ledger's productive (compute)
  fraction falls below its rolling baseline (fed once per closed
  ledger window, :mod:`horovod_tpu_torch.metrics.goodput`); the finding
  names the dominating loss category.

Three serving detectors ride the request ledger's closed windows
(:mod:`horovod_tpu_torch.serving.ledger`, fed once per ``LatencyWindow``
roll via :func:`observe_serving_window`):

* ``ttft_drift`` — windowed time-to-first-token p50 drifts above its
  rolling baseline (generate traffic only);
* ``queue_growth`` — the queueing stages (``queue`` + ``batch_wait``)
  take over the request wall-clock: their windowed stage share stays
  over ``HVD_TPU_SERVING_QUEUE_SHARE`` — the scale-out-shaped signal;
* ``kv_thrash`` — the ``page_wait`` stage share stays over
  ``HVD_TPU_SERVING_KV_THRASH_SHARE``: sequences starve for KV pages,
  which more replicas will NOT fix.

External detectors (the ``hbm_growth`` sampler of
:mod:`horovod_tpu_torch.profiling.memory`, the ``recompile_storm`` watch)
report through :func:`report_finding`. A fifth training detector,
``persistent_straggler``, charges the SAME rank as the fleet's slowest
for N consecutive aggregation windows that each brought new steps of it
(fed by the fleet aggregator on rank 0,
:mod:`horovod_tpu_torch.metrics.fleet`).

Every finding lands three ways: a ``hvd_anomaly_total{kind=...}``
counter, an ``anomaly`` flight-recorder event, and the engine's bounded
findings list. It also roots a trace (:mod:`horovod_tpu_torch.tracing`)
and may arm a device-trace capture (the anomaly→profile hook of
:mod:`horovod_tpu_torch.profiling`).

Detection is deliberately conservative (the acceptance bar is ZERO
false positives on a clean run): a point is anomalous only when it is
``k`` robust deviations AND a minimum ratio away from the baseline, it
takes ``consecutive`` anomalous points in a row to flag, the baseline
refuses to learn from anomalous points (a stall must not become the new
normal), and a flagged detector stays quiet until the signal recovers
(hysteresis — one finding per episode, not one per step).

Thresholds are env-tunable: ``HVD_TPU_ANOMALY_ALPHA``, ``_K``,
``_MIN_RATIO``, ``_CONSECUTIVE``, ``_WARMUP``; ``HVD_TPU_ANOMALY=0``
disables the engine entirely.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from horovod_tpu_torch.metrics.registry import Registry, default_registry

MAX_FINDINGS = 64


def _envf(name: str, default: float) -> float:
    from horovod_tpu_torch.common.config import env_float
    return env_float(name, default)


def _envi(name: str, default: int) -> int:
    from horovod_tpu_torch.common.config import env_int
    return env_int(name, default)


def enabled() -> bool:
    from horovod_tpu_torch.common.config import env_bool
    return env_bool("ANOMALY", True)


class EwmaMad:
    """Robust online baseline: an EWMA of the value plus an EWMA of the
    absolute residual (a MAD-flavored scale estimate — resistant to the
    occasional spike a variance estimate would chase).  The deviation is
    floored at ``rel_floor`` of the mean plus ``abs_floor`` so a
    near-constant series (CPU smoke steps jitter by microseconds) does
    not become hypersensitive."""

    def __init__(self, alpha: float, rel_floor: float = 0.05,
                 abs_floor: float = 1e-6) -> None:
        self.alpha = alpha
        self.rel_floor = rel_floor
        self.abs_floor = abs_floor
        self.mean: Optional[float] = None
        self.mad = 0.0
        self.n = 0

    def update(self, v: float) -> None:
        self.n += 1
        if self.mean is None:
            self.mean = v
            return
        # Bias-corrected warmup: early on, weight new points as a plain
        # sample mean (1/n) instead of the steady-state alpha.  A slow
        # alpha otherwise lags the mean for the whole warmup ramp and
        # the MAD learns that LAG as if it were noise — a first window
        # skewed by compile then inflates k*dev past the entire value
        # range, hiding even an 80% drop from the drift rule.
        a = max(self.alpha, 1.0 / self.n)
        resid = abs(v - self.mean)
        self.mean += a * (v - self.mean)
        self.mad += a * (resid - self.mad)

    def deviation(self) -> float:
        m = abs(self.mean or 0.0)
        return max(self.mad, self.rel_floor * m, self.abs_floor)


class _DriftDetector:
    """Shared one-sided drift rule: warmup, then flag after
    ``consecutive`` points beyond ``k`` deviations AND ``min_ratio``
    from the baseline, with hysteresis and baseline freezing while
    anomalous.  ``direction=+1`` flags increases (step time),
    ``-1`` decreases (throughput)."""

    def __init__(self, kind: str, direction: int, alpha: float, k: float,
                 min_ratio: float, consecutive: int, warmup: int) -> None:
        self.kind = kind
        self.direction = direction
        self.baseline = EwmaMad(alpha)
        self.k = k
        self.min_ratio = min_ratio
        self.consecutive = max(1, consecutive)
        self.warmup = max(2, warmup)
        self._streak = 0
        self._active = False  # inside a flagged episode

    def observe(self, v: float) -> Optional[dict]:
        b = self.baseline
        if b.n < self.warmup:
            b.update(v)
            return None
        mean, dev = b.mean, b.deviation()
        delta = (v - mean) * self.direction
        ratio_bad = (v > mean * self.min_ratio) if self.direction > 0 \
            else (v < mean / self.min_ratio)
        anomalous = delta > self.k * dev and ratio_bad
        if not anomalous:
            b.update(v)  # only healthy points teach the baseline
            self._streak = 0
            self._active = False  # recovered: a new episode may flag
            return None
        self._streak += 1
        if self._active or self._streak < self.consecutive:
            return None
        self._active = True
        return {"kind": self.kind, "value": round(v, 6),
                "baseline": round(mean, 6),
                "deviation": round(dev, 6),
                "ratio": round(v / mean, 3) if mean else None,
                "consecutive": self._streak}


class _StageShareDetector:
    """Threshold detector over one windowed stage-share signal from the
    serving request ledger: flags after ``windows`` consecutive closed
    windows where the summed share of ``stages`` exceeds ``threshold``,
    with the same one-finding-per-episode hysteresis as the drift
    detectors.  An idle window (no requests) resets the episode — the
    condition did not survive the traffic that caused it."""

    def __init__(self, kind: str, stages: tuple, threshold: float,
                 windows: int) -> None:
        self.kind = kind
        self.stages = stages
        self.threshold = threshold
        self.windows = max(1, windows)
        self._streak = 0
        self._active = False

    def observe(self, doc: dict) -> Optional[dict]:
        if not doc.get("requests"):
            self._streak = 0
            self._active = False
            return None
        shares = doc.get("stage_shares") or {}
        share = sum(shares.get(s, 0.0) for s in self.stages)
        if share <= self.threshold:
            self._streak = 0
            self._active = False
            return None
        self._streak += 1
        if self._active or self._streak < self.windows:
            return None
        self._active = True
        worst = max(self.stages, key=lambda s: shares.get(s, 0.0))
        finding = {"kind": self.kind, "value": round(share, 4),
                   "threshold": self.threshold,
                   "dominant_stage": worst,
                   "stage_share": round(shares.get(worst, 0.0), 4),
                   "consecutive": self._streak}
        if doc.get("worst_trace"):
            finding["worst_trace"] = doc["worst_trace"]
        return finding


class AnomalyEngine:
    """Per-process detector bank; feed it from the train loop
    (``observe_step``), the goodput ledger (``observe_goodput``) and the
    serving plane's closed windows (``observe_serving``).
    Thread-safe; every call is O(1)."""

    def __init__(self, registry: Optional[Registry] = None) -> None:
        self._reg = registry or default_registry()
        self._lock = threading.Lock()
        alpha = _envf("ANOMALY_ALPHA", 0.1)
        k = _envf("ANOMALY_K", 6.0)
        min_ratio = _envf("ANOMALY_MIN_RATIO", 1.5)
        consecutive = _envi("ANOMALY_CONSECUTIVE", 3)
        warmup = _envi("ANOMALY_WARMUP", 10)
        self._step = _DriftDetector(
            "step_time_drift", +1, alpha, k, min_ratio, consecutive,
            warmup)
        self._thr = _DriftDetector(
            "throughput_regression", -1, alpha, k, min_ratio, consecutive,
            warmup)
        self._exposed = _DriftDetector(
            "exposed_comm_growth", +1, alpha, k, min_ratio, consecutive,
            warmup)
        # goodput windows land once per HVD_TPU_GOODPUT_WINDOW steps,
        # so the same consecutive/warmup knobs span a proportionally
        # longer wall-clock learning period — deliberately: a goodput
        # regression is a sustained condition, not a blip
        self._goodput = _DriftDetector(
            "goodput_regression", -1, alpha, k, min_ratio, consecutive,
            warmup)
        # serving-plane detectors (fed per closed LatencyWindow by
        # observe_serving): TTFT drifts like step time; the stage-share
        # pair are threshold detectors — a share is already normalized,
        # a learned baseline would only blunt the "where" answer
        self._ttft = _DriftDetector(
            "ttft_drift", +1, alpha, k, min_ratio, consecutive, warmup)
        share_windows = max(1, _envi("SERVING_STAGE_WINDOWS", 2))
        self._queue_share = _StageShareDetector(
            "queue_growth", ("queue", "batch_wait"),
            _envf("SERVING_QUEUE_SHARE", 0.5), share_windows)
        self._kv_share = _StageShareDetector(
            "kv_thrash", ("page_wait",),
            _envf("SERVING_KV_THRASH_SHARE", 0.25), share_windows)
        self._straggler_windows = max(
            2, _envi("ANOMALY_STRAGGLER_WINDOWS", 3))
        self._straggler_ratio = _envf("ANOMALY_STRAGGLER_RATIO", 1.3)
        self._straggler_rank: Optional[int] = None
        self._straggler_run = 0
        self._straggler_active = False
        self._straggler_steps: Optional[int] = None
        self.findings: List[dict] = []

    # -- feeds ---------------------------------------------------------------
    def observe_step(self, step: int, seconds: float,
                     units_per_s: Optional[float] = None,
                     exposed_comm_s: Optional[float] = None) -> List[dict]:
        """One completed step; returns any NEW findings (usually [])."""
        out = []
        with self._lock:
            f = self._step.observe(float(seconds))
            if f:
                out.append(self._flag(f, step=step))
            if units_per_s is not None and units_per_s > 0:
                f = self._thr.observe(float(units_per_s))
                if f:
                    out.append(self._flag(f, step=step))
            if exposed_comm_s is not None and seconds > 0:
                frac = max(0.0, min(1.0, exposed_comm_s / seconds))
                f = self._exposed.observe(frac)
                if f:
                    out.append(self._flag(f, step=step))
        return out

    def observe_goodput(self, fraction: float,
                        dominating: Optional[str] = None) -> List[dict]:
        """One closed goodput-ledger window: the productive (compute)
        fraction of wall time (docs/OBSERVABILITY.md "Goodput ledger").
        A sustained drop below the learned baseline flags a
        ``goodput_regression`` finding naming the category that now
        dominates the loss — the anomaly→profile hook captures a device
        trace of exactly the regressed window shape."""
        with self._lock:
            f = self._goodput.observe(max(0.0, min(1.0, float(fraction))))
            if not f:
                return []
            if dominating:
                f["category"] = dominating
            return [self._flag(f)]

    def observe_fleet(self, per_rank: Dict[Any, dict]) -> List[dict]:
        """One fleet aggregation window: ``per_rank`` maps rank to a
        breakdown entry carrying ``win_step_time`` (the fleet
        aggregator's per-push windowed mean step time) and ``steps``.
        Flags when the same rank stays the slowest — and meaningfully
        slower than the fleet mean — for N consecutive windows that each
        brought steps of that rank: a window in which its step count did
        not move carries its last window over, which is no new evidence
        (else one slow step, such as a rank's warm-up while its peers
        wait for it, would be charged N times)."""
        times = {int(r): e["win_step_time"] for r, e in per_rank.items()
                 if isinstance(e, dict)
                 and isinstance(e.get("win_step_time"), (int, float))}
        steps = {int(r): e.get("steps") for r, e in per_rank.items()
                 if isinstance(e, dict)}
        with self._lock:
            if len(times) < 2:
                self._straggler_run = 0
                self._straggler_rank = None
                return []
            worst = max(times, key=lambda r: times[r])
            mean = sum(times.values()) / len(times)
            others = [t for r, t in times.items() if r != worst]
            peer_mean = sum(others) / len(others)
            charged = peer_mean > 0 and \
                times[worst] > peer_mean * self._straggler_ratio
            if not charged:
                self._straggler_run = 0
                self._straggler_rank = None
                self._straggler_active = False
                return []
            if worst == self._straggler_rank:
                if steps.get(worst) is not None and \
                        steps[worst] == self._straggler_steps:
                    return []
                self._straggler_run += 1
            else:
                self._straggler_rank = worst
                self._straggler_run = 1
                self._straggler_active = False
            self._straggler_steps = steps.get(worst)
            if self._straggler_active or \
                    self._straggler_run < self._straggler_windows:
                return []
            self._straggler_active = True
            return [self._flag({
                "kind": "persistent_straggler", "rank": worst,
                "win_step_time": round(times[worst], 6),
                "fleet_mean": round(mean, 6),
                "windows": self._straggler_run})]

    def observe_serving(self, doc: dict) -> List[dict]:
        """One closed serving ``LatencyWindow`` doc (carrying the
        request ledger's stage shares): runs the ``ttft_drift`` /
        ``queue_growth`` / ``kv_thrash`` detectors and returns any NEW
        findings."""
        out = []
        with self._lock:
            ttft = doc.get("ttft_p50_s")
            if ttft is not None and doc.get("requests"):
                f = self._ttft.observe(float(ttft))
                if f:
                    if doc.get("worst_trace"):
                        f["worst_trace"] = doc["worst_trace"]
                    out.append(self._flag(f))
            for det in (self._queue_share, self._kv_share):
                f = det.observe(doc)
                if f:
                    out.append(self._flag(f))
        return out

    # -- reporting -----------------------------------------------------------
    def report(self, kind: str, **fields: Any) -> dict:
        """Public finding seam for detectors that live OUTSIDE this
        engine's own step feeds — the ``recompile_storm`` watcher
        (:mod:`horovod_tpu_torch.profiling.compile_watch`) and the
        ``hbm_growth`` sampler (:mod:`horovod_tpu_torch.profiling.memory`).
        The finding takes the exact same path as a native one: counter,
        flight event, bounded findings list, and (via the profiling
        hook) a possible triggered device-trace capture."""
        with self._lock:
            return self._flag({"kind": kind, **fields})

    def _flag(self, finding: dict, **extra: Any) -> dict:
        finding.update(extra)
        finding["ts"] = round(time.time(), 3)
        try:
            # causal tracing: the finding ROOTS a trace that what acts
            # on it continues (the autopilot decision, the driver's
            # handling, the re-mesh episode)
            from horovod_tpu_torch import tracing
            supplied = finding.get(tracing.TRACEPARENT)
            if supplied:
                # the caller is ALREADY inside a trace: the finding
                # CONTINUES that trace as a child span instead of
                # rooting a new one
                ctx = tracing.child(tracing.decode(supplied), "anomaly")
            else:
                ctx = tracing.new_trace("anomaly")
            if ctx is not None:
                finding.update(ctx.fields())
                finding[tracing.TRACEPARENT] = ctx.traceparent
        except Exception:
            pass
        self.findings.append(finding)
        del self.findings[:-MAX_FINDINGS]
        kind = finding["kind"]
        try:
            self._reg.counter(
                "hvd_anomaly_total",
                help="anomaly-engine findings, per detector kind",
                labels={"kind": kind}).inc()
        except Exception:
            pass
        try:
            # deep-profiling hook: a finding may arm a bounded device-trace
            # capture of the next steps; the planned path is stamped
            # into THIS finding dict before the flight event records
            # it, so every channel points at the same trace
            from horovod_tpu_torch.profiling import on_anomaly
            on_anomaly(finding)
        except Exception:
            pass
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import record_event
            # "detector", not "kind": the ring's own event-kind key wins
            # (the JAX package's convention)
            record_event("anomaly",
                         **{("detector" if k == "kind" else k): v
                            for k, v in finding.items()
                            if k not in ("ts", "traceparent")})
        except Exception:
            pass
        try:
            # autopilot seam (horovod_tpu/metrics/anomaly.py:430): every
            # finding, native or report_finding(), is offered to the
            # policy engine, which records one decision per matching
            # policy; a None check when HVD_TPU_AUTOPILOT=off
            from horovod_tpu_torch.autopilot import on_finding
            on_finding(finding)
        except Exception:
            pass
        try:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("anomaly: %s %s", kind,
                                 {k: v for k, v in finding.items()
                                  if k not in ("kind", "ts")})
        except Exception:
            pass
        return finding

    def recent_findings(self, last_n: int = MAX_FINDINGS) -> List[dict]:
        with self._lock:
            return list(self.findings[-last_n:])

    def reset_baselines(self) -> None:
        """Forget the learned baselines but KEEP the findings: a re-mesh
        legitimately changes step time (different world size) and must
        re-learn, while already-flagged degradation stays on record."""
        alpha = self._step.baseline.alpha
        with self._lock:
            for det in (self._step, self._thr, self._exposed,
                        self._goodput, self._ttft):
                det.baseline = EwmaMad(alpha)
                det._streak = 0
                det._active = False
            for det in (self._queue_share, self._kv_share):
                det._streak = 0
                det._active = False
            self._straggler_rank = None
            self._straggler_run = 0
            self._straggler_active = False
            self._straggler_steps = None


_ENGINE: Optional[AnomalyEngine] = None
_ENGINE_LOCK = threading.Lock()


def default_engine() -> Optional[AnomalyEngine]:
    """The process-wide engine (None when ``HVD_TPU_ANOMALY=0``);
    created on first use, rebuilt by :func:`reset`."""
    global _ENGINE
    if not enabled():
        return None
    if _ENGINE is None:
        with _ENGINE_LOCK:
            if _ENGINE is None:
                _ENGINE = AnomalyEngine()
    return _ENGINE


def recent_findings() -> List[dict]:
    """Findings so far (empty when the engine never ran)."""
    eng = _ENGINE
    return eng.recent_findings() if eng is not None else []


def observe_serving_window(doc: dict) -> List[dict]:
    """Feed one closed serving window doc to the process-wide engine's
    serving detectors ([] when ``HVD_TPU_ANOMALY=0``)."""
    eng = default_engine()
    return eng.observe_serving(doc) if eng is not None else []


def report_finding(kind: str, **fields: Any) -> Optional[dict]:
    """Route an external detector's finding through the process-wide
    engine (None — silently dropped — when ``HVD_TPU_ANOMALY=0``)."""
    eng = default_engine()
    return eng.report(kind, **fields) if eng is not None else None


def reset() -> None:
    """Drop the process-wide engine so thresholds re-read env (tests,
    re-init)."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = None


def reset_baselines() -> None:
    """Re-learn baselines in place (a re-init across a re-mesh); no-op
    when the engine never ran."""
    eng = _ENGINE
    if eng is not None:
        eng.reset_baselines()
