"""Per-request stage ledger: latency attribution whose books must close.

A copy of ``horovod_tpu/serving/ledger.py`` (host code).

The serving plane's latency histograms say *how slow*; this module says
*where*.  Every accepted request's wall-clock is decomposed into named
stages — router (``admission``/``hedge_wait``/``dispatch``), replica
(``queue``/``batch_wait``/``forward``/``response``) and generate
(``slot_wait``/``page_wait``/``prefill``/``decode``/``swap_pause``) —
plus an explicit ``unattributed`` residual, mirroring the goodput
ledger's closed-books discipline (docs/OBSERVABILITY.md "Serving
request ledger") on the request plane: the stages must sum to the
end-to-end latency, and whatever they do not cover is *named* as
residual instead of silently vanishing.

Three pieces live here:

* :func:`quantile` — THE one nearest-rank quantile implementation
  (fraction ``q`` in ``[0, 1]``).  The SLO plane's p99, the rollout
  comparator's per-version p99 and the bench artifact's p99 gated by
  ``ci/check_bench.py --serving`` all route through it, so "p99" means
  the same thing everywhere.
* :class:`WindowBooks` + :class:`ExemplarRing` — per-window stage
  aggregation (sums, shares, dominant stage) and a bounded ring of
  tail exemplars: the worst requests per window with trace id + full
  stage breakdown, dumped into the autopsy bundle and served at
  ``/debug/exemplars``.
* :class:`BurnRateSlo` — multi-window burn-rate alerting over an error
  budget, replacing the single-threshold p99 check: a breach episode
  opens when BOTH the fast and the slow window burn their budget above
  ``HVD_TPU_SERVING_BURN_THRESHOLD``, the finding names the dominant
  stage (so autopilot can tell a scale-out-shaped breach from a
  swap/KV-shaped one), and hysteresis keeps it to one finding per
  episode.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.config import env_float, env_int
from horovod_tpu_torch.metrics.registry import default_registry

#: canonical stage names, in pipeline order.  ``unattributed`` is the
#: explicit residual (e2e minus everything attributed) — always last.
ROUTER_STAGES = ("admission", "hedge_wait", "dispatch")
REPLICA_STAGES = ("queue", "batch_wait", "forward", "response")
GENERATE_STAGES = ("slot_wait", "page_wait", "prefill", "decode",
                   "swap_pause")
RESIDUAL = "unattributed"
STAGES: Tuple[str, ...] = (ROUTER_STAGES + REPLICA_STAGES
                           + GENERATE_STAGES + (RESIDUAL,))

#: stage histogram buckets: stages bottom out well under a millisecond
#: (a decode step's share of one token, a lock acquire), so the floor
#: sits below the request-latency buckets'
STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over an ASCENDING-sorted sequence,
    ``q`` a fraction in ``[0, 1]``; 0.0 on empty input."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def close_books(e2e_s: float, stages: Dict[str, float]) -> Dict[str, float]:
    """Return ``stages`` with the ``unattributed`` residual filled in:
    ``max(0, e2e - sum(attributed))``.  Negative stage values are
    clamped to zero (a clock race is an attribution error, not negative
    time)."""
    out = {k: max(0.0, float(v)) for k, v in stages.items()
           if k != RESIDUAL}
    attributed = sum(out.values())
    out[RESIDUAL] = max(0.0, float(e2e_s) - attributed)
    return out


def residual_fraction(e2e_s: float, stages: Dict[str, float]) -> float:
    """Fraction of ``e2e_s`` the named stages do NOT cover (the
    books-close number ``check_bench --serving`` gates < 10%)."""
    if e2e_s <= 0:
        return 0.0
    attributed = sum(max(0.0, float(v)) for k, v in stages.items()
                     if k != RESIDUAL)
    return max(0.0, e2e_s - attributed) / e2e_s


def dominant_stage(stages: Dict[str, float]) -> Optional[str]:
    """The named (non-residual) stage with the largest share; None when
    nothing is attributed."""
    named = {k: v for k, v in stages.items()
             if k != RESIDUAL and v > 0}
    if not named:
        return None
    return max(named.items(), key=lambda kv: kv[1])[0]


def observe_stage_seconds(stages: Dict[str, float]) -> None:
    """Publish one ``hvd_serving_stage_seconds{stage=...}`` observation
    per named stage of one request."""
    reg = default_registry()
    for name, v in stages.items():
        if v <= 0 and name != RESIDUAL:
            continue
        reg.histogram("hvd_serving_stage_seconds",
                      help="per-request wall seconds attributed to one "
                           "named serving stage (the request ledger; "
                           "stage=unattributed is the residual)",
                      labels={"stage": name},
                      buckets=STAGE_BUCKETS).observe(max(0.0, float(v)))


def publish_stage_shares(shares: Dict[str, float]) -> None:
    """Publish the windowed ``hvd_serving_stage_share{stage=...}``
    gauges for EVERY canonical stage — absent stages publish 0.0, so an
    idle window zeroes the shares instead of freezing them."""
    reg = default_registry()
    for name in STAGES:
        reg.gauge("hvd_serving_stage_share",
                  help="fraction of windowed request wall-clock "
                       "attributed to one named stage (0 when idle)",
                  labels={"stage": name}).set(
            float(shares.get(name, 0.0)))


# ---------------------------------------------------------------------------
# Tail exemplars
# ---------------------------------------------------------------------------
class ExemplarRing:
    """Bounded ring of tail exemplars: the worst requests per closed
    window, each carrying trace id + full stage breakdown.  Capacity
    ``HVD_TPU_SERVING_EXEMPLARS`` (default 32); oldest evicted first."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity if capacity \
            else max(1, env_int("SERVING_EXEMPLARS", 32))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def add(self, exemplar: dict) -> None:
        with self._lock:
            self._ring.append(dict(exemplar))

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def worst(self, n: int = 5) -> List[dict]:
        """The ``n`` slowest exemplars currently held, slowest first."""
        return sorted(self.snapshot(),
                      key=lambda e: e.get("e2e_s", 0.0),
                      reverse=True)[:n]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_default_ring: Optional[ExemplarRing] = None
_default_ring_lock = threading.Lock()


def default_ring() -> ExemplarRing:
    """The process-wide exemplar ring (what ``/debug/exemplars`` and the
    autopsy bundle dump)."""
    global _default_ring
    with _default_ring_lock:
        if _default_ring is None:
            _default_ring = ExemplarRing()
        return _default_ring


def exemplars() -> List[dict]:
    return default_ring().snapshot()


def reset() -> None:
    """Drop the process-wide ring (tests)."""
    global _default_ring
    with _default_ring_lock:
        _default_ring = None


# ---------------------------------------------------------------------------
# Per-window stage books
# ---------------------------------------------------------------------------
class WindowBooks:
    """Accumulates one window's stage sums + the window's worst
    requests; :meth:`close` returns the stage section of the window doc
    and the exemplars to push into the ring.  NOT thread-safe — callers
    (``LatencyWindow``) hold their own lock."""

    def __init__(self, exemplars_per_window: Optional[int] = None) -> None:
        self.exemplars_per_window = exemplars_per_window \
            if exemplars_per_window is not None \
            else max(1, env_int("SERVING_EXEMPLARS_PER_WINDOW", 3))
        self._reset()

    def _reset(self) -> None:
        self._stage_sums: Dict[str, float] = {}
        self._e2e_sum = 0.0
        self._ttfts: List[float] = []
        self._worst: List[dict] = []  # kept sorted, slowest first

    def add(self, seconds: float, stages: Optional[Dict[str, float]],
            trace: Optional[str] = None, req_id: Optional[str] = None,
            version: Optional[int] = None,
            ttft_s: Optional[float] = None) -> None:
        self._e2e_sum += max(0.0, seconds)
        closed = close_books(seconds, stages or {})
        for name, v in closed.items():
            self._stage_sums[name] = self._stage_sums.get(name, 0.0) + v
        if ttft_s is not None:
            self._ttfts.append(float(ttft_s))
        ex = {"e2e_s": round(seconds, 6), "stages":
              {k: round(v, 6) for k, v in closed.items() if v > 0}}
        if trace:
            ex["trace"] = trace
        if req_id:
            ex["req_id"] = req_id
        if version is not None:
            ex["version"] = version
        if ttft_s is not None:
            ex["ttft_s"] = round(ttft_s, 6)
        dom = dominant_stage(closed)
        if dom:
            ex["dominant_stage"] = dom
        self._worst.append(ex)
        self._worst.sort(key=lambda e: e["e2e_s"], reverse=True)
        del self._worst[self.exemplars_per_window:]

    def close(self) -> Tuple[dict, List[dict]]:
        """Close the window's books: returns ``(stage_doc, exemplars)``
        and resets.  ``stage_doc`` carries ``stages`` (summed seconds),
        ``stage_shares`` (fractions of attributed+residual wall-clock),
        ``unattributed_s``/``unattributed_frac`` and
        ``dominant_stage`` — all zero/None on an idle window."""
        sums, e2e, ttfts, worst = (self._stage_sums, self._e2e_sum,
                                   self._ttfts, self._worst)
        self._reset()
        shares = {k: (v / e2e if e2e > 0 else 0.0)
                  for k, v in sums.items()}
        unattrib = sums.get(RESIDUAL, 0.0)
        doc = {
            "stages": {k: round(v, 6) for k, v in sums.items() if v > 0},
            "stage_shares": {k: round(v, 4) for k, v in shares.items()
                             if v > 0},
            "unattributed_s": round(unattrib, 6),
            "unattributed_frac": round(unattrib / e2e, 4)
            if e2e > 0 else 0.0,
            "dominant_stage": dominant_stage(sums),
        }
        if ttfts:
            ttfts.sort()
            doc["ttft_p50_s"] = round(quantile(ttfts, 0.50), 6)
            doc["ttft_p99_s"] = round(quantile(ttfts, 0.99), 6)
        if worst:
            doc["worst_trace"] = worst[0].get("trace")
        return doc, worst


# ---------------------------------------------------------------------------
# Burn-rate SLO
# ---------------------------------------------------------------------------
class BurnRateSlo:
    """Multi-window error-budget burn-rate alerting (docs/OBSERVABILITY.md
    "Burn-rate SLOs").

    A request is *bad* when its latency exceeds
    ``HVD_TPU_SERVING_SLO_P99_MS``; the budget says what fraction of
    requests may be bad (``HVD_TPU_SERVING_ERROR_BUDGET``, default 1%).
    Burn rate = bad-fraction / budget over a window span.  A breach
    episode opens — ONE ``slo_breach`` finding — when the fast span
    (last ``HVD_TPU_SERVING_SLO_WINDOWS`` windows) AND the slow span
    (last ``HVD_TPU_SERVING_BURN_SLOW_WINDOWS``) both burn above
    ``HVD_TPU_SERVING_BURN_THRESHOLD`` and the closing window is itself
    over budget (onset confirmation: a recovered window never opens an
    episode).  The episode re-arms once the fast span burns under 1.0
    (the budget is no longer being spent faster than earned)."""

    def __init__(self, slo_p99_s: Optional[float] = None,
                 budget: Optional[float] = None,
                 fast_windows: Optional[int] = None,
                 slow_windows: Optional[int] = None,
                 threshold: Optional[float] = None) -> None:
        self.slo_p99_s = slo_p99_s if slo_p99_s is not None \
            else env_float("SERVING_SLO_P99_MS", 0.0) / 1000.0
        self.budget = budget if budget is not None \
            else min(1.0, max(1e-6, env_float("SERVING_ERROR_BUDGET",
                                              0.01)))
        self.fast_windows = fast_windows if fast_windows \
            else max(1, env_int("SERVING_SLO_WINDOWS", 2))
        self.slow_windows = slow_windows if slow_windows \
            else max(self.fast_windows,
                     env_int("SERVING_BURN_SLOW_WINDOWS", 12))
        self.threshold = threshold if threshold is not None \
            else env_float("SERVING_BURN_THRESHOLD", 10.0)
        self._history: deque = deque(maxlen=self.slow_windows)
        self._active = False

    @property
    def enabled(self) -> bool:
        return self.slo_p99_s > 0

    def is_bad(self, latency_s: float) -> bool:
        return self.enabled and latency_s > self.slo_p99_s

    @staticmethod
    def _burn(entries, budget: float) -> float:
        requests = sum(r for r, _ in entries)
        bad = sum(b for _, b in entries)
        if requests <= 0:
            return 0.0
        return (bad / requests) / budget

    def observe_window(self, requests: int, bad: int,
                       doc: Optional[dict] = None) -> Optional[dict]:
        """Feed one closed window; returns the finding's fields when
        this window opened a breach episode, else None."""
        if not self.enabled:
            return None
        self._history.append((int(requests), int(bad)))
        fast = list(self._history)[-self.fast_windows:]
        burn_fast = self._burn(fast, self.budget)
        burn_slow = self._burn(self._history, self.budget)
        if self._active and burn_fast < 1.0:
            # budget is being earned back faster than spent: re-arm
            self._active = False
        window_over = requests > 0 and (bad / requests) > self.budget
        if (len(self._history) >= self.fast_windows and window_over
                and burn_fast >= self.threshold
                and burn_slow >= self.threshold
                and not self._active):
            self._active = True
            fields = {
                "slo_s": self.slo_p99_s,
                "budget": self.budget,
                "burn_fast": round(burn_fast, 2),
                "burn_slow": round(burn_slow, 2),
                "bad": bad, "requests": requests,
            }
            if doc:
                for k in ("p99_s", "qps", "shed", "dominant_stage",
                          "worst_trace"):
                    if doc.get(k) is not None:
                        fields[k] = doc[k]
                share = (doc.get("stage_shares") or {}).get(
                    doc.get("dominant_stage") or "", None)
                if share is not None:
                    fields["dominant_share"] = share
            try:
                from horovod_tpu_torch.metrics.anomaly import report_finding
                report_finding("slo_breach", **fields)
            except Exception:
                pass
            return fields
        return None

    @property
    def active(self) -> bool:
        return self._active
