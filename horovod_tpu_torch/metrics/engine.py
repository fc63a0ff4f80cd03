"""Derived view over the eager engine's control-plane counters.

Mirrors ``horovod_tpu/metrics/engine.py``. The core exports raw
monotonic counters (``hvd_counters_json`` → ``counters()``: cycles, cache
hits/misses/evictions, fused units, bytes moved); ``derived_ratios``
turns them into the ratios an operator watches (cache-hit rate, fusion
efficiency), and :class:`EngineCollector`, run by the worker exporter at
every scrape and by its fleet node before every push, mirrors them into
the registry as ``hvd_engine_*`` gauges (with ``hvd_straggler_*`` from
the coordinator's report and rates between successive scrapes).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from horovod_tpu_torch.metrics.registry import Registry, default_registry

# engine counter -> rate gauge derived from its delta
_RATE_KEYS = ("bytes_allreduced", "bytes_allgathered", "responses_executed")


def derived_ratios(c: Dict[str, float]) -> Dict[str, float]:
    """Pure ratios from one cumulative counters dict (no windowing):
    ``cache_hit_rate`` (hits / negotiated submissions), ``fusion_ratio``
    (fraction of executed responses that were multi-tensor units) and
    ``tensors_per_fused_unit``."""
    out: Dict[str, float] = {}
    hits = float(c.get("cache_hits", 0))
    misses = float(c.get("cache_misses", 0))
    if hits + misses > 0:
        out["cache_hit_rate"] = hits / (hits + misses)
    executed = float(c.get("responses_executed", 0))
    fused_units = float(c.get("fused_units", 0))
    if executed > 0:
        out["fusion_ratio"] = fused_units / executed
    tensors_fused = float(c.get("tensors_fused", 0))
    if fused_units > 0:
        out["tensors_per_fused_unit"] = tensors_fused / fused_units
    return out


class EngineCollector:
    """Scrape-time collector: pulls ``counters_fn()`` (and optionally
    ``stragglers_fn()``), refreshes ``hvd_engine_*`` metrics in the
    registry. Safe to call when the engine is not initialized — a failing
    or empty pull leaves the previous values in place."""

    def __init__(self, counters_fn: Callable[[], dict],
                 registry: Optional[Registry] = None,
                 stragglers_fn: Optional[Callable[[], dict]] = None
                 ) -> None:
        self._counters_fn = counters_fn
        self._stragglers_fn = stragglers_fn
        self._reg = registry or default_registry()
        self._prev: Optional[Dict[str, float]] = None
        self._prev_t = 0.0

    def collect(self) -> None:
        try:
            c = self._counters_fn()
        except Exception:
            return
        now = time.monotonic()
        if c:
            for key, val in c.items():
                if key.startswith("autotune_"):
                    # live tuner decisions (fusion bytes, cycle ms,
                    # hierarchical/cache flips) are config VALUES, not
                    # cumulative counters: first-class hvd_autotune_*
                    # gauges, max-merged (every rank mirrors the same
                    # coordinator-tuned value) — docs/OBSERVABILITY.md
                    # "Autotune metrics"
                    sub = key[len("autotune_"):]
                    self._reg.gauge(
                        f"hvd_autotune_{sub}",
                        help=f"engine autotune decision: {sub}",
                        agg="max").set(float(val))
                    continue
                self._reg.gauge(
                    f"hvd_engine_{key}",
                    help=f"engine counter {key} (cumulative)",
                    agg="sum").set(float(val))
            # stall inspector surfaced as first-class metrics (beyond
            # the generic hvd_engine_* mirror): a true Prometheus
            # counter for warnings plus the live stalled-tensor gauge
            # (docs/OBSERVABILITY.md "Stall metrics")
            if "stall_warnings" in c:
                counter = self._reg.counter(
                    "hvd_stall_warnings_total",
                    help="stall-inspector warnings issued (tensors that "
                         "crossed STALL_CHECK_TIME_SECONDS)")
                cur = float(c["stall_warnings"])
                prev_sw = (self._prev or {}).get("stall_warnings")
                if prev_sw is None:
                    # first sample from this collector: sync against the
                    # registry total (another collector generation may
                    # already have recorded part of it)
                    delta = cur - counter.value
                else:
                    delta = cur - float(prev_sw)
                if delta < 0:
                    # engine restarted (elastic re-mesh resets the C++
                    # counters): the whole new total is new warnings
                    delta = cur
                if delta > 0:
                    counter.inc(delta)
            if "stalled_tensors" in c:
                self._reg.gauge(
                    "hvd_stalled_tensors",
                    help="tensors currently past the stall warning "
                         "threshold", agg="sum").set(
                    float(c["stalled_tensors"]))
            for key, val in derived_ratios(c).items():
                self._reg.gauge(
                    f"hvd_engine_{key}",
                    help=f"engine derived ratio {key}",
                    agg="mean").set(val)
            if self._prev is not None and now > self._prev_t:
                dt = now - self._prev_t
                for key in _RATE_KEYS:
                    if key in c and key in self._prev:
                        delta = float(c[key]) - float(self._prev[key])
                        self._reg.gauge(
                            f"hvd_engine_{key}_per_second",
                            help=f"engine {key} rate over the last "
                                 "scrape interval",
                            agg="sum").set(max(delta, 0.0) / dt)
            self._prev, self._prev_t = dict(c), now
        if self._stragglers_fn is None:
            return
        try:
            s = self._stragglers_fn()
        except Exception:
            return
        for rank, info in (s.get("ranks") or {}).items():
            self._reg.gauge(
                "hvd_straggler_wait_seconds",
                help="total negotiation wait attributed to this rank "
                     "being last to announce",
                labels={"rank": str(rank)}, agg="max").set(
                float(info.get("wait_seconds", 0.0)))
            self._reg.gauge(
                "hvd_straggler_held_count",
                help="tensors for which this rank was the last announcer",
                labels={"rank": str(rank)}, agg="max").set(
                float(info.get("held_count", 0)))
