"""Device-memory observability: the card's allocator stats on the step seam.

A copy of ``horovod_tpu/profiling/memory.py`` reading
``torch.cuda.memory_stats`` / ``torch.cuda.mem_get_info`` where the JAX
package reads PJRT's ``memory_stats()``. Jobs rarely die AT the OOM — they
die a thousand steps later, when a slow leak or a rare large batch
finally crosses the line. This module samples the process's card each
``HVD_TPU_HBM_SAMPLE_EVERY`` completed steps (default 1) and exports:

* ``hvd_hbm_bytes_in_use`` — bytes the caching allocator has handed out
  (``allocated_bytes.all.current``), merged ``max`` across ranks;
* ``hvd_hbm_peak_bytes`` — their peak so far
  (``allocated_bytes.all.peak``, max merge);
* ``hvd_hbm_limit_bytes`` — the card's memory (``mem_get_info``'s total,
  min merge);
* ``hvd_hbm_oom_margin_bytes`` — ``limit - peak``, merged **min over
  ranks**;

plus an ``hbm_growth`` anomaly finding (via
:mod:`horovod_tpu_torch.metrics.anomaly`) when in-use bytes grow
window-over-window for ``HVD_TPU_HBM_GROWTH_WINDOWS`` consecutive
windows — the slow-leak signature a threshold alert misses until it is
too late.

A process without a card reports no stats: no gauges, no detector —
absence of data must not read as zero bytes free.  Tests inject a fake
``stats_fn``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

DEFAULT_SAMPLE_EVERY = 1
DEFAULT_GROWTH_WINDOW = 20
DEFAULT_GROWTH_WINDOWS = 4
DEFAULT_GROWTH_MIN_FRAC = 0.01


def _envi(name: str, default: int) -> int:
    from horovod_tpu_torch.common.config import env_int
    return env_int(name, default)


def _envf(name: str, default: float) -> float:
    from horovod_tpu_torch.common.config import env_float
    return env_float(name, default)


def device_stats() -> Optional[List[dict]]:
    """The process's card's stats under the JAX package's keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), as a list
    of one dict.  Returns ``[]`` without a card (a statless backend: the
    CPU) and ``None`` when the read itself failed (a transient error must
    not be mistaken for "this backend never has stats").  Only the
    current card is read: asking another would create a CUDA context on
    it."""
    try:
        import torch
        if not torch.cuda.is_available():
            return []
        dev = torch.cuda.current_device()
        st = torch.cuda.memory_stats(dev)
        return [{"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
                 "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                                 0)),
                 "bytes_limit": int(_card_bytes(dev))}]
    except Exception:
        return None


_CARD_BYTES: Dict[int, int] = {}


def _card_bytes(dev: int) -> int:
    """The card's memory (``mem_get_info``'s total; fixed, read once)."""
    if dev not in _CARD_BYTES:
        import torch
        _CARD_BYTES[dev] = torch.cuda.mem_get_info(dev)[1]
    return _CARD_BYTES[dev]


class HbmGrowthDetector:
    """Window-mean growth detector for slow leaks: consecutive windows
    whose mean in-use bytes each grow by at least ``min_frac`` over the
    previous window, ``windows`` times in a row, flag once per episode
    (a non-growing window re-arms)."""

    def __init__(self, window: Optional[int] = None,
                 windows: Optional[int] = None,
                 min_frac: Optional[float] = None) -> None:
        self.window = max(2, window or _envi("HBM_GROWTH_WINDOW",
                                             DEFAULT_GROWTH_WINDOW))
        self.windows = max(2, windows or _envi("HBM_GROWTH_WINDOWS",
                                               DEFAULT_GROWTH_WINDOWS))
        self.min_frac = min_frac if min_frac is not None else \
            _envf("HBM_GROWTH_MIN_FRAC", DEFAULT_GROWTH_MIN_FRAC)
        self._acc: List[float] = []
        self._prev_mean: Optional[float] = None
        self._first_mean: Optional[float] = None
        self._run = 0
        self._active = False

    def observe(self, bytes_in_use: float) -> Optional[dict]:
        self._acc.append(float(bytes_in_use))
        if len(self._acc) < self.window:
            return None
        mean = sum(self._acc) / len(self._acc)
        self._acc = []
        prev, self._prev_mean = self._prev_mean, mean
        if prev is None:
            self._first_mean = mean
            return None
        if mean > prev * (1.0 + self.min_frac):
            self._run += 1
        else:
            self._run = 0
            self._active = False
            self._first_mean = mean
        if self._active or self._run < self.windows:
            return None
        self._active = True
        base = self._first_mean or prev
        return {"kind": "hbm_growth",
                "bytes_in_use": int(mean),
                "baseline_bytes": int(base),
                "growth_ratio": round(mean / base, 4) if base else None,
                "windows": self._run,
                "window_steps": self.window}


class MemorySampler:
    """Step-seam sampler: refreshes the HBM gauges and feeds the growth
    detector.  ``stats_fn`` is injectable for tests; the default reads
    the process's card (:func:`device_stats`)."""

    def __init__(self, registry=None,
                 stats_fn: Optional[Callable[[], List[dict]]] = None,
                 sample_every: Optional[int] = None) -> None:
        self._reg = registry
        self._stats_fn = stats_fn or device_stats
        self.sample_every = max(1, sample_every or _envi(
            "HBM_SAMPLE_EVERY", DEFAULT_SAMPLE_EVERY))
        self.detector = HbmGrowthDetector()
        self._n = 0
        self._lock = threading.Lock()
        self._dead = False  # backend reported no stats: stop asking
        self._seen_stats = False  # any sample ever carried stats

    def _registry(self):
        if self._reg is None:
            from horovod_tpu_torch.metrics.registry import default_registry
            self._reg = default_registry()
        return self._reg

    def on_step(self, step: int) -> Optional[dict]:
        """Sample (subject to the stride); returns an ``hbm_growth``
        finding dict when the detector fired this sample (the caller —
        the profiling step hook — routes it to the anomaly engine)."""
        with self._lock:
            if self._dead:
                return None
            self._n += 1
            if (self._n - 1) % self.sample_every:
                return None
        stats = self._stats_fn()
        if stats is None:
            # the read failed (transient backend error): keep polling —
            # a bad first sample must not disable HBM observability for
            # the process lifetime
            return None
        if not stats:
            # clean contact with a statless backend (CPU): go quiet
            # forever instead of polling every step for nothing — but
            # only while NO sample has ever carried stats (a backend
            # that reported stats once is merely hiccuping)
            with self._lock:
                if not self._seen_stats:
                    self._dead = True
            return None
        with self._lock:
            self._seen_stats = True
        in_use = max(s.get("bytes_in_use", 0) for s in stats)
        peak = max(s.get("peak_bytes_in_use", 0) for s in stats)
        limits = [s.get("bytes_limit") for s in stats
                  if isinstance(s.get("bytes_limit"), (int, float))
                  and s.get("bytes_limit")]
        try:
            reg = self._registry()
            reg.gauge("hvd_hbm_bytes_in_use",
                      help="device bytes in use (worst local device)",
                      agg="max").set(float(in_use))
            reg.gauge("hvd_hbm_peak_bytes",
                      help="peak device bytes in use (worst local "
                           "device)",
                      agg="max").set(float(peak))
            if limits:
                limit = min(limits)
                reg.gauge("hvd_hbm_limit_bytes",
                          help="device memory limit (smallest local "
                               "device)",
                          agg="min").set(float(limit))
                margin = min(
                    float(s["bytes_limit"]) -
                    float(s.get("peak_bytes_in_use",
                                s.get("bytes_in_use", 0)))
                    for s in stats
                    if isinstance(s.get("bytes_limit"), (int, float))
                    and s.get("bytes_limit"))
                reg.gauge("hvd_hbm_oom_margin_bytes",
                          help="limit minus peak of the tightest "
                               "device; fleet-merged as min over ranks",
                          agg="min").set(margin)
        except Exception:
            pass
        return self.detector.observe(in_use)


_SAMPLER: Optional[MemorySampler] = None
_LOCK = threading.Lock()


def default_sampler() -> MemorySampler:
    global _SAMPLER
    if _SAMPLER is None:
        with _LOCK:
            if _SAMPLER is None:
                _SAMPLER = MemorySampler()
    return _SAMPLER


def reset() -> None:
    global _SAMPLER
    with _LOCK:
        _SAMPLER = None
