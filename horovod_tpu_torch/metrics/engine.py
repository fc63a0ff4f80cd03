"""Derived view over an engine's control-plane counters.

The ``derived_ratios`` of ``horovod_tpu/metrics/engine.py``, copied: the
ratios an operator watches (cache-hit rate, fusion efficiency) from one
cumulative counters dict. The port has no negotiating C++ engine, so
``metrics_snapshot()`` passes it an empty dict and gets ``{}``, as the JAX
package does for a backend without one. The scrape-time
``EngineCollector`` arrives with the eager-collectives slice.
"""

from __future__ import annotations

from typing import Dict


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
