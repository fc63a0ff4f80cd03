"""Never-raise metric increments for control-plane paths.

A copy of ``horovod_tpu/common/safe_metrics.py``. Accounting must not fail
the operation it counts, and the callers are light infrastructure modules
(the trace context) that must not pull the metrics package at import time,
so the registry import happens at the first call.
"""

from __future__ import annotations


def safe_inc(name: str, help_text: str = "", **labels) -> None:
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        default_registry().counter(name, help=help_text,
                                   labels=labels or None).inc()
    except Exception:
        pass
