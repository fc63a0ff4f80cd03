"""Metrics & telemetry: the train-loop half of the observability plane.

Mirrors ``horovod_tpu/metrics/``:

* :mod:`~horovod_tpu_torch.metrics.registry` — dependency-free Counter /
  Gauge / Histogram with mergeable snapshots and Prometheus text rendering;
* :mod:`~horovod_tpu_torch.metrics.engine` — ``derived_ratios``;
* :mod:`~horovod_tpu_torch.metrics.timeseries` — step-aligned history:
  bounded ring + ``HVD_TPU_OBS_DIR`` JSONL in the JAX package's format;
* :mod:`~horovod_tpu_torch.metrics.anomaly` — online EWMA+MAD detectors
  over the series;
* :mod:`~horovod_tpu_torch.metrics.goodput` — the closed-books wall-clock
  ledger;
* :mod:`~horovod_tpu_torch.metrics.mfu` — the card's peak FLOPs and a
  step's FLOP count;
* :mod:`~horovod_tpu_torch.metrics.exporter` — the per-worker HTTP
  exporter (``/metrics``, ``/healthz``, ``/readyz``, ``/debug/*``);
* :mod:`~horovod_tpu_torch.metrics.fleet` — the fan-in tree behind
  rank 0's ``/metrics/fleet``.

CLI: ``python -m horovod_tpu_torch.metrics top|history``.
"""

from horovod_tpu_torch.metrics.registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    render_prometheus,
)
from horovod_tpu_torch.metrics.engine import derived_ratios  # noqa: F401
from horovod_tpu_torch.metrics.timeseries import (  # noqa: F401
    StepSeriesRecorder,
    TimeSeriesRing,
    read_series,
)
from horovod_tpu_torch.metrics.anomaly import AnomalyEngine  # noqa: F401
from horovod_tpu_torch.metrics.exporter import MetricsExporter  # noqa: F401
from horovod_tpu_torch.metrics.fleet import FleetAggregator  # noqa: F401
