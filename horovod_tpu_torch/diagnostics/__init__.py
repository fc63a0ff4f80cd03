"""Flight recorder & hang autopsy: the post-mortem observability layer.

Mirrors ``horovod_tpu/diagnostics/``. Three cooperating parts:

* **Cross-rank trace** — every rank can write a timeline shard
  (``HVD_TPU_TIMELINE_ALL_RANKS``) with wall-clock anchors
  (:mod:`.clock`); :mod:`.merge` folds N shards into one Perfetto trace,
  one track per rank.
* **Flight recorder** (:mod:`.flight_recorder`) — a bounded in-memory
  ring of recent control-plane events (step begin/end, checkpoint
  commits, codec choices, anomaly findings), dumpable on demand and
  automatically on crash; :mod:`.spans` gives the per-collective span
  ids log lines carry.
* **Hang watchdog** (:mod:`.watchdog`) + **autopsy** (:mod:`.autopsy`)
  — no step progress for ``HVD_TPU_WATCHDOG_SECONDS`` writes a bundle
  with per-rank stacks, the flight dump, the engine document, a metrics
  snapshot and the merged trace; rank 0 also fetches every peer's
  evidence over the exporter's ``/debug/*`` endpoints.

CLI: ``python -m horovod_tpu_torch.diagnostics merge|flight|timeline|trace``.
"""

from horovod_tpu_torch.diagnostics.flight_recorder import (  # noqa: F401
    FlightRecorder,
    install_crash_hooks,
    record_event,
    recorder,
)
from horovod_tpu_torch.diagnostics.spans import (  # noqa: F401
    active_span,
    current_span,
    next_span,
)
from horovod_tpu_torch.diagnostics.clock import (  # noqa: F401
    estimate_wall_offset,
)
from horovod_tpu_torch.diagnostics.merge import (  # noqa: F401
    merge_directory,
    merge_shards,
)
from horovod_tpu_torch.diagnostics.watchdog import (  # noqa: F401
    Watchdog,
    ensure_watchdog,
    notify_progress,
)
from horovod_tpu_torch.diagnostics.autopsy import write_autopsy  # noqa: F401
