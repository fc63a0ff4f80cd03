"""Diagnostics: the flight recorder and per-collective span ids.

Mirrors part of ``horovod_tpu/diagnostics/``: the bounded flight ring
(:mod:`.flight_recorder`) and the span ids log lines carry (:mod:`.spans`).
The hang watchdog, the autopsy bundle, the timeline merge and its clock
offsets arrive with the next observability slice (ROADMAP).
"""

from horovod_tpu_torch.diagnostics.flight_recorder import (  # noqa: F401
    FlightRecorder,
    record_event,
    recorder,
)
from horovod_tpu_torch.diagnostics.spans import (  # noqa: F401
    active_span,
    current_span,
    next_span,
)
