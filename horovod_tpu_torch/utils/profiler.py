"""Back-compat shim (mirrors ``horovod_tpu/utils/profiler.py``): the
device-side profiling helpers live in :mod:`horovod_tpu_torch.profiling`
(the capture manager over ``torch.profiler``, compile observability,
memory sampling); import from there in new code."""

from __future__ import annotations

from horovod_tpu_torch.profiling import (ProfileManager,  # noqa: F401
                                         annotate, annotate_fn,
                                         default_manager, start_trace,
                                         stop_trace, trace)

__all__ = ["start_trace", "stop_trace", "trace", "annotate",
           "annotate_fn", "ProfileManager", "default_manager"]
