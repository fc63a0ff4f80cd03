"""Back-compat shim (mirrors ``horovod_tpu/utils/profiler.py``): the
device-side profiling helpers live in :mod:`horovod_tpu_torch.profiling`
(the capture manager over ``torch.profiler``, compile observability,
memory sampling); import from there in new code. The JAX shim's
``start_trace``/``stop_trace``/``trace`` wrap ``jax.profiler`` and have
no counterpart here: ``torch.profiler`` is used directly or through
``ProfileManager``."""

from __future__ import annotations

from horovod_tpu_torch.profiling import (ProfileManager,  # noqa: F401
                                         annotate, annotate_fn,
                                         default_manager)

__all__ = ["annotate", "annotate_fn", "ProfileManager", "default_manager"]
