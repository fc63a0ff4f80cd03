"""Compile observability: the port's kernel builds as compiles.

Mirrors ``horovod_tpu/profiling/compile_watch.py``. The JAX package's
compiles are XLA's (jit traces, backend compiles); the port has no jit. Its
compiles are the ``nvcc`` builds of :mod:`horovod_tpu_torch.ops._build`:
a library missing from the build directory is built by the first call that
needs it (so the build lands inside that step) or by ``build_all``. Each
build is recorded under the JAX package's metric names:

* ``hvd_compile_seconds{function=<library>}`` — the build's wall time,
  per library (label set bounded; overflow lands on ``other``);
* ``hvd_compile_total`` — builds;
* ``hvd_compile_cache_miss_total`` — builds too: a build happens exactly
  when the library's hashed ``.so`` is missing from the build directory.

:func:`totals` ``["seconds_total"]`` is what the goodput ledger's
``compile`` category reads. The builds of one ``build_all`` run in
parallel, so it adds the batch's wall time once, not the sum of the
per-library times.

The serving engine's CUDA graph captures are the port's other compiles
(the JAX engine jits its two step functions; the port captures each once,
:mod:`horovod_tpu_torch.serving.generate.engine`): :func:`note_capture`
records one under the JAX function's name (``gen_decode_step``,
``gen_prefill_chunk``), so :func:`per_function_compiles` counts captures
per step function as the JAX package counts compiles per jitted function.

The JAX package's ``jax.monitoring`` and ``jax_log_compiles`` sources have
no counterpart here, and neither has its ``recompile_storm`` detector: a
library's hash names its source, so a process builds each library at
most once.
"""

from __future__ import annotations

import threading
from typing import Dict

MAX_FUNCTION_LABELS = 32

_LOCK = threading.Lock()
_label_set: set = set()
_builds: Dict[str, int] = {}
_totals = {"compiles": 0, "cache_misses": 0, "seconds_total": 0.0}


def enabled() -> bool:
    from horovod_tpu_torch.common.config import env_bool
    return env_bool("COMPILE_METRICS", True)


def _function_label(name: str) -> str:
    """Bound the label cardinality, as the JAX package does."""
    with _LOCK:
        if name in _label_set:
            return name
        if len(_label_set) < MAX_FUNCTION_LABELS:
            _label_set.add(name)
            return name
    return "other"


def note_build(seconds: Dict[str, float], wall_s: float) -> None:
    """One batch of builds: ``seconds`` maps each library built to its
    build's wall time, ``wall_s`` is the batch's. Never raises."""
    if not seconds or not enabled():
        return
    with _LOCK:
        for name in seconds:
            _builds[name] = _builds.get(name, 0) + 1
        _totals["compiles"] += len(seconds)
        _totals["cache_misses"] += len(seconds)
        _totals["seconds_total"] += float(wall_s)
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        reg = default_registry()
        for name, s in seconds.items():
            reg.counter("hvd_compile_total",
                        help="kernel library builds (nvcc) and CUDA graph "
                             "captures").inc()
            reg.counter(
                "hvd_compile_cache_miss_total",
                help="kernel libraries missing from the build directory "
                     "(each one is built)").inc()
            reg.histogram(
                "hvd_compile_seconds",
                help="kernel library build (or graph capture) time",
                labels={"function": _function_label(name)}).observe(s)
    except Exception:
        pass


def note_capture(name: str, seconds: float) -> None:
    """One CUDA graph capture of the step function ``name`` (warm-up
    included in ``seconds``), counted as a compile of that function.
    Never raises."""
    if not enabled():
        return
    with _LOCK:
        _builds[name] = _builds.get(name, 0) + 1
        _totals["compiles"] += 1
        _totals["seconds_total"] += float(seconds)
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        reg = default_registry()
        reg.counter("hvd_compile_total",
                    help="kernel library builds (nvcc) and CUDA graph "
                         "captures").inc()
        reg.histogram(
            "hvd_compile_seconds",
            help="kernel library build (or graph capture) time",
            labels={"function": _function_label(name)}).observe(seconds)
    except Exception:
        pass


def totals() -> dict:
    """Process-lifetime build totals (``compiles``, ``cache_misses``,
    ``seconds_total``)."""
    with _LOCK:
        return dict(_totals)


def per_function_compiles() -> Dict[str, int]:
    """Builds per library and CUDA graph captures per step function."""
    with _LOCK:
        return dict(_builds)


def reset_counts() -> None:
    """Forget per-library counts, totals and the label budget (tests,
    re-init); the registry instruments are cumulative and stay."""
    with _LOCK:
        _builds.clear()
        _label_set.clear()
        _totals.update({"compiles": 0, "cache_misses": 0,
                        "seconds_total": 0.0})
