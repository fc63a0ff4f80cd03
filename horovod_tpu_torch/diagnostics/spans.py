"""Per-collective span ids: the cross-rank correlation key.

A copy of ``horovod_tpu/diagnostics/spans.py``. A span id is
``"<tensor_name>#<occurrence>"`` where the occurrence is a per-name
counter: every rank issues the same collectives in the same order, so each
rank computing the counter on its own yields the SAME span id for the same
logical collective, with no extra wire traffic.

The active span is tracked per-thread so log lines emitted inside a
traced collective can carry it (``common/logging.py`` appends it to the
record format).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

_counts: Dict[str, int] = {}
_lock = threading.Lock()
_active = threading.local()


def next_span(name: str) -> str:
    """Allocate the span id for this issue of ``name`` (per-name
    occurrence counter; deterministic across SPMD ranks)."""
    with _lock:
        # auto-named tensors mint fresh names forever: bound the map.
        # Every rank sees the same name sequence, so the reset lands on
        # the same enqueue on every rank and ids stay aligned.
        if len(_counts) >= 65536:
            _counts.clear()
        seq = _counts.get(name, 0) + 1
        _counts[name] = seq
    return f"{name}#{seq}"


def current_span() -> Optional[str]:
    """Span id of the collective being traced on THIS thread, if any."""
    return getattr(_active, "span", None)


@contextlib.contextmanager
def active_span(span: str) -> Iterator[str]:
    """Scope ``span`` as the thread's active span (for log joining)."""
    prev = current_span()
    _active.span = span
    try:
        yield span
    finally:
        _active.span = prev


def reset() -> None:
    """Drop all per-name counters (tests, and ``init``: a new world
    starts from a clean slate, so spans must too)."""
    with _lock:
        _counts.clear()
