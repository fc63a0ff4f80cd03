"""Causal tracing: the trace context.

A copy of the trace context of ``horovod_tpu/tracing/__init__.py``: a
dependency-free W3C-traceparent-style context (128-bit trace id, 64-bit
span id, parent span id), a thread-local ACTIVE context that the flight
recorder stamps into every event it records, spans counted as
``hvd_trace_spans_total{plane}``, and malformed incoming contexts as
``hvd_trace_dropped_total``. Anomaly findings root a trace
(:mod:`horovod_tpu_torch.metrics.anomaly`).

The JAX package also carries the context across processes: as a
``traceparent`` HTTP header on KV and serving hops and as a field of KV
documents (``from_doc``). Those carriers arrive with the port's runner and
serving slices; the wire format (:func:`encode`/:func:`decode`) is here
already.

Knobs: ``HVD_TPU_TRACE`` (default on) kills every context source when
0; ``HVD_TPU_TRACE_SAMPLE`` (default 1.0) samples new ROOT traces by
the head of the trace id, so the keep/drop decision is a property of
the id itself and every process agrees on it without coordination.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

from horovod_tpu_torch.common.safe_metrics import safe_inc as _metric

#: the header / document field name (W3C trace-context wire format:
#: ``00-<32 hex trace id>-<16 hex span id>-<2 hex flags>``)
TRACEPARENT = "traceparent"

_SPAN_EVENT = "trace_span"  #: flight-recorder event kind for spans

_tls = threading.local()


class TraceContext:
    """One span's identity: ``(trace_id, span_id, parent_id)``.

    ``trace_id`` is 32 lowercase hex chars (128-bit), ``span_id`` and
    ``parent_id`` 16 (64-bit); ``parent_id`` is None for a root span
    and for spans decoded off the wire (the wire format carries only
    trace+span — the receiver's :func:`child` restores parentage)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def fields(self) -> Dict[str, str]:
        """The stamp for log lines / flight events / findings."""
        out = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id:
            out["parent"] = self.parent_id
        return out

    def __repr__(self) -> str:  # debugging aid, never parsed
        return (f"TraceContext({self.trace_id[:8]}…, {self.span_id},"
                f" parent={self.parent_id})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id)


def enabled() -> bool:
    """``HVD_TPU_TRACE`` — default on; 0 makes every context source
    return None, so call sites degrade to the untraced behavior with
    zero per-event cost beyond this check."""
    return os.environ.get("HVD_TPU_TRACE", "") not in ("0", "false",
                                                       "off")


def sample_rate() -> float:
    """``HVD_TPU_TRACE_SAMPLE`` ∈ [0, 1] — fraction of new ROOT traces
    kept (child spans always follow their root's fate)."""
    raw = os.environ.get("HVD_TPU_TRACE_SAMPLE", "")
    if not raw:
        return 1.0
    try:
        return min(max(float(raw), 0.0), 1.0)
    except ValueError:
        return 1.0


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def _count(plane: str) -> None:
    _metric("hvd_trace_spans_total",
            "trace spans created, per plane", plane=plane)


def new_trace(plane: str = "generic") -> Optional[TraceContext]:
    """A new root span (None when tracing is off or the trace is
    sampled out).  The sampling decision is derived from the trace id's
    leading 32 bits, so any process re-deriving it from the id alone
    reaches the same verdict."""
    if not enabled():
        return None
    trace_id = _rand_hex(16)
    rate = sample_rate()
    if rate < 1.0 and int(trace_id[:8], 16) / 0xFFFFFFFF >= rate:
        return None
    _count(plane)
    return TraceContext(trace_id, _rand_hex(8), None)


def child(ctx: Optional[TraceContext],
          plane: str = "generic") -> Optional[TraceContext]:
    """A child span of ``ctx`` (None-safe: no parent, no span)."""
    if ctx is None or not enabled():
        return None
    _count(plane)
    return TraceContext(ctx.trace_id, _rand_hex(8), ctx.span_id)


def encode(ctx: Optional[TraceContext]) -> Optional[str]:
    return ctx.traceparent if ctx is not None else None


def _is_hex(s: str, n: int) -> bool:
    if len(s) != n:
        return False
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def decode(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a ``traceparent`` value; a malformed one is IGNORED
    (None + ``hvd_trace_dropped_total``), never an error.  An absent value
    (None/empty) is simply untraced, not a drop."""
    if not header or not enabled():
        return None
    parts = str(header).strip().split("-")
    if (len(parts) == 4 and parts[0] == "00"
            and _is_hex(parts[1], 32) and _is_hex(parts[2], 16)
            and int(parts[1], 16) != 0 and int(parts[2], 16) != 0):
        return TraceContext(parts[1].lower(), parts[2].lower(), None)
    _metric("hvd_trace_dropped_total",
            "malformed/refused incoming trace contexts (the event "
            "proceeds untraced)")
    return None


# -- thread-local active context ----------------------------------------------
def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> None:
    _tls.ctx = ctx


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[
        Optional[TraceContext]]:
    """Make ``ctx`` the thread's active context for the block: flight
    events recorded inside are stamped with it.  None deactivates (an
    untraced block inside a traced one stays untraced)."""
    prev = current()
    set_current(ctx)
    try:
        yield ctx
    finally:
        set_current(prev)


def record_span(plane: str, name: str, ctx: Optional[TraceContext],
                start: Optional[float] = None,
                dur_s: Optional[float] = None, **attrs: Any) -> None:
    """Record one completed span into the flight ring (kind
    ``trace_span``): the durable form every reader joins on.  ``start``
    is wall-clock seconds (default now − dur), ``dur_s`` the span's
    measured duration.  No-op without a context; never raises."""
    if ctx is None:
        return
    try:
        if dur_s is None:
            dur_s = 0.0
        if start is None:
            start = time.time() - dur_s
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event(_SPAN_EVENT, plane=plane, name=name,
                     start=round(float(start), 6),
                     dur_s=round(float(dur_s), 6), **ctx.fields(),
                     **{k: v for k, v in attrs.items() if v is not None})
    except Exception:
        pass  # tracing must never take down the traced path
