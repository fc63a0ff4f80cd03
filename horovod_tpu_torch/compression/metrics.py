"""Compression observability: byte counters + ratio gauges.

A copy of ``horovod_tpu/compression/metrics.py``. Registered in the
process-wide metrics registry (:mod:`horovod_tpu_torch.metrics.registry`),
so ``hvd.metrics_snapshot()`` picks them up with no extra wiring:

* ``hvd_compression_pre_bytes_total{codec=...}`` — bytes the caller
  would have moved uncompressed,
* ``hvd_compression_wire_bytes_total{codec=...}`` — bytes actually
  put on the wire (values + scales),
* ``hvd_compression_ratio{codec=...}`` — cumulative pre/wire ratio
  (gauge, merged as ``mean`` across workers).

Byte accounting happens where each quantized transport path is issued
(the eager optimizer's per-leaf gather, ``preduce_quantized`` on a mesh
axis), from shapes alone, as the JAX package counts them:
each quantizer's ``wire_bytes(numel)`` is its ``_quantized_wire_bytes``
(values plus scales).
"""

from __future__ import annotations

from horovod_tpu_torch.metrics.registry import default_registry

# codecs whose first transfer was recorded (one ``codec_choice`` event
# each). The JAX module also caches the instruments themselves; here they
# are looked up in the registry every time (a dict lookup), so a cleared
# registry is not left counting into instruments it no longer holds.
_SEEN: set = set()


def _codec_instruments(codec: str):
    reg = default_registry()
    labels = {"codec": codec}
    return (reg.counter("hvd_compression_pre_bytes_total",
                        help="bytes before gradient compression",
                        labels=labels),
            reg.counter("hvd_compression_wire_bytes_total",
                        help="bytes actually moved on the wire",
                        labels=labels),
            reg.gauge("hvd_compression_ratio",
                      help="cumulative pre/wire compression ratio",
                      labels=labels, agg="mean"))


def record_compression(codec: str, pre_bytes: int, wire_bytes: int) -> None:
    """Account one compressed transfer; updates the cumulative ratio."""
    first = codec not in _SEEN
    _SEEN.add(codec)
    pre, wire, ratio = _codec_instruments(codec)
    pre.inc(pre_bytes)
    wire.inc(wire_bytes)
    if wire.value > 0:
        ratio.set(pre.value / wire.value)
    if first:
        # codec choice is a control-plane decision worth remembering in
        # a post-mortem; once per codec keeps the flight ring for the
        # per-collective evidence
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event("codec_choice", codec=codec, pre_bytes=pre_bytes,
                     wire_bytes=wire_bytes)


def compression_ratio(codec: str) -> float:
    """Cumulative ratio recorded so far for ``codec`` (0.0 if nothing
    was recorded yet)."""
    pre, wire, _ = _codec_instruments(codec)
    return (pre.value / wire.value) if wire.value > 0 else 0.0
