"""The public eager collective API on torch tensors.

Mirrors ``horovod_tpu/ops/collectives.py`` (reference: the per-framework
op surface, ``horovod/torch/mpi_ops.py:143-903``): sync and async
allreduce, grouped allreduce, quantized (grouped) allreduce, allgather,
broadcast, alltoall and reducescatter, with ``poll``/``synchronize``/
``join``/``barrier``. Each call goes to the eager backend of its process
set (:func:`horovod_tpu_torch.common.basics.eager_backend`: the core by
default); a result is a tensor on the input's device, in its dtype.

Semantics, as in the JAX package:

* ``op=Average`` divides by the set's size; a fractional pre/postscale or
  an average of an integral tensor raises (the core would truncate).
* ``root_rank`` of a broadcast is the GLOBAL rank, also under a set.
* Unnamed calls get ``<kind>.noname.<n>`` names; every rank's n-th
  unnamed call of a kind is the same tensor.
* Every call counts on ``hvd_collective_calls_total{kind}``, allocates a
  span id per tensor (``diagnostics.spans``, deterministic across ranks),
  flight-records its enqueue and completion, opens and closes a span on
  the host timeline, and stamps the span into the core's timeline when
  that is live.

The quantized allreduce goes through the port's quantizers
(:mod:`horovod_tpu_torch.compression.quantizers`): on a CUDA tensor each
rank's ``quantize`` and every contribution's ``dequantize`` are the
hand-written kernels. Codes and scales are all-gathered (the core fuses
every leaf of a group into one negotiation cycle) and each rank sums the
dequantized contributions in rank order.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from horovod_tpu_torch.common.basics import _require_init
from horovod_tpu_torch.common.process_sets import (ProcessSet,
                                                   global_process_set)
from horovod_tpu_torch.diagnostics import spans as _spans
from horovod_tpu_torch.diagnostics.flight_recorder import record_event
from horovod_tpu_torch.metrics.registry import default_registry
from horovod_tpu_torch.ops.backend import (Backend, HvdHandle, _is_integral,
                                           as_tensor, check_scale_dtype)
from horovod_tpu_torch.ops.reduce_op import Average, ReduceOp, Sum

_CALL_COUNTERS: dict = {}


def _trace_enqueue(kind: str, names, be: Backend) -> list:
    """Diagnostics of one enqueue: a span id per tensor, the flight
    record, the host timeline's spans and the core's timeline mark.
    Returns ``[(name, span), ...]``."""
    st = _require_init()
    if isinstance(names, str):
        names = [names]
    if not names:
        return []
    pairs = [(name, _spans.next_span(name)) for name in names]
    tl = st.timeline
    if tl is not None and tl.enabled:
        for name, span in pairs:
            tl.collective_begin(name, kind, span)
    mark = getattr(be, "timeline_mark", None)
    if mark is not None and be.core_timeline_enabled():
        for name, span in pairs:
            mark(f"enqueue_{kind}", span)
    record_event("enqueue", op=kind, name=pairs[0][0], n=len(pairs),
                 span=pairs[0][1])
    return pairs


def _trace_done(handle: HvdHandle, kind: str, pairs) -> HvdHandle:
    """Flight-record completion and close the timeline spans when the
    handle resolves; never raises into the wait."""
    if not pairs:
        return handle
    tl = _require_init().timeline

    def on_done(ok: bool) -> None:
        record_event("complete", op=kind, name=pairs[0][0],
                     span=pairs[0][1], ok=ok)
        if tl is not None and tl.enabled:
            for name, span in pairs:
                tl.collective_end(name, span, ok=ok)

    handle.add_done_callback(on_done)
    return handle


def _count_call(kind: str) -> None:
    """``hvd_collective_calls_total{kind}``; the counter is looked up in
    the registry each call, so a cleared registry gets a new one."""
    default_registry().counter(
        "hvd_collective_calls_total", help="eager collective API calls",
        labels={"kind": kind}).inc()


def _check_scales(values, prescale: float, postscale: float,
                  op: Optional[ReduceOp] = None) -> None:
    """One rule for every backend: no fractional scaling of an integral
    tensor, and no average of one (the same fractional 1/size)."""
    if prescale == 1.0 and postscale == 1.0 and op != ReduceOp.AVERAGE:
        return
    for v in values:
        dt = as_tensor(v).dtype
        if op == ReduceOp.AVERAGE and _is_integral(dt):
            raise ValueError(
                f"allreduce(op=Average) on an integral tensor ({dt}) would "
                "truncate; use op=Sum and divide, or cast to float first.")
        check_scale_dtype(dt, prescale)
        check_scale_dtype(dt, postscale)


_name_counter = [0]


def _auto_name(prefix: str, name: Optional[str]) -> str:
    if name is not None:
        return name
    _name_counter[0] += 1
    return f"{prefix}.noname.{_name_counter[0]}"


def _backend_for(process_set: ProcessSet) -> Backend:
    return _require_init().process_set_table.backend_for(process_set)


def _check_op(op: Optional[ReduceOp], average: Optional[bool]) -> ReduceOp:
    """Reference: ``handle_average_backwards_compatibility``."""
    if average is not None:
        if op is not None:
            raise ValueError("Cannot specify both op and average.")
        return Average if average else Sum
    return Average if op is None else op


def _enqueue(kind: str, names, be: Backend, submit) -> HvdHandle:
    pairs = _trace_enqueue(kind, names, be)
    with _spans.active_span(pairs[0][1] if pairs else None):
        h = submit()
    return _trace_done(h, kind, pairs)


# -- allreduce --------------------------------------------------------------

def allreduce_async(value, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: ProcessSet = global_process_set) -> HvdHandle:
    op = _check_op(op, average)
    _check_scales([value], prescale_factor, postscale_factor, op)
    _count_call("allreduce")
    be = _backend_for(process_set)
    name = _auto_name("allreduce", name)
    return _enqueue("allreduce", name, be, lambda: be.allreduce_async(
        name, value, op, prescale_factor, postscale_factor))


def allreduce(value, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set):
    return allreduce_async(value, average, name, op, prescale_factor,
                           postscale_factor, process_set).wait()


def grouped_allreduce_async(values: Sequence, average: Optional[bool] = None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: ProcessSet = global_process_set
                            ) -> HvdHandle:
    """Reference: ``grouped_allreduce_async_`` (``torch/mpi_ops.py:383``);
    the group fuses into one collective (``GroupTable``)."""
    op = _check_op(op, average)
    _check_scales(values, prescale_factor, postscale_factor, op)
    _count_call("grouped_allreduce")
    be = _backend_for(process_set)
    base = _auto_name("grouped_allreduce", name)
    names = [f"{base}.{i}" for i in range(len(values))]
    return _enqueue("grouped_allreduce", names, be,
                    lambda: be.grouped_allreduce_async(
                        names, list(values), op, prescale_factor,
                        postscale_factor))


def grouped_allreduce(values: Sequence, average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: ProcessSet = global_process_set) -> List:
    return grouped_allreduce_async(values, average, name, op, prescale_factor,
                                   postscale_factor, process_set).wait()


# -- quantized allreduce ----------------------------------------------------
#
# Quantized payloads (per-block scales) do not sum on the wire, so the
# quantized path is an allgather of codes and a local dequantize and
# reduce: ~4x fewer bytes than an fp32 ring allreduce for int8.

def _wire_view(codes: torch.Tensor):
    """(wire tensor, restore): payload dtypes the core has no code for
    (fp8) travel as same-shape uint8 views."""
    from horovod_tpu_torch.core.core_backend import DTYPE_CODES
    if codes.dtype in DTYPE_CODES:
        return codes, lambda g: g
    if codes.element_size() != 1:
        raise TypeError(f"cannot move {codes.dtype} payload over the eager "
                        "wire")
    return codes.view(torch.uint8), lambda g: g.view(codes.dtype)


def quantized_grouped_allreduce_async(values: Sequence, quantizer,
                                      op: Optional[ReduceOp] = None,
                                      name: Optional[str] = None,
                                      process_set: ProcessSet =
                                      global_process_set) -> HvdHandle:
    """Allreduce a group with ``quantizer`` compressing the wire:
    quantize, allgather of (codes, scales), dequantize every rank's
    contribution, sum in rank order. Sum and Average only. The pre- and
    wire bytes land on the compression metrics."""
    from horovod_tpu_torch.compression.metrics import record_compression
    from horovod_tpu_torch.compression.quantizers import Quantized

    op = Average if op is None else op
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"quantized allreduce supports Sum/Average, got {op}")
    _count_call("quantized_allreduce")
    base = _auto_name("quantized_allreduce", name)
    pre_bytes = wire_bytes = 0
    entries = []  # (codes handle, scales handle, restore, spec, dtype)
    for i, value in enumerate(values):
        t = as_tensor(value)
        q, spec = quantizer.quantize(t)
        codes, restore = _wire_view(q.values)
        pre_bytes += t.numel() * t.element_size()
        wire_bytes += q.wire_bytes
        # a leading unit dim: allgather concatenates the ranks on dim 0
        vh = allgather_async(codes[None], name=f"{base}.{i}.values",
                             process_set=process_set)
        sh = allgather_async(q.scales[None], name=f"{base}.{i}.scales",
                             process_set=process_set)
        entries.append((vh, sh, restore, spec, t.dtype))
    record_compression(quantizer.name, pre_bytes, wire_bytes)

    agg = HvdHandle()

    def waiter():
        try:
            outs = []
            for vh, sh, restore, spec, dtype in entries:
                gv, gs = restore(vh.wait()), sh.wait()
                out = None
                for r in range(gv.shape[0]):
                    part = quantizer.dequantize(Quantized(gv[r], gs[r]), spec)
                    out = part if out is None else out + part
                if op == ReduceOp.AVERAGE:
                    out = out / max(gv.shape[0], 1)
                outs.append(out.to(dtype))
            agg._set_result(outs)
        except BaseException as e:
            agg._set_error(e)

    threading.Thread(target=waiter, daemon=True).start()
    return agg


def quantized_grouped_allreduce(values: Sequence, quantizer,
                                op: Optional[ReduceOp] = None,
                                name: Optional[str] = None,
                                process_set: ProcessSet = global_process_set
                                ) -> List:
    return quantized_grouped_allreduce_async(
        values, quantizer, op, name, process_set).wait()


class _FirstOfHandle(HvdHandle):
    """The single element of a grouped handle, unwrapped at wait time."""

    def __init__(self, inner: HvdHandle):
        super().__init__()
        self._inner = inner

    def poll(self) -> bool:
        return self._inner.poll()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.is_set():
            try:
                self._set_result(self._inner.wait(timeout)[0])
            except TimeoutError:
                raise  # still in flight: stay retryable
            except BaseException as e:
                self._set_error(e)
        return super().wait(0)


def quantized_allreduce_async(value, quantizer,
                              op: Optional[ReduceOp] = None,
                              name: Optional[str] = None,
                              process_set: ProcessSet = global_process_set
                              ) -> HvdHandle:
    return _FirstOfHandle(quantized_grouped_allreduce_async(
        [value], quantizer, op, name, process_set))


def quantized_allreduce(value, quantizer, op: Optional[ReduceOp] = None,
                        name: Optional[str] = None,
                        process_set: ProcessSet = global_process_set):
    return quantized_allreduce_async(value, quantizer, op, name,
                                     process_set).wait()


# -- allgather, broadcast, alltoall, reducescatter ---------------------------

def allgather_async(value, name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set) -> HvdHandle:
    """Concatenation along dim 0 across ranks, whose dim 0 may differ
    (reference: ``EnqueueTensorAllgather``, ``operations.cc:1504-1556``)."""
    _count_call("allgather")
    be = _backend_for(process_set)
    name = _auto_name("allgather", name)
    return _enqueue("allgather", name, be,
                    lambda: be.allgather_async(name, value))


def allgather(value, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set):
    return allgather_async(value, name, process_set).wait()


def broadcast_async(value, root_rank: int, name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set) -> HvdHandle:
    """``root_rank`` is the GLOBAL rank, also under a process set."""
    _count_call("broadcast")
    be = _backend_for(process_set)
    name = _auto_name("broadcast", name)
    return _enqueue("broadcast", name, be,
                    lambda: be.broadcast_async(name, value, root_rank))


def broadcast(value, root_rank: int, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set):
    return broadcast_async(value, root_rank, name, process_set).wait()


def alltoall_async(value, splits: Optional[Sequence[int]] = None,
                   name: Optional[str] = None,
                   process_set: ProcessSet = global_process_set) -> HvdHandle:
    """Uneven alltoallv (reference: ``EnqueueTensorAlltoall``,
    ``operations.cc:1630-1710``): ``splits[i]`` rows of dim 0 go to rank
    i; the result is (received tensor, received splits)."""
    _count_call("alltoall")
    be = _backend_for(process_set)
    name = _auto_name("alltoall", name)
    return _enqueue("alltoall", name, be,
                    lambda: be.alltoall_async(name, value, splits))


def alltoall(value, splits: Optional[Sequence[int]] = None,
             name: Optional[str] = None,
             process_set: ProcessSet = global_process_set):
    return alltoall_async(value, splits, name, process_set).wait()


def reducescatter_async(value, op: Optional[ReduceOp] = None,
                        name: Optional[str] = None,
                        process_set: ProcessSet = global_process_set
                        ) -> HvdHandle:
    """Reduce-scatter over dim 0: this rank gets its block of the
    reduction."""
    op = op if op is not None else Sum
    _count_call("reducescatter")
    be = _backend_for(process_set)
    name = _auto_name("reducescatter", name)
    if be.size == 1:
        return _enqueue("reducescatter", name, be,
                        lambda: be.allreduce_async(name, value, op))
    return _enqueue("reducescatter", name, be,
                    lambda: be.reducescatter_async(name, value, op))


def reducescatter(value, op: Optional[ReduceOp] = None,
                  name: Optional[str] = None,
                  process_set: ProcessSet = global_process_set):
    return reducescatter_async(value, op, name, process_set).wait()


# -- handles and control ----------------------------------------------------

def poll(handle: HvdHandle) -> bool:
    return handle.poll()


def synchronize(handle: HvdHandle):
    return handle.wait()


def join(device: int = -1) -> int:
    """Reference: ``hvd.join`` (``torch/mpi_ops.py:860-903``): this rank
    has no more data; returns the rank that joined last."""
    from horovod_tpu_torch.common.basics import eager_backend
    return eager_backend().join(device)


def barrier(process_set: ProcessSet = global_process_set) -> None:
    _backend_for(process_set).barrier()
