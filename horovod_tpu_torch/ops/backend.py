"""Process-level communication backends of the eager collectives.

Mirrors ``horovod_tpu/ops/backend.py`` (the seam the reference fills with
its OperationManager priority list, ``horovod/common/operations.cc:144-
253``) on torch tensors:

* :class:`LocalBackend`: one process; every collective is the (scaled)
  identity over its one contributor.
* ``CoreBackend`` (:mod:`horovod_tpu_torch.core.core_backend`): the C++
  negotiation core, built from ``cpp/`` for the port, with its TCP ring
  collectives over host buffers. The default for a launched world of more
  than one process.
* ``DistBackend`` (:mod:`horovod_tpu_torch.ops.dist_backend`): the eager
  data plane over ``torch.distributed`` (NCCL keeps CUDA tensors on the
  card), the counterpart of the JAX package's ``XLA_EAGER``; selected with
  ``HVD_TPU_EAGER_BACKEND=dist``.

Every backend returns :class:`HvdHandle` from its ``*_async`` calls,
mirroring the reference's ``EnqueueTensorAllreduce`` + ``handle_manager``
(``horovod/torch/mpi_ops_v2.cc:89-127,566-580``). Results are torch
tensors on the device and in the dtype of the input.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.ops.reduce_op import ReduceOp


class HvdHandle:
    """Async completion handle (reference: ``HandleManager``,
    ``horovod/torch/handle_manager.{h,cc}``)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def _set_result(self, value: Any) -> None:
        self._result = value
        self._event.set()
        self._fire_done(True)

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()
        self._fire_done(False)

    def add_done_callback(self, cb) -> None:
        """Invoke ``cb(ok: bool)`` once when the handle completes (at once
        if it already has). The diagnostics layer records completion
        through it; a callback's error is swallowed, so observability can
        never fail a wait."""
        self._done_cb = cb
        if self._event.is_set():
            self._fire_done(self._error is None)

    def _fire_done(self, ok: bool) -> None:
        # dict.pop is atomic under the GIL: when completion and
        # add_done_callback race, exactly one caller wins the pop
        cb = self.__dict__.pop("_done_cb", None)
        if cb is not None:
            try:
                cb(ok)
            except Exception:
                pass

    def poll(self) -> bool:
        """Reference: ``PollHandle`` (``mpi_ops_v2.cc:566-571``)."""
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Reference: ``WaitAndClear`` (``mpi_ops_v2.cc:573-580``)."""
        if not self._event.wait(timeout):
            raise TimeoutError("collective did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result

    @staticmethod
    def done(value: Any) -> "HvdHandle":
        h = HvdHandle()
        h._set_result(value)
        return h


class Backend(abc.ABC):
    """Communicator over a process group (the global set or a subset)."""

    def __init__(self, rank: int, size: int) -> None:
        self.rank = rank
        self.size = size

    @abc.abstractmethod
    def allreduce_async(self, name: str, value, op: ReduceOp,
                        prescale: float = 1.0, postscale: float = 1.0
                        ) -> HvdHandle: ...

    @abc.abstractmethod
    def grouped_allreduce_async(self, names: Sequence[str], values: Sequence,
                                op: ReduceOp, prescale: float = 1.0,
                                postscale: float = 1.0) -> HvdHandle: ...

    @abc.abstractmethod
    def allgather_async(self, name: str, value) -> HvdHandle: ...

    @abc.abstractmethod
    def broadcast_async(self, name: str, value, root_rank: int) -> HvdHandle: ...

    @abc.abstractmethod
    def alltoall_async(self, name: str, value,
                       splits: Optional[Sequence[int]] = None) -> HvdHandle: ...

    def reducescatter_async(self, name: str, value, op: ReduceOp) -> HvdHandle:
        """Default: allreduce, then this rank's dim-0 slice. A backend with
        a native reduce-scatter overrides it."""
        h = self.allreduce_async(name, value, op)
        out = HvdHandle()

        def finish():
            try:
                out._set_result(_my_rows(h.wait(), self.rank, self.size))
            except BaseException as e:  # propagate to the waiter
                out._set_error(e)

        threading.Thread(target=finish, daemon=True).start()
        return out

    @abc.abstractmethod
    def barrier(self) -> None: ...

    def join(self, device: int = -1) -> int:
        """Reference Join (``EnqueueJoin``, ``operations.cc:1714-1742``):
        declare this rank out of data; returns the last joiner's rank.
        Raises unless the backend negotiates: a backend that pretended
        would deadlock the other ranks, which keep waiting for collectives
        the joined rank never submits."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support join(); use the core "
            "(the default eager backend) for join-style uneven data")

    # -- observability ------------------------------------------------------
    def counters(self) -> dict:
        """Control-plane counters; empty without a negotiating engine."""
        return {}

    def start_core_timeline(self, file_path: str,
                            mark_cycles: bool = False) -> bool:
        """Start the backend's native timeline; True if the backend owns
        the file (the host timeline must then not open it too)."""
        return False

    def stop_core_timeline(self) -> bool:
        return False

    # -- lifecycle ----------------------------------------------------------
    @abc.abstractmethod
    def make_subset(self, ranks: Sequence[int]) -> "Backend": ...

    def shutdown(self, force: bool = False) -> None:
        pass


def _my_rows(full: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    rows = full.shape[0]
    if rows % n != 0:
        raise ValueError(f"reducescatter: leading dim {rows} not divisible "
                         f"by process-set size {n}")
    chunk = rows // n
    return full[rank * chunk:(rank + 1) * chunk]


def _is_integral(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex
                    or dtype == torch.bool)
    return bool(np.issubdtype(np.dtype(dtype), np.integer))


def check_scale_dtype(dtype, factor: float) -> None:
    """Reject a fractional pre/postscale of an integral tensor (the
    reference rejects non-float scaling); shared by every path."""
    if factor != 1.0 and _is_integral(dtype) and float(factor) != int(factor):
        raise ValueError(
            f"prescale/postscale factor {factor} is fractional but the "
            f"tensor dtype is integral ({dtype}); cast to float first "
            "(matches the reference rejecting non-float scaling).")


def _scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    if factor == 1.0:
        return t
    check_scale_dtype(t.dtype, factor)
    return (t * factor).to(t.dtype)


def as_tensor(value) -> torch.Tensor:
    """A torch tensor for ``value`` (numpy arrays and scalars are taken
    as they are, without a copy where possible)."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    a = np.asarray(value)   # ascontiguousarray makes a 0-d array 1-d
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))


class LocalBackend(Backend):
    """Single-contributor group: every collective is the (scaled) identity,
    as the reference behaves with ``size() == 1``."""

    def __init__(self, rank: int = 0, size: int = 1) -> None:
        assert size == 1
        super().__init__(rank, size)

    def allreduce_async(self, name, value, op, prescale=1.0, postscale=1.0):
        return HvdHandle.done(_scale(_scale(as_tensor(value), prescale),
                                     postscale))

    def grouped_allreduce_async(self, names, values, op,
                                prescale=1.0, postscale=1.0):
        return HvdHandle.done([_scale(_scale(as_tensor(v), prescale),
                                      postscale) for v in values])

    def allgather_async(self, name, value):
        return HvdHandle.done(as_tensor(value))

    def broadcast_async(self, name, value, root_rank):
        if root_rank != self.rank:
            raise ValueError(
                f"broadcast root_rank={root_rank} out of range for size 1")
        return HvdHandle.done(as_tensor(value))

    def alltoall_async(self, name, value, splits=None):
        value = as_tensor(value)
        if splits is None:
            recv = torch.tensor([value.shape[0]], dtype=torch.int32)
        else:
            recv = torch.as_tensor(np.asarray(splits), dtype=torch.int32)
            if tuple(recv.shape) != (1,):
                raise ValueError("alltoall splits must have one entry per "
                                 "rank")
        return HvdHandle.done((value, recv))

    def barrier(self) -> None:
        return

    def join(self, device: int = -1) -> int:
        return 0    # the sole contributor is the last joiner

    def make_subset(self, ranks):
        return LocalBackend(0, 1)


def eager_backend_name() -> str:
    """``HVD_TPU_EAGER_BACKEND``: ``core`` (the default) or ``dist``,
    independent of ``HOROVOD_TPU_OPERATIONS`` (which picks the process
    group's NCCL or gloo): two ranks sharing a card run a gloo group and
    the core."""
    from horovod_tpu_torch.common.config import env_str
    name = env_str("EAGER_BACKEND", "core").lower()
    if name not in ("core", "dist"):
        raise ValueError(f"HVD_TPU_EAGER_BACKEND={name!r}: expected core or "
                         "dist")
    return name


def make_backend(state) -> Backend:
    """Priority selection (reference: ``CreateOperationManager``,
    ``operations.cc:144-253``), keyed on the LAUNCHED world size as in
    the JAX package: a process restricted to a one-rank global set by
    ``init(ranks=[r])`` still joins the core's world, so the other
    processes' rendezvous completes."""
    if state.launched_size <= 1:
        return LocalBackend(max(state.rank, 0), 1)
    if eager_backend_name() == "dist":
        from horovod_tpu_torch.ops.dist_backend import DistBackend
        return DistBackend.for_world(state)
    from horovod_tpu_torch.core.bindings import core_backend_or_raise
    return core_backend_or_raise(state)
