"""ctypes backend over the port's ``libhvdcore``: the multi-process eager
path.

Mirrors ``horovod_tpu/core/core_backend.py`` (reference:
``horovod/common/basics.py`` ctypes identity + ``horovod/torch/
mpi_ops_v2.cc`` enqueue and handle manager): the same entry points,
argument types and dtype codes (``cpp/types.h``; bf16 is 10), the
in-flight buffer pinning, ``CoreHandle``, process-set domains
(:meth:`CoreBackend.make_subset`), the engine's counters, straggler
report and pending-tensor state, its timeline, and ``shutdown(force)``.

The core moves host buffers. A CPU tensor is handed over as it is
(contiguous; the core reads it while the handle is in flight, as the JAX
package hands over its numpy arrays). A CUDA tensor is copied into pinned
host memory on the caller's current stream, after the work that produced
it, and the copy is complete before the tensor is enqueued; at ``wait``
the result is copied back onto the input's device in the input's dtype.
The seconds those copies take add up in :attr:`CoreBackend.staging_s`.
"""

from __future__ import annotations

import ctypes
import json
import threading
import time
from typing import Optional, Sequence

import torch

from horovod_tpu_torch.ops.backend import Backend, HvdHandle, as_tensor

_LIB = None
_LIB_LOCK = threading.Lock()

# DataType codes of cpp/types.h
DTYPE_CODES = {
    torch.uint8: 0, torch.int8: 1, torch.int32: 4, torch.int64: 5,
    torch.float16: 6, torch.float32: 7, torch.float64: 8, torch.bool: 9,
    torch.bfloat16: 10,
}


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from horovod_tpu_torch.core import library_path
        lib = ctypes.CDLL(library_path())
        c_int, c_p, c_d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
        c_s, i64p = ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)
        lib.hvd_init.restype = c_int
        lib.hvd_last_error.restype = c_s
        lib.hvd_cfg_dump.restype = c_s
        lib.hvd_rank.restype = c_int
        lib.hvd_size.restype = c_int
        lib.hvd_enqueue_allreduce.restype = c_int
        lib.hvd_enqueue_allreduce.argtypes = [
            c_s, c_p, c_p, c_int, c_int, i64p, c_int, c_d, c_d, c_int]
        lib.hvd_enqueue_grouped_allreduce.restype = c_int
        lib.hvd_enqueue_grouped_allreduce.argtypes = [
            c_s, c_p, c_p, c_int, c_int, i64p, c_int, c_d, c_d, c_int, c_int,
            c_int]
        lib.hvd_enqueue_allgather.restype = c_int
        lib.hvd_enqueue_allgather.argtypes = [c_s, c_p, c_int, c_int, i64p,
                                              c_int]
        lib.hvd_enqueue_broadcast.restype = c_int
        lib.hvd_enqueue_broadcast.argtypes = [c_s, c_p, c_p, c_int, c_int,
                                              c_int, i64p, c_int]
        lib.hvd_enqueue_alltoall.restype = c_int
        lib.hvd_enqueue_alltoall.argtypes = [c_s, c_p, i64p, c_int, c_int,
                                             c_int, i64p, c_int]
        lib.hvd_enqueue_join.restype = c_int
        lib.hvd_barrier.restype = c_int
        lib.hvd_poll.restype = c_int
        lib.hvd_wait.restype = c_int
        lib.hvd_wait.argtypes = [c_int, c_d]
        lib.hvd_result_ndim.restype = c_int
        lib.hvd_result_shape.restype = c_int
        lib.hvd_result_shape.argtypes = [c_int, i64p, c_int]
        lib.hvd_recv_splits.restype = c_int
        lib.hvd_recv_splits.argtypes = [c_int, i64p, c_int]
        lib.hvd_copy_result.restype = c_int
        lib.hvd_copy_result.argtypes = [c_int, c_p, ctypes.c_int64]
        lib.hvd_add_process_set.restype = c_int
        lib.hvd_last_join_rank.restype = c_int
        lib.hvd_counters_json.restype = c_s
        lib.hvd_stragglers_json.restype = c_s
        lib.hvd_engine_state_json.restype = c_s
        lib.hvd_timeline_enabled.restype = c_int
        lib.hvd_timeline_mark.restype = None
        lib.hvd_timeline_mark.argtypes = [c_s, c_s]
        lib.hvd_start_timeline.restype = c_int
        lib.hvd_start_timeline.argtypes = [c_s, c_int]
        lib.hvd_stop_timeline.restype = c_int
        _LIB = lib
        return lib


def dtype_code(dtype: torch.dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"unsupported dtype for core collectives: {dtype}")
    return code


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _shape_arg(shape):
    arr = (ctypes.c_int64 * max(len(shape), 1))(*shape)
    return arr, len(shape)


# Buffers referenced by in-flight C++ entries, keyed by the C handle and
# released on completion; a handle abandoned without wait() leaks its
# buffers here rather than letting the engine write freed memory (the
# reference keeps tensors alive in its tensor table the same way).
_INFLIGHT_BUFFERS = {}
_INFLIGHT_LOCK = threading.Lock()


def _pin_buffers(ch: int, bufs) -> None:
    with _INFLIGHT_LOCK:
        _INFLIGHT_BUFFERS[ch] = bufs


def _unpin_buffers(ch: int) -> None:
    with _INFLIGHT_LOCK:
        _INFLIGHT_BUFFERS.pop(ch, None)


class CoreHandle(HvdHandle):
    """Handle backed by the C++ handle manager (polls the core instead of
    a Python event)."""

    def __init__(self, lib, ch: int, finisher):
        super().__init__()
        self._lib = lib
        self._ch = ch
        self._finisher = finisher
        self._finished = False
        self._flock = threading.Lock()

    def poll(self) -> bool:
        if self._finished:
            return True
        return bool(self._lib.hvd_poll(self._ch))

    def wait(self, timeout: Optional[float] = None):
        with self._flock:
            if self._finished:
                return super().wait(0)
            t = 1e9 if timeout is None else float(timeout)
            rc = self._lib.hvd_wait(self._ch, t)
            if rc == -2:
                # timed out: the handle and its buffers stay valid
                raise TimeoutError("collective did not complete in time")
            if rc != 0:
                err = self._lib.hvd_last_error().decode()
                # HorovodInternalError (a RuntimeError): elastic.run's
                # restore-and-retry path triggers on a peer's failure
                from horovod_tpu_torch.elastic import HorovodInternalError
                self._set_error(
                    HorovodInternalError(f"collective failed: {err}"))
            else:
                try:
                    self._set_result(self._finisher())
                except BaseException as e:
                    self._set_error(e)
            self._lib.hvd_free_handle(self._ch)
            _unpin_buffers(self._ch)
            self._finished = True
        return super().wait(0)


class CoreBackend(Backend):
    """Backend over the native core for one coordination domain (0 is the
    core's whole world)."""

    def __init__(self, world_ranks: Optional[Sequence[int]] = None,
                 domain: int = 0, rank: int = None, size: int = None,
                 lib=None, parent: "CoreBackend" = None):
        self._lib = lib or _load_lib()
        self._group_counter = 0
        self._group_lock = threading.Lock()
        self._staging = [0.0] if parent is None else parent._staging
        if domain == 0:
            # chaos harness (horovod_tpu/core/core_backend.py:214): a raw
            # core worker (no init) still honours HVD_TPU_FAULT_PLAN; the
            # transport spec must be in the environment before the core
            # reads it at Transport::Init (cpp/transport.cc:27)
            from horovod_tpu_torch import chaos
            chaos.install()
            rc = self._lib.hvd_init()
            if rc != 0:
                raise RuntimeError("hvdcore init failed: " +
                                   self._lib.hvd_last_error().decode())
            rank, size = self._lib.hvd_rank(), self._lib.hvd_size()
            self._owns_core = True
            # init(ranks=...): the global set is a subset of the launched
            # world (reference: init_multi_comm, operations.cc:881-965);
            # the core spans the launched world and the restricted global
            # set is a process-set domain
            if world_ranks is not None and \
                    list(world_ranks) != list(range(size)):
                super().__init__(rank, size)
                self._domain = 0
                sub = self.make_subset(world_ranks)
                self._domain, self._ranks = sub._domain, sub._ranks
                rank, size = sub.rank, sub.size
        else:
            self._owns_core = False
        super().__init__(rank, size)
        if domain != 0 or not hasattr(self, "_domain"):
            self._domain = domain

    @property
    def staging_s(self) -> float:
        """Seconds spent copying CUDA tensors to the host and back."""
        return self._staging[0]

    # -- host staging --------------------------------------------------------
    def _to_host(self, value):
        """``(host tensor, back)``: the contiguous host buffer the core
        reads, and the function that puts a host result where the input
        lives."""
        t = as_tensor(value)
        if not t.is_cuda:
            return t.contiguous(), lambda a: a
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)     # on the current stream, after its producer
        self._staging[0] += time.perf_counter() - t0
        dev = t.device

        def back(a: torch.Tensor) -> torch.Tensor:
            t1 = time.perf_counter()
            out = a.to(dev)
            self._staging[0] += time.perf_counter() - t1
            return out
        return host, back

    @staticmethod
    def _host_out(host: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(host, pin_memory=host.is_pinned())

    # -- collectives ---------------------------------------------------------
    def allreduce_async(self, name, value, op, prescale=1.0, postscale=1.0,
                        group_id=-1, group_size=0):
        arr, back = self._to_host(value)
        out = self._host_out(arr)
        sh, nd = _shape_arg(arr.shape)
        if group_id >= 0:
            ch = self._lib.hvd_enqueue_grouped_allreduce(
                name.encode(), _ptr(arr), _ptr(out), dtype_code(arr.dtype),
                nd, sh, int(op), float(prescale), float(postscale),
                self._domain, int(group_id), int(group_size))
        else:
            ch = self._lib.hvd_enqueue_allreduce(
                name.encode(), _ptr(arr), _ptr(out), dtype_code(arr.dtype),
                nd, sh, int(op), float(prescale), float(postscale),
                self._domain)
        _pin_buffers(ch, (arr, out))
        return CoreHandle(self._lib, ch, lambda: back(out))

    def grouped_allreduce_async(self, names, values, op,
                                prescale=1.0, postscale=1.0):
        # a registered group (reference: GroupTable): the coordinator
        # holds the whole group back until every member is ready; the id
        # counter is per coordination domain, and every member of a domain
        # makes its grouped calls in one order
        with self._group_lock:
            self._group_counter += 1
            gid = self._group_counter
        handles = [self.allreduce_async(n, v, op, prescale, postscale,
                                        group_id=gid, group_size=len(values))
                   for n, v in zip(names, values)]
        agg = HvdHandle()

        def waiter():
            try:
                agg._set_result([h.wait() for h in handles])
            except BaseException as e:
                agg._set_error(e)

        threading.Thread(target=waiter, daemon=True).start()
        return agg

    def _gathered_result(self, ch: int, dtype: torch.dtype, pinned: bool
                         ) -> torch.Tensor:
        ndim = self._lib.hvd_result_ndim(ch)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        self._lib.hvd_result_shape(ch, shape, ndim)
        out = torch.empty(tuple(shape[i] for i in range(ndim)), dtype=dtype,
                          pin_memory=pinned)
        nbytes = out.numel() * out.element_size()
        rc = self._lib.hvd_copy_result(ch, _ptr(out), nbytes)
        if rc != 0:
            raise RuntimeError("copy_result failed: " +
                               self._lib.hvd_last_error().decode())
        return out

    def allgather_async(self, name, value):
        arr, back = self._to_host(value)
        sh, nd = _shape_arg(arr.shape)
        ch = self._lib.hvd_enqueue_allgather(
            name.encode(), _ptr(arr), dtype_code(arr.dtype), nd, sh,
            self._domain)
        _pin_buffers(ch, (arr,))
        return CoreHandle(self._lib, ch, lambda: back(self._gathered_result(
            ch, arr.dtype, arr.is_pinned())))

    def broadcast_async(self, name, value, root_rank):
        arr, back = self._to_host(value)
        out = arr.clone()
        sh, nd = _shape_arg(arr.shape)
        # root_rank is the GLOBAL rank at the API boundary (reference:
        # operations.cc:1560-1592); the core takes it as it is
        ranks = getattr(self, "_ranks", None)
        root = int(root_rank)
        if ranks is not None and root not in ranks:
            raise ValueError(f"broadcast root_rank={root_rank} is not a "
                             f"member of process set {ranks}")
        ch = self._lib.hvd_enqueue_broadcast(
            name.encode(), _ptr(arr), _ptr(out), root, dtype_code(arr.dtype),
            nd, sh, self._domain)
        _pin_buffers(ch, (arr, out))
        return CoreHandle(self._lib, ch, lambda: back(out))

    def alltoall_async(self, name, value, splits=None):
        arr, back = self._to_host(value)
        if splits is None:
            if arr.shape[0] % self.size != 0:
                raise ValueError("alltoall without splits requires dim 0 "
                                 f"divisible by size ({self.size})")
            splits = [arr.shape[0] // self.size] * self.size
        splits = [int(s) for s in (splits.tolist() if hasattr(
            splits, "tolist") else splits)]
        if len(splits) != self.size:
            raise ValueError("alltoall splits must have one entry per rank")
        sp = (ctypes.c_int64 * len(splits))(*splits)
        sh, nd = _shape_arg(arr.shape)
        ch = self._lib.hvd_enqueue_alltoall(
            name.encode(), _ptr(arr), sp, len(splits), dtype_code(arr.dtype),
            nd, sh, self._domain)

        def finish():
            out = self._gathered_result(ch, arr.dtype, arr.is_pinned())
            rs = (ctypes.c_int64 * self.size)()
            nrs = self._lib.hvd_recv_splits(ch, rs, self.size)
            recv = torch.tensor([rs[i] for i in range(nrs)],
                                dtype=torch.int32)
            return back(out), recv

        _pin_buffers(ch, (arr,))
        return CoreHandle(self._lib, ch, finish)

    def barrier(self):
        if self._lib.hvd_barrier(self._domain) != 0:
            raise RuntimeError("barrier failed: " +
                               self._lib.hvd_last_error().decode())

    def join(self, device: int = -1) -> int:
        ch = self._lib.hvd_enqueue_join(self._domain)
        CoreHandle(self._lib, ch, lambda: None).wait()
        return self._lib.hvd_last_join_rank(self._domain)

    # -- observability -------------------------------------------------------
    def counters(self) -> dict:
        """Engine control-plane counters (``hvd_counters_json``): cycles,
        cache hits/misses/evictions, responses executed, fusion, bytes."""
        return json.loads(self._lib.hvd_counters_json().decode())

    def stragglers(self) -> dict:
        """The coordinator's rank-attributed negotiation-wait report
        (``hvd_stragglers_json``); empty ``ranks`` away from rank 0."""
        return json.loads(self._lib.hvd_stragglers_json().decode())

    def engine_state(self) -> dict:
        """Pending tensors per coordination domain with their ready and
        missing ranks, queue depth and join state
        (``hvd_engine_state_json``, published at <= 2 Hz; empty away from
        the coordinator)."""
        return json.loads(self._lib.hvd_engine_state_json().decode())

    def core_timeline_enabled(self) -> bool:
        return bool(self._lib.hvd_timeline_enabled())

    def timeline_mark(self, name: str, span: str) -> None:
        """Stamp an eager enqueue with its span id into the engine's
        timeline."""
        self._lib.hvd_timeline_mark(name.encode(), span.encode())

    def start_core_timeline(self, file_path: str,
                            mark_cycles: bool = False) -> bool:
        """Start the engine's chrome-tracing timeline (the coordinator
        writes it; reference operations.cc:1011-1041)."""
        if self._lib.hvd_start_timeline(file_path.encode(),
                                        1 if mark_cycles else 0) != 0:
            raise RuntimeError("start_timeline failed: " +
                               self._lib.hvd_last_error().decode())
        return True

    def stop_core_timeline(self) -> bool:
        if self._lib.hvd_stop_timeline() != 0:
            raise RuntimeError("stop_timeline failed: " +
                               self._lib.hvd_last_error().decode())
        return True

    # -- lifecycle -----------------------------------------------------------
    def make_subset(self, ranks: Sequence[int]) -> "CoreBackend":
        ranks = sorted(set(int(r) for r in ranks))
        arr = (ctypes.c_int * len(ranks))(*ranks)
        domain = self._lib.hvd_add_process_set(arr, len(ranks))
        me = self._lib.hvd_rank()
        be = CoreBackend(domain=domain,
                         rank=ranks.index(me) if me in ranks else -1,
                         size=len(ranks), lib=self._lib, parent=self)
        be._ranks = ranks
        return be

    def shutdown(self, force: bool = False):
        if self._owns_core:
            if force:
                # no consensus grace: the caller knows a peer is dead
                self._lib.hvd_shutdown_force()
            else:
                self._lib.hvd_shutdown()
        elif self._domain != 0:
            self._lib.hvd_remove_process_set(self._domain)

