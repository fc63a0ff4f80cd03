"""The eager data plane over ``torch.distributed``.

The counterpart of ``horovod_tpu/ops/xla_backend.py`` (``XLA_EAGER``, the
reference's NCCL role for the eager path): each collective runs as a
``torch.distributed`` call over the process group, so under NCCL a CUDA
tensor stays on the card, and under gloo a CPU tensor is reduced where it
lies. Selected with ``HVD_TPU_EAGER_BACKEND=dist``.

Async contract (reference: enqueue + ``handle_manager`` callbacks,
``horovod/torch/mpi_ops_v2.cc:89-127``): every ``*_async`` returns at
once with a pending :class:`~horovod_tpu_torch.ops.backend.HvdHandle`; one
dispatch thread runs the submissions in FIFO order and completes the
handles. The FIFO is shared by the global set and every process set, so
a process has one total submission order (the members of overlapping sets
submit the shared sets' ops in one order: the same-order contract, as in
the JAX package).

CUDA tensors: the submitting thread records an event on its current
stream, after the work that produced the tensor; the dispatch thread's
stream waits on it before the collective, and the handle completes once
the collective's result is ready on the card (an event the dispatch
thread synchronizes on). Results are on the input's device, in its dtype.

Fusion (reference: ``nccl_operations.cc:156-214``, fuse, reduce, unfuse):
``grouped_allreduce_async`` concatenates the group per dtype and reduces
each fused buffer with one collective. Allgather takes ragged first dims
(the sizes are gathered first, the rows padded to the largest), alltoall
takes uneven splits (the split table is exchanged first, then one
``all_to_all_single`` with the split sizes). Adasum gathers every rank's
contribution and folds it in the binary tree of
:mod:`horovod_tpu_torch.ops.adasum`, per tensor inside a fused buffer.

Every member issues the same collectives in the same order; the ordering
the core negotiates is not available here, so ``join`` raises.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.backend import (Backend, HvdHandle, _my_rows,
                                           _scale, as_tensor,
                                           check_scale_dtype)
from horovod_tpu_torch.ops.mesh_collectives import (_all_gather,
                                                    _reduce_scatter,
                                                    peer_loss)
from horovod_tpu_torch.ops.reduce_op import ReduceOp

_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.AVERAGE: dist.ReduceOp.SUM,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


class _Dispatcher:
    """FIFO dispatch thread completing pending handles (the reference's
    background loop and finalizer thread, ``gpu_operations.h:100-137``)."""

    def __init__(self) -> None:
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-dist-dispatch")
        self._thread.start()

    def submit(self, fn, values=()) -> HvdHandle:
        h = HvdHandle()
        ready = None
        dev = next((v.device for v in values
                    if isinstance(v, torch.Tensor) and v.is_cuda), None)
        if dev is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        self._q.put((fn, h, dev, ready))
        return h

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, h, dev, ready = item
            try:
                if dev is None:
                    h._set_result(fn())
                    continue
                with torch.cuda.device(dev):
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(ready)
                    out = fn()
                    done = torch.cuda.Event()
                    done.record(stream)
                    done.synchronize()
                h._set_result(out)
            except BaseException as e:  # complete the handle, keep looping
                h._set_error(e)

    def shutdown(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=30)


class _Group:
    """One process group (the global set or a process set): its torch
    group, this process's rank in it, and the world rank of each member."""

    def __init__(self, group, world_ranks: List[int], rank: int) -> None:
        self.group = group
        self.world_ranks = world_ranks
        self.rank = rank
        self.size = len(world_ranks)

    # -- synchronous bodies (run on the dispatch thread) ---------------------
    def allreduce(self, t: torch.Tensor, op: ReduceOp, prescale: float,
                  postscale: float) -> torch.Tensor:
        buf = _scale(t, prescale)
        if op == ReduceOp.ADASUM:
            from horovod_tpu_torch.ops.adasum import adasum_tree_reduce
            out = adasum_tree_reduce(self.gather_stacked(buf))
        else:
            buf = buf.clone() if buf is t else buf.contiguous()
            with peer_loss():
                dist.all_reduce(buf, _TORCH_OPS[op], group=self.group)
            out = _average(buf, self.size) if op == ReduceOp.AVERAGE else buf
        return _scale(out, postscale)

    def grouped_allreduce(self, values: List[torch.Tensor], op: ReduceOp,
                          prescale: float, postscale: float
                          ) -> List[torch.Tensor]:
        for v in values:   # the single path's contract, before any wire
            check_scale_dtype(v.dtype, prescale)
            check_scale_dtype(v.dtype, postscale)
        outs: List[Optional[torch.Tensor]] = [None] * len(values)
        by_dtype: dict = {}
        for i, v in enumerate(values):
            by_dtype.setdefault((v.dtype, v.device), []).append(i)
        for _, idxs in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
            flats = [values[i].reshape(-1) for i in idxs]
            fused = torch.cat(flats) if len(flats) > 1 else flats[0].clone()
            fused = _scale(fused, prescale)
            if op == ReduceOp.ADASUM:
                # one gather for the fused buffer, per-tensor coefficients
                # (the reference computes per-layer dots inside the fused
                # buffer, adasum.h tensor_counts)
                from horovod_tpu_torch.ops.adasum import adasum_tree_reduce
                g = self.gather_stacked(fused)
                parts, off = [], 0
                for f in flats:
                    parts.append(adasum_tree_reduce(g[:, off:off + f.numel()]))
                    off += f.numel()
                fused = torch.cat(parts)
            else:
                with peer_loss():
                    dist.all_reduce(fused, _TORCH_OPS[op], group=self.group)
                if op == ReduceOp.AVERAGE:
                    fused = _average(fused, self.size)
            fused = _scale(fused, postscale)
            off = 0
            for i in idxs:
                n = values[i].numel()
                outs[i] = fused[off:off + n].reshape(values[i].shape)
                off += n
        return outs

    def gather_stacked(self, t: torch.Tensor) -> torch.Tensor:
        """Every member's ``t`` stacked ``[size, *t.shape]``, in set order."""
        flat = t.contiguous().reshape(-1)
        buf = flat.new_empty(self.size * flat.numel())
        with peer_loss():
            _all_gather(buf, flat, group=self.group)
        return buf.reshape((self.size,) + tuple(t.shape))

    def allgather(self, t: torch.Tensor) -> torch.Tensor:
        rows = t.shape[0] if t.dim() else 1
        sizes = self.gather_stacked(torch.tensor(
            [rows], dtype=torch.int64, device=t.device)).reshape(-1).tolist()
        top = max(sizes)
        if t.dim() == 0:
            t = t.reshape(1)
        padded = t.new_zeros((top,) + tuple(t.shape[1:]))
        padded[:rows] = t
        full = self.gather_stacked(padded)
        return torch.cat([full[r, :sizes[r]] for r in range(self.size)])

    def broadcast(self, t: torch.Tensor, root: int) -> torch.Tensor:
        buf = t.clone().contiguous()
        with peer_loss():
            dist.broadcast(buf, src=self.world_ranks[root], group=self.group)
        return buf

    def alltoall(self, t: torch.Tensor, splits):
        if splits is None:
            if t.shape[0] % self.size != 0:
                raise ValueError("alltoall without splits requires dim 0 "
                                 f"divisible by size ({self.size})")
            splits = [t.shape[0] // self.size] * self.size
        splits = [int(s) for s in (splits.tolist() if hasattr(
            splits, "tolist") else splits)]
        if len(splits) != self.size:
            raise ValueError("alltoall splits must have one entry per rank")
        if any(s < 0 for s in splits):
            raise ValueError("alltoall splits must be non-negative")
        if sum(splits) != t.shape[0]:
            raise ValueError(f"alltoall splits sum ({sum(splits)}) must "
                             f"equal dim 0 ({t.shape[0]})")
        send = torch.tensor(splits, dtype=torch.int64, device=t.device)
        recv = torch.empty_like(send)
        with peer_loss():
            dist.all_to_all_single(recv, send, group=self.group)
        recv_splits = recv.tolist()
        out = t.new_empty((sum(recv_splits),) + tuple(t.shape[1:]))
        with peer_loss():
            dist.all_to_all_single(out, t.contiguous(), recv_splits, splits,
                                   group=self.group)
        return out, torch.tensor(recv_splits, dtype=torch.int32)

    def reducescatter(self, t: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN,
                      ReduceOp.MAX):
            return _my_rows(self.allreduce(t, op, 1.0, 1.0), self.rank,
                            self.size)
        if t.shape[0] % self.size != 0:
            raise ValueError(f"reducescatter: leading dim {t.shape[0]} not "
                             f"divisible by process-set size {self.size}")
        out = t.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
        with peer_loss():
            _reduce_scatter(out, t.contiguous(), _TORCH_OPS[op],
                            group=self.group)
        return _average(out, self.size) if op == ReduceOp.AVERAGE else out


def _average(t: torch.Tensor, n: int) -> torch.Tensor:
    return t / n if t.is_floating_point() else torch.div(
        t, n, rounding_mode="trunc")


class DistBackend(Backend):
    """Eager collectives of one process group over ``torch.distributed``.
    Subsets (:meth:`make_subset`) share the dispatch thread."""

    def __init__(self, group=None, world_ranks: Optional[Sequence[int]] = None,
                 dispatcher: Optional[_Dispatcher] = None) -> None:
        group = group if group is not None else dist.group.WORLD
        world_ranks = list(world_ranks if world_ranks is not None
                           else range(dist.get_world_size(group)))
        me = dist.get_rank()
        rank = world_ranks.index(me) if me in world_ranks else -1
        super().__init__(rank, len(world_ranks))
        self._ranks: Optional[List[int]] = None   # a process set's members
        self._owns = dispatcher is None
        self._disp = dispatcher or _Dispatcher()
        self._world_ranks = world_ranks
        self.group = group      # torch's non-member marker off the set
        self._g = _Group(group, world_ranks, rank) if rank >= 0 else None

    @classmethod
    def for_world(cls, state) -> "DistBackend":
        """The global set's backend: the world group, or the group ``init``
        made over its ``ranks=`` restriction."""
        from horovod_tpu_torch.common.process_sets import global_process_set
        return cls(global_process_set.group, state.world_ranks)

    def _member(self) -> _Group:
        if self._g is None:
            raise RuntimeError(
                f"process {dist.get_rank()} is not a member of process set "
                f"{self._ranks} and cannot submit collectives to it")
        return self._g

    def _submit(self, fn, values) -> HvdHandle:
        return self._disp.submit(fn, values)

    def allreduce_async(self, name, value, op, prescale=1.0, postscale=1.0):
        g, t = self._member(), as_tensor(value)
        return self._submit(lambda: g.allreduce(t, op, prescale, postscale),
                            [t])

    def grouped_allreduce_async(self, names, values, op,
                                prescale=1.0, postscale=1.0):
        g, ts = self._member(), [as_tensor(v) for v in values]
        return self._submit(lambda: g.grouped_allreduce(ts, op, prescale,
                                                        postscale), ts)

    def allgather_async(self, name, value):
        g, t = self._member(), as_tensor(value)
        return self._submit(lambda: g.allgather(t), [t])

    def broadcast_async(self, name, value, root_rank):
        """``root_rank`` is the GLOBAL rank, also under a process set."""
        g, t = self._member(), as_tensor(value)
        ranks = self._ranks
        root = int(root_rank)
        if ranks is not None:
            if root not in ranks:
                raise ValueError(f"broadcast root_rank={root_rank} is not a "
                                 f"member of process set {ranks}")
            root = ranks.index(root)
        elif not 0 <= root < g.size:
            raise ValueError(f"broadcast root_rank={root_rank} out of range "
                             f"for size {g.size}")
        return self._submit(lambda: g.broadcast(t, root), [t])

    def alltoall_async(self, name, value, splits=None):
        g, t = self._member(), as_tensor(value)
        return self._submit(lambda: g.alltoall(t, splits), [t])

    def reducescatter_async(self, name, value, op):
        g, t = self._member(), as_tensor(value)
        return self._submit(lambda: g.reducescatter(t, op), [t])

    def barrier(self) -> None:
        g = self._member()
        z = torch.zeros(1, device="cpu" if dist.get_backend(g.group) != "nccl"
                        else torch.cuda.current_device())
        self._submit(lambda: g.allreduce(z, ReduceOp.SUM, 1.0, 1.0),
                     [z]).wait()

    def join(self, device: int = -1) -> int:
        raise NotImplementedError(
            "join() needs the dynamic negotiation of the core (ranks submit "
            "different collective sequences by definition), which the "
            "same-order torch.distributed plane cannot provide; use the "
            "core (HVD_TPU_EAGER_BACKEND=core, the default) or pad batches "
            "so every rank runs the same steps")

    def make_subset(self, ranks: Sequence[int]) -> "DistBackend":
        """A process set's backend: a ``dist.new_group`` over its members
        (every process of the world makes it, in one order), sharing this
        backend's dispatch thread."""
        ranks = sorted(set(int(r) for r in ranks))
        if any(not 0 <= r < self.size for r in ranks):
            raise ValueError(f"process-set ranks {ranks} out of range for "
                             f"world size {self.size}")
        world = [self._world_ranks[r] for r in ranks]
        sub = DistBackend(dist.new_group(world), world, self._disp)
        sub._ranks = ranks
        return sub

    def shutdown(self, force: bool = False) -> None:
        if self._owns:
            self._disp.shutdown()

