"""``horovod_tpu_torch.torch``: the reference's ``horovod.torch`` surface.

Mirrors ``horovod_tpu/torch/__init__.py`` (reference:
``horovod/torch/__init__.py`` + ``mpi_ops.py:143-903`` + ``optimizer.py:
35-590`` + ``functions.py:29-266``), made native: tensors go to the eager
backend as they are and come back on their device, in their dtype (the
core stages a CUDA tensor through pinned host memory; the
``torch.distributed`` plane keeps it on the card under NCCL), with no
numpy round trip. A user of ``import horovod.torch as hvd`` switches the
import and keeps the script::

    import horovod_tpu_torch.torch as hvd
    hvd.init(); torch.cuda.set_device(hvd.local_rank())
    opt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    loss.backward(); opt.step()

Here: the eager collectives with their ``*_async`` handles and in-place
variants, ``sparse_allreduce_async``, the parameter, optimizer-state and
object broadcasts, ``SyncBatchNorm``, the elastic surface, and the
hook-based ``DistributedOptimizer``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional

import torch

# identity and lifecycle (reference: torch/mpi_ops.py:40-90)
from horovod_tpu_torch.common.basics import (  # noqa: F401
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built, gloo_built,
    gloo_enabled, init, is_homogeneous, is_initialized, local_rank,
    local_size, mpi_built, mpi_enabled, mpi_threads_supported, nccl_built,
    rank, rocm_built, shutdown, size, start_timeline, stop_timeline,
    sycl_built)
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, global_process_set, remove_process_set)
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.ops import collectives as _C
from horovod_tpu_torch.ops.backend import HvdHandle
from horovod_tpu_torch.ops.reduce_op import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Sum)


def __getattr__(name):
    if name == "SyncBatchNorm":
        from horovod_tpu_torch.torch.sync_batch_norm import SyncBatchNorm
        return SyncBatchNorm
    raise AttributeError(name)


class _TorchHandle:
    """An eager handle whose ``wait`` may finish the call (write an
    in-place result back, unpack a tuple)."""

    def __init__(self, handle: HvdHandle, post=None) -> None:
        self._h = handle
        self._post = post

    def poll(self) -> bool:
        return self._h.poll()

    def wait(self, timeout: Optional[float] = None):
        out = self._h.wait(timeout)
        return self._post(out) if self._post is not None else out


def _copy_into(tensor):
    def post(out):
        tensor.copy_(out)
        return tensor
    return post


def allreduce_async(tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: ProcessSet = global_process_set):
    return _TorchHandle(_C.allreduce_async(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set))


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set):
    return allreduce_async(tensor, average, name, op, prescale_factor,
                           postscale_factor, process_set).wait()


def allreduce_async_(tensor, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set: ProcessSet = global_process_set):
    """In-place async (reference: ``allreduce_async_``): the handle's
    wait writes the reduction into ``tensor`` and returns it."""
    return _TorchHandle(_C.allreduce_async(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set), _copy_into(tensor))


def allreduce_(tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op: Optional[ReduceOp] = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set: ProcessSet = global_process_set):
    return allreduce_async_(tensor, average, name, op, prescale_factor,
                            postscale_factor, process_set).wait()


def grouped_allreduce_async(tensors, average: Optional[bool] = None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: ProcessSet = global_process_set):
    """One fused negotiation for the group (reference:
    ``grouped_allreduce_async``)."""
    return _TorchHandle(_C.grouped_allreduce_async(
        list(tensors), average, name, op, prescale_factor, postscale_factor,
        process_set))


def grouped_allreduce(tensors, average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: ProcessSet = global_process_set):
    return grouped_allreduce_async(tensors, average, name, op,
                                   prescale_factor, postscale_factor,
                                   process_set).wait()


def grouped_allreduce_async_(tensors, average: Optional[bool] = None,
                             name: Optional[str] = None,
                             op: Optional[ReduceOp] = None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             process_set: ProcessSet = global_process_set):
    """In-place async grouped (reference: ``grouped_allreduce_async_``)."""
    tensors = list(tensors)

    def post(outs):
        for t, o in zip(tensors, outs):
            t.copy_(o)
        return tensors
    return _TorchHandle(_C.grouped_allreduce_async(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set), post)


def grouped_allreduce_(tensors, average: Optional[bool] = None,
                       name: Optional[str] = None,
                       op: Optional[ReduceOp] = None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set: ProcessSet = global_process_set):
    return grouped_allreduce_async_(tensors, average, name, op,
                                    prescale_factor, postscale_factor,
                                    process_set).wait()


def allgather_async(tensor, name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set):
    return _TorchHandle(_C.allgather_async(tensor, name, process_set))


def allgather(tensor, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set):
    return allgather_async(tensor, name, process_set).wait()


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set):
    return _TorchHandle(_C.broadcast_async(tensor, root_rank, name,
                                           process_set))


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set):
    return broadcast_async(tensor, root_rank, name, process_set).wait()


def broadcast_async_(tensor, root_rank: int, name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set):
    """In-place async broadcast (reference: ``broadcast_async_``)."""
    return _TorchHandle(_C.broadcast_async(tensor, root_rank, name,
                                           process_set), _copy_into(tensor))


def broadcast_(tensor, root_rank: int, name: Optional[str] = None,
               process_set: ProcessSet = global_process_set):
    return broadcast_async_(tensor, root_rank, name, process_set).wait()


def alltoall_async(tensor, splits=None, name: Optional[str] = None,
                   process_set: ProcessSet = global_process_set):
    """Async uneven alltoallv (reference: ``alltoall_async``,
    ``torch/mpi_ops.py:765``): wait returns the gathered tensor, and the
    received splits too ONLY when ``splits`` was given (the reference's
    contract, ``torch/mpi_ops.py:817-846``)."""
    def post(out):
        t, recv = out
        return t if splits is None else (t, recv)
    return _TorchHandle(_C.alltoall_async(tensor, splits, name, process_set),
                        post)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set: ProcessSet = global_process_set):
    return alltoall_async(tensor, splits, name, process_set).wait()


def reducescatter(tensor, op: Optional[ReduceOp] = None,
                  name: Optional[str] = None,
                  process_set: ProcessSet = global_process_set):
    return _C.reducescatter(tensor, op, name, process_set)


def sparse_allreduce_async(tensor, name: str, op: ReduceOp = None):
    """Allgather-based allreduce of a sparse COO tensor (reference:
    ``sparse_allreduce_async``, ``torch/mpi_ops.py:515-535``): every rank's
    indices and values are gathered and coalesced, so coordinates that
    meet sum. Returns a zero-argument callable that completes the op (the
    reference's deferred handle, which ``synchronize`` takes)."""
    op = Average if op is None else op
    t = tensor.coalesce() if not tensor.is_coalesced() else tensor
    # dim 0 is the gather axis: indices travel as [nnz, sparse_dim]
    idx_h = allgather_async(t._indices().transpose(0, 1).contiguous(),
                            name=f"{name}.indices")
    val_h = allgather_async(t._values(), name=f"{name}.values")

    def handle():
        values, indices = val_h.wait(), idx_h.wait()
        if op == Average:
            values = values / size()
        if indices.numel() == 0 or values.numel() == 0:
            return torch.sparse_coo_tensor(
                torch.zeros((t.sparse_dim(), 0), dtype=torch.long,
                            device=t.device),
                torch.zeros((0,) + t.shape[t.sparse_dim():], dtype=t.dtype,
                            device=t.device), t.size()).coalesce()
        return torch.sparse_coo_tensor(indices.transpose(0, 1).long(),
                                       values, t.size()).coalesce()

    return handle


def synchronize(handle):
    if callable(handle) and not hasattr(handle, "wait"):
        return handle()   # sparse_allreduce_async's deferred handle
    return handle.wait()


def poll(handle) -> bool:
    return handle.poll()


def join(device: int = -1) -> int:
    return _C.join(device)


def barrier(process_set: ProcessSet = global_process_set) -> None:
    _C.barrier(process_set)


# -- parameter, optimizer-state and object broadcast -------------------------

def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place broadcast of a ``state_dict`` or ``named_parameters``
    (reference: ``broadcast_parameters``, ``functions.py:29-68``): every
    tensor's broadcast (``bp.<name>``) is issued before the first wait."""
    items = list(params.items()) if hasattr(params, "items") else list(params)
    items = [(n, p) for n, p in items if isinstance(p, torch.Tensor)]
    handles = [broadcast_async(p.detach(), root_rank, name=f"bp.{n}")
               for n, p in items]
    with torch.no_grad():
        for (_, p), h in zip(items, handles):
            p.copy_(h.wait())


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Give every rank ``root_rank``'s optimizer state and
    hyperparameters (reference: ``functions.py:116-266``), also where a
    rank has no state yet: the structure and scalars travel pickled, the
    tensors by broadcast (the port's training-API broadcast)."""
    from horovod_tpu_torch.train.optimizer import \
        broadcast_optimizer_state as _bos
    _bos(getattr(optimizer, "_opt", optimizer), root_rank)


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    from horovod_tpu_torch.train.optimizer import broadcast_object as _bo
    return _bo(obj, root_rank, name=name)


def allgather_object(obj, name: Optional[str] = None):
    """Reference: ``allgather_object`` (``torch/functions.py:233-266``)."""
    from horovod_tpu_torch.train.optimizer import allgather_object as _ag
    return _ag(obj, name=name)


# -- DistributedOptimizer (reference: torch/optimizer.py) --------------------

class _DistributedOptimizer:
    """Wraps a torch optimizer: allreduce the gradients before each step
    (reference: ``_DistributedOptimizer``, ``torch/optimizer.py:35-333``).

    Hook mode (the default): a post-accumulate-grad hook on every
    parameter enqueues its ``torchgrad.<name>`` allreduce the moment its
    gradient is final in ``backward()``, so communication overlaps the
    rest of the backward pass, in whatever order each rank's backward
    produces the gradients (the core negotiates that order, and its
    response cache takes over once the order repeats). With
    ``backward_passes_per_step = k`` a parameter's hook counts down and
    enqueues on its k-th pass, prescaled by 1/k. ``synchronize()``
    submits what no hook did, waits on every handle and writes each
    reduced gradient back.

    Fallback (``HVD_TORCH_HOOKS=0``): every gradient is submitted in
    ``synchronize``, under the same names, so the core fuses them."""

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = Average,
                 process_set: ProcessSet = global_process_set) -> None:
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step
        self._synchronized = False
        self._names = ({id(p): n for n, p in named_parameters}
                       if named_parameters is not None else {})
        self._handles: Dict[int, tuple] = {}   # id(p) -> (p, handle, ctx)
        self._delay: Dict[int, int] = {}
        self._hook_handles: List[Any] = []
        if size() > 1:   # the engine starts here, on every rank at once
            from horovod_tpu_torch.common.basics import eager_backend
            eager_backend()
        self._use_hooks = (os.environ.get("HVD_TORCH_HOOKS", "1") != "0"
                           and self._register_hooks())

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _param_name(self, p, i: int, j: int) -> str:
        return self._names.get(id(p), f"grad.{i}.{j}")

    def _register_hooks(self) -> bool:
        for i, group in enumerate(self._opt.param_groups):
            for j, p in enumerate(group["params"]):
                if not p.requires_grad:
                    continue
                self._delay[id(p)] = self.backward_passes_per_step
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(
                        self._make_hook(i, j)))
        return True

    def _make_hook(self, i: int, j: int):
        def hook(p):
            if self._delay[id(p)] <= 0:
                # a k+1-th backward would enqueue the name again while
                # the k-th op may be in flight (reference optimizer.py:
                # 209-213)
                raise ValueError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before call to "
                    "step(). Increase backward_passes_per_step or call "
                    "synchronize() between backward passes.")
            self._delay[id(p)] -= 1
            if self._delay[id(p)] == 0:
                self._enqueue(p, self._param_name(p, i, j))
        return hook

    def _enqueue(self, p, name: str) -> None:
        """Submit ``p``'s gradient, as a private copy: the engine reads it
        while it is in flight, and ``p.grad`` may change meanwhile
        (unscaling, another accumulation)."""
        if size() <= 1:
            return   # synchronize() applies the 1/k locally
        c, ctx = self._compression.compress(p.grad)
        h = _C.allreduce_async(
            c.detach().clone(), name="torchgrad." + name, op=self._op,
            prescale_factor=1.0 / self.backward_passes_per_step,
            process_set=self._process_set)
        self._handles[id(p)] = (p, h, ctx)

    @torch.no_grad()
    def synchronize(self) -> None:
        """Drain the hooks' handles and reduce the gradients no hook
        submitted (reference: ``synchronize``, ``optimizer.py:249-292``)."""
        late = []
        for i, group in enumerate(self._opt.param_groups):
            for j, p in enumerate(group["params"]):
                if p.grad is not None and id(p) not in self._handles:
                    late.append((p, self._param_name(p, i, j)))
        if size() <= 1:
            # the 1/k at every world size: the dynamics do not change
            # between 1 and N processes
            if self.backward_passes_per_step > 1:
                for p, _ in late:
                    p.grad.div_(self.backward_passes_per_step)
        else:
            for p, name in late:
                self._enqueue(p, name)
            for p, h, ctx in list(self._handles.values()):
                p.grad.copy_(self._compression.decompress(h.wait(), ctx))
        self._handles.clear()
        for key in self._delay:
            self._delay[key] = self.backward_passes_per_step
        self._synchronized = True

    def skip_synchronize(self):
        """Marks the gradients as synchronized (reference:
        ``skip_synchronize``, ``torch/optimizer.py:294-312``); ``step()``
        already skips a sync that ran since the last step."""
        @contextlib.contextmanager
        def cm():
            self._synchronized = True
            yield
        return cm()

    def step(self, closure=None):
        """Synchronize (unless done since the last step), then apply."""
        if not self._synchronized:
            self.synchronize()
        self._synchronized = False
        return self._opt.step(closure)

    def zero_grad(self, *args: Any, **kwargs: Any):
        return self._opt.zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average,
                         process_set: ProcessSet = global_process_set):
    """Factory (reference: ``DistributedOptimizer``, ``optimizer.py:506``).
    ``op=Adasum`` reduces each gradient with the core's Adasum."""
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, op, process_set)


# the elastic surface: hvd.elastic.ElasticSampler / TorchState / run
# (reference: horovod/torch/elastic/{sampler,state}.py)
from horovod_tpu_torch.torch import elastic  # noqa: E402,F401
