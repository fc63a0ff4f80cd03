"""``horovod_tpu_torch.tensorflow``: the reference's ``horovod.tensorflow``
surface over the port's eager collectives.

Mirrors ``horovod_tpu/tensorflow/__init__.py`` (reference:
``horovod/tensorflow/__init__.py``: ``hvd.allreduce`` :55-162,
``broadcast_variables``/``broadcast_global_variables`` :284,
``DistributedOptimizer`` :627, ``DistributedGradientTape`` :777, and
``horovod/tensorflow/mpi_ops.py``). The port's compute path is torch, so
TensorFlow runs on the host here, as it does beside the JAX package: this
shim carries a TF input or metrics pipeline's distribution layer while
its models migrate.

Each TF tensor becomes a CPU torch tensor (:func:`_to_torch`; bfloat16 by
a bitcast through 16-bit integers, since ``torch.from_numpy`` refuses TF's
bfloat16 arrays) and goes to :mod:`horovod_tpu_torch.ops.collectives`,
which hands it to the eager plane of its process set: the core by default,
or the ``torch.distributed`` plane (``HVD_TPU_EAGER_BACKEND=dist``) under
gloo. The shim chooses no device and falls back to nothing: under the
NCCL ``dist`` plane, which takes CUDA tensors only, its host tensors are
refused. The result comes back as a TF tensor of the input's dtype
(:func:`_from_torch`). Compression is the port's ``Compression`` on the
torch tensors; a quantizer (``Compression.int8``) goes through the
quantized grouped allreduce, whose codec runs its plain version on host
tensors.

Inside a ``tf.function`` the collectives run in ``tf.py_function`` at
graph execution time, on TF's executor threads: the world size and the
process set resolve when the graph runs, so an elastic resize after
tracing takes effect without a retrace. TensorFlow is imported at the
first call that needs it, never at import.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np
import torch

# identity and lifecycle (reference: tensorflow/mpi_ops.py)
from horovod_tpu_torch.common.basics import (  # noqa: F401
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built, gloo_built,
    gloo_enabled, init, is_homogeneous, is_initialized, local_rank,
    local_size, mpi_built, mpi_enabled, mpi_threads_supported, nccl_built,
    rank, rocm_built, shutdown, size, start_timeline, stop_timeline,
    sycl_built)
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, global_process_set, remove_process_set)
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.compression.quantizers import Quantizer
from horovod_tpu_torch.ops import collectives as _C
from horovod_tpu_torch.ops.backend import as_tensor
from horovod_tpu_torch.ops.reduce_op import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Sum)


def _tf():
    import tensorflow as tf
    return tf


def _to_torch(tensor) -> torch.Tensor:
    """A CPU torch tensor with ``tensor``'s values and dtype (a TF tensor
    or variable, a numpy array, a Python value)."""
    if hasattr(tensor, "numpy") and not isinstance(tensor, torch.Tensor):
        tf = _tf()
        t = tf.convert_to_tensor(tensor)
        if t.dtype == tf.bfloat16:
            return as_tensor(tf.bitcast(t, tf.int16).numpy()).view(
                torch.bfloat16)
        return as_tensor(t.numpy())
    arr = np.asarray(tensor)
    if arr.dtype.name == "bfloat16":
        return as_tensor(arr.view(np.int16)).view(torch.bfloat16)
    return as_tensor(arr)


def _from_torch(t: torch.Tensor, like):
    """A TF tensor of ``like``'s dtype holding ``t``'s values."""
    tf = _tf()
    if t.dtype == torch.bfloat16:
        bits = tf.constant(t.contiguous().view(torch.int16).numpy())
        return tf.cast(tf.bitcast(bits, tf.bfloat16), like.dtype)
    return tf.constant(t.numpy(), dtype=like.dtype)


def _sparse_reduce(tf, g, op, name, process_set):
    """Allgather-based reduce of ONE IndexedSlices gradient, keeping it
    sparse end to end (reference: ``sparse_allreduce_async``,
    ``torch/mpi_ops.py:515-535``): every rank's indices and values
    concatenate; duplicate coordinates sum in the optimizer's sparse
    apply, so dividing the values by the set's size gives the
    elementwise average."""

    def do(values, indices):
        if size() <= 1:
            return [values, indices]
        vh = _C.allgather_async(_to_torch(values), name=f"{name}.v",
                                process_set=process_set)
        ih = _C.allgather_async(_to_torch(indices), name=f"{name}.i",
                                process_set=process_set)
        v, i = vh.wait(), ih.wait()
        if op == Average:
            v = v / process_set.size()
        return [_from_torch(v, values), _from_torch(i, indices)]

    if tf.executing_eagerly():
        v, i = do(g.values, g.indices)
        return tf.IndexedSlices(v, i, g.dense_shape)
    v, i = tf.py_function(do, [g.values, g.indices],
                          [g.values.dtype, g.indices.dtype])
    v.set_shape(tf.TensorShape([None]).concatenate(g.values.shape[1:]))
    i.set_shape([None])
    return tf.IndexedSlices(v, i, g.dense_shape)


def _reduce_dense(gs, compression, op, name, process_set) -> list:
    """compress, grouped allreduce, decompress over torch tensors; a
    quantizer goes through the quantized grouped allreduce instead."""
    if isinstance(compression, Quantizer):
        return _C.quantized_grouped_allreduce(gs, compression, op=op,
                                              name=name,
                                              process_set=process_set)
    comp, ctxs = [], []
    for g in gs:
        c, ctx = compression.compress(g)
        comp.append(c)
        ctxs.append(ctx)
    outs = _C.grouped_allreduce(comp, op=op, name=name,
                                process_set=process_set)
    return [compression.decompress(o, ctx) for o, ctx in zip(outs, ctxs)]


def _host_grouped_allreduce(grads, compression, op, prefix, process_set,
                            var_names=None):
    """Shared eager/graph gradient-allreduce body for the tape and the
    optimizer: compress → grouped allreduce → decompress over the non-None
    dense entries; IndexedSlices entries stay sparse via the allgather
    path (:func:`_sparse_reduce`). Inside a tf.function the work rides
    py_functions, so the world size and the collectives resolve at graph
    EXECUTION time.

    Collective names derive from the variable names (when the caller knows
    them: the reference names every allreduce after its variable) plus the
    gradients' positions, shapes and dtypes: stable across steps and
    across re-wrapped tapes, distinct for distinct models. In graph mode a
    trace-time graph-unique suffix also separates two structurally
    identical calls in ONE traced step (WGAN-GP-style double gradients
    over the same variables): their py_function ops are unordered, so a
    shared name could cross-match across ranks; trace order is the same on
    every rank, so the suffix agrees. Eager calls run in program order and
    need no suffix."""
    present = [i for i, g in enumerate(grads) if g is not None]
    if not present:
        return grads
    tf = _tf()
    if tf.executing_eagerly() and size() <= 1:
        return grads
    struct = ",".join(
        f"{i}:{var_names[i] if var_names else ''}:"
        f"{grads[i].shape}:{grads[i].dtype.name}" for i in present)
    name = f"{prefix}.{zlib.crc32(struct.encode()):08x}"
    if not tf.executing_eagerly():
        # the FULL scoped path: the scope is part of what makes
        # unique_name unique ('gen/tfgrad' vs 'disc/tfgrad')
        uid = tf.compat.v1.get_default_graph().unique_name(
            prefix).replace("/", ".")
        name = f"{name}.{uid}"

    result = list(grads)
    sparse = [i for i in present
              if isinstance(grads[i], tf.IndexedSlices)]
    for i in sparse:
        result[i] = _sparse_reduce(tf, grads[i], op, f"{name}.s{i}",
                                   process_set)
    dense = [i for i in present if i not in sparse]
    if not dense:
        return result

    def do(*gs):
        if size() <= 1:
            return list(gs)
        outs = _reduce_dense([_to_torch(g) for g in gs], compression, op,
                             name, process_set)
        return [_from_torch(o, g) for o, g in zip(outs, gs)]

    if tf.executing_eagerly():
        for i, o in zip(dense, do(*[grads[i] for i in dense])):
            result[i] = o
        return result
    flat = tf.py_function(do, [grads[i] for i in dense],
                          [grads[i].dtype for i in dense])
    if not isinstance(flat, (list, tuple)):
        flat = [flat]
    for i, o in zip(dense, flat):
        o.set_shape(grads[i].shape)
        result[i] = o
    return result


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set):
    """Reference: ``hvd.allreduce`` (``tensorflow/__init__.py:55-162``)."""
    out = _C.allreduce(_to_torch(tensor), average, name, op, prescale_factor,
                       postscale_factor, process_set)
    return _from_torch(out, tensor)


def grouped_allreduce(tensors, average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      process_set: ProcessSet = global_process_set):
    outs = _C.grouped_allreduce([_to_torch(t) for t in tensors], average,
                                name, op, process_set=process_set)
    return [_from_torch(o, t) for o, t in zip(outs, tensors)]


def allgather(tensor, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set):
    return _from_torch(_C.allgather(_to_torch(tensor), name, process_set),
                       tensor)


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set):
    return _from_torch(_C.broadcast(_to_torch(tensor), root_rank, name,
                                    process_set), tensor)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set: ProcessSet = global_process_set):
    """The received splits are returned ONLY when ``splits`` was given
    (the reference's return contract, ``tensorflow/mpi_ops.py``
    alltoall)."""
    t, recv_splits = _C.alltoall(
        _to_torch(tensor),
        None if splits is None else _to_torch(splits).numpy(), name,
        process_set)
    gathered = _from_torch(t, tensor)
    if splits is None:
        return gathered
    return gathered, _tf().constant(np.asarray(recv_splits))


def join(device: int = -1) -> int:
    return _C.join(device)


def barrier(process_set: ProcessSet = global_process_set) -> None:
    _C.barrier(process_set)


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    from horovod_tpu_torch.train.optimizer import broadcast_object as _bo
    return _bo(obj, root_rank, name=name)


def allgather_object(obj, name: Optional[str] = None):
    """Reference: ``allgather_object`` (``torch/functions.py:233-266``)."""
    from horovod_tpu_torch.train.optimizer import allgather_object as _ag
    return _ag(obj, name=name)


def broadcast_object_fn(root_rank: int = 0, session=None,
                        name: Optional[str] = None):
    """Reference: ``broadcast_object_fn`` (``tensorflow/functions.py:103``):
    there a TF1 graph of placeholders bound to a session; eager TF2 needs
    no prebuilt graph, so this returns a closure over broadcast_object with
    the same call shape (``session`` accepted for signature parity)."""
    del session
    return lambda obj: broadcast_object(obj, root_rank, name=name)


# -- variable broadcast (reference: broadcast_variables /
# broadcast_global_variables, tensorflow/__init__.py:270-300) ---------------

def broadcast_variables(variables, root_rank: int = 0) -> None:
    """In-place broadcast of tf.Variables from root."""
    handles = [(v, _C.broadcast_async(_to_torch(v), root_rank,
                                      name=f"bv.{i}"))
               for i, v in enumerate(variables)]
    for v, h in handles:
        v.assign(_from_torch(h.wait(), v))


def broadcast_global_variables(root_rank: int = 0) -> None:
    """TF1-style global-variables broadcast (reference:
    ``broadcast_global_variables``); in TF2 prefer
    :func:`broadcast_variables` on ``model.variables``."""
    tf = _tf()
    if hasattr(tf.compat.v1, "global_variables"):
        broadcast_variables(tf.compat.v1.global_variables(), root_rank)


# -- graph-mode identity ops (reference: tensorflow/mpi_ops.py:361-440) -----
# Each resolves its value at graph EXECUTION time (py_function), so a
# tf.function traced in one world reports the world it executes in.

PROCESS_SET_ERROR_INIT = -1
PROCESS_SET_ERROR_UNKNOWN_SET = -2


def _exec_time_int(fn, name):
    tf = _tf()
    return tf.py_function(lambda: fn(), [], tf.int32, name=name)


def _identity_or_sentinel(fn):
    """-1 before ``init()``, the reference C API's contract for
    ``horovod_size()``/``horovod_rank()`` (so probing graphs don't
    error)."""

    def val():
        if not is_initialized():
            return -1
        return fn()
    return val


def size_op(process_set_id: int = 0, name: Optional[str] = None):
    """Execution-time world (or process-set) size."""
    from horovod_tpu_torch.common import process_sets

    def val():
        if process_set_id:
            return process_sets.get_process_set_by_id(process_set_id).size()
        return size()
    return _exec_time_int(_identity_or_sentinel(val), name or "HorovodSize")


def local_size_op(name: Optional[str] = None):
    return _exec_time_int(_identity_or_sentinel(local_size),
                          name or "HorovodLocalSize")


def rank_op(name: Optional[str] = None):
    return _exec_time_int(_identity_or_sentinel(rank), name or "HorovodRank")


def local_rank_op(name: Optional[str] = None):
    return _exec_time_int(_identity_or_sentinel(local_rank),
                          name or "HorovodLocalRank")


def process_set_included_op(process_set_id: int = 0,
                            name: Optional[str] = None):
    """1/0 whether this process is in the set; the negative error codes
    are the reference's (init / unknown set)."""
    from horovod_tpu_torch.common import process_sets

    def val():
        if not is_initialized():
            return PROCESS_SET_ERROR_INIT
        try:
            ps = process_sets.get_process_set_by_id(process_set_id)
        except (KeyError, ValueError):
            return PROCESS_SET_ERROR_UNKNOWN_SET
        return 1 if ps.included() else 0
    return _exec_time_int(val, name or "HorovodProcessSetIncluded")


# -- DistributedGradientTape (reference: tensorflow/__init__.py:777-851) ----

class _DistributedGradientTape:
    def __init__(self, tape, op: ReduceOp = Average,
                 compression=Compression.none,
                 process_set: ProcessSet = global_process_set) -> None:
        self._tape = tape
        self._op = op
        self._compression = compression
        self._process_set = process_set

    def __getattr__(self, item):
        return getattr(self._tape, item)

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        # the reference tape accepts a lone Variable or any nest as
        # sources: flatten for the grouped allreduce and restore the
        # caller's structure afterwards
        tf = _tf()
        flat_src = tf.nest.flatten(sources)
        flat_grads = tf.nest.flatten(grads, expand_composites=False)
        names = [getattr(v, "name", "") for v in flat_src]
        out = self._allreduce_grads(flat_grads, names)
        return tf.nest.pack_sequence_as(grads, out, expand_composites=False)

    def _allreduce_grads(self, grads, var_names=None):
        return _host_grouped_allreduce(grads, self._compression, self._op,
                                       "tfgrad", self._process_set,
                                       var_names)


def DistributedGradientTape(gradtape, op: ReduceOp = Average,
                            compression=Compression.none,
                            process_set: ProcessSet = global_process_set):
    """Reference factory (``tensorflow/__init__.py:777``)."""
    return _DistributedGradientTape(gradtape, op, compression, process_set)


# -- DistributedOptimizer (reference: tensorflow/__init__.py:453-627) -------

class _DistributedOptimizer:
    """Wraps a keras optimizer: gradients are averaged across workers
    before ``apply_gradients`` (reference ``_DistributedOptimizer``)."""

    def __init__(self, optimizer, op: ReduceOp = Average,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 process_set: ProcessSet = global_process_set) -> None:
        self._opt = optimizer
        self._op = op
        self._compression = compression
        self._process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step
        self._pass = 0
        self._acc: Optional[list] = None
        # graph-mode aggregation state (reference:
        # tensorflow/gradient_aggregation.py LocalGradientAggregationHelper)
        self._agg_vars: Optional[list] = None
        self._agg_counter = None

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _sync(self, grads, tvars=None):
        names = [v.name for v in tvars] if tvars else None
        return _host_grouped_allreduce(grads, self._compression, self._op,
                                       "tfopt", self._process_set, names)

    def apply_gradients(self, grads_and_vars, *args, **kwargs):
        gv = list(grads_and_vars)
        grads = [g for g, _ in gv]
        tvars = [v for _, v in gv]
        # local accumulation for backward_passes_per_step (reference:
        # LocalGradientAggregationHelper, tensorflow/gradient_aggregation.py)
        if self.backward_passes_per_step > 1:
            tf = _tf()
            # the accumulators need dense tensors, so sparse gradients
            # densify here (the no-accumulation path keeps them sparse)
            grads = [tf.convert_to_tensor(g)
                     if isinstance(g, tf.IndexedSlices) else g
                     for g in grads]
            if not tf.executing_eagerly():
                return self._graph_accumulate_apply(tf, grads, tvars,
                                                    args, kwargs)
            gt = [_to_torch(g) for g in grads]
            self._acc = gt if self._acc is None else \
                [a + b for a, b in zip(self._acc, gt)]
            self._pass += 1
            if self._pass < self.backward_passes_per_step:
                return None
            grads = [_from_torch(a / self.backward_passes_per_step, g)
                     for a, g in zip(self._acc, grads)]
            self._acc, self._pass = None, 0
        grads = self._sync(grads, tvars)
        return self._opt.apply_gradients(zip(grads, tvars), *args, **kwargs)

    def _graph_accumulate_apply(self, tf, grads, tvars, args, kwargs):
        """tf.function-compatible accumulation: aggregation variables and a
        tf.cond applying every k-th call (reference:
        ``gradient_aggregation.py`` graph-mode helper)."""
        k = self.backward_passes_per_step
        if self._agg_vars is None:
            with tf.init_scope():
                self._agg_vars = [
                    tf.Variable(tf.zeros(g.shape, g.dtype),
                                trainable=False) for g in grads]
                self._agg_counter = tf.Variable(0, dtype=tf.int64,
                                                trainable=False)
        assigns = [v.assign_add(g)
                   for v, g in zip(self._agg_vars, grads)]
        with tf.control_dependencies(assigns):
            count = self._agg_counter.assign_add(1)

        def apply_now():
            avg = [tf.cast(v.read_value(), g.dtype) / float(k)
                   for v, g in zip(self._agg_vars, grads)]
            synced = self._sync(avg, tvars)
            self._opt.apply_gradients(zip(synced, tvars), *args, **kwargs)
            resets = [v.assign(tf.zeros_like(v)) for v in self._agg_vars]
            with tf.control_dependencies(resets):
                return tf.constant(True)

        def skip():
            return tf.constant(False)

        return tf.cond(tf.equal(count % k, 0), apply_now, skip)


def DistributedOptimizer(optimizer, op: ReduceOp = Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         process_set: ProcessSet = global_process_set):
    """Reference factory (``tensorflow/__init__.py:627``)."""
    return _DistributedOptimizer(optimizer, op, compression,
                                 backward_passes_per_step, process_set)


from horovod_tpu_torch.tensorflow.sync_batch_norm import (  # noqa: E402,F401
    SyncBatchNormalization)
from horovod_tpu_torch.tensorflow import elastic  # noqa: E402,F401
