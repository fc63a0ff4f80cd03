"""Distributed training API: ``DistributedOptimizer``, ``distributed_grad``
and the parameter, optimizer-state and object broadcasts.

Mirrors ``horovod_tpu/train/optimizer.py`` with the reference Horovod
torch API: ``hvd.DistributedOptimizer(optimizer, named_parameters=...,
compression=...)``. A ``torch.optim.Optimizer`` comes back wrapped (an
instance of a subclass of its own class sharing its parameter groups and
state) whose ``step()`` first replaces each gradient by its synchronized
value and then runs the optimizer's own step. A
:class:`~horovod_tpu_torch.train.fused_apply.FusedOptSpec`
(``fused_sgd``/``fused_adam``) with the parameters comes back as a
:class:`~horovod_tpu_torch.train.fused_apply.FusedOptimizer`.

Regimes of the gradient sync, as in the JAX package:

* **axis** (``axis=mesh.axis("dp")``): each gradient is reduced along the
  mesh axis with :func:`~horovod_tpu_torch.ops.mesh_collectives.preduce`,
  prescale before and postscale after (``_traced_allreduce_tree``); this
  runs the collective even on an axis of size 1.
* **eager multi-process** (``size() > 1``, no axis): the gradients are
  bucketed in the JAX flatten order of ``named_parameters`` (the
  parameter groups' order without names), 64 MiB a bucket, and each
  bucket's collective is issued asynchronously from a post-accumulate-grad
  hook as soon as backward has produced its last gradient; ``step()``
  issues what backward left and waits on every bucket before reading a
  gradient (``_eager_allreduce_tree``). Casts (fp16/bf16) reduce in their
  wire dtype; quantizers follow ``quantized_grouped_allreduce``: every rank
  quantizes each of its gradients, codes and scales are all-gathered, and
  each rank dequantizes every contribution and sums them in rank order.
  Each sync's seconds blocked on the wire and its wall seconds land on
  ``hvd_overlap_exposed_comm_seconds`` and ``hvd_overlap_sync_seconds``,
  a quantized bucket's bytes on the compression metrics.
* **one process**: the sync is the identity (``LocalBackend``'s scaled
  identity).

With ``compression=ErrorFeedback(codec)`` every regime first replaces the
gradient by ``qdq(grad + residual)`` and carries the error in a
per-parameter fp32 residual; the codec then also compresses the wire. A
bare codec compresses the wire only. ``backward_passes_per_step=k``
follows ``optax.MultiSteps``: ``step()`` is called after every backward;
the first k−1 calls fold the gradient into a running mean (Welford, as
optax) and clear it, and the k-th syncs that mean and steps; the hooks
launch no collective before the k-th pass.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.basics import is_initialized, size
from horovod_tpu_torch.common.process_sets import (ProcessSet,
                                                   global_process_set)
from horovod_tpu_torch.common.tree import jax_key, tree_flatten
from horovod_tpu_torch.compression import Compression, Compressor
from horovod_tpu_torch.compression.error_feedback import (ErrorFeedback,
                                                          ef_apply_one)
from horovod_tpu_torch.compression.metrics import record_compression
from horovod_tpu_torch.compression.quantizers import Quantized, Quantizer
from horovod_tpu_torch.ops.mesh_collectives import (Pending, _gathered,
                                                    start_preduce)
from horovod_tpu_torch.ops.reduce_op import Average, ReduceOp
from horovod_tpu_torch.train.buckets import (Bucket, BucketPlan, leaf_nbytes,
                                             pack, plan_buckets, unpack)


def _world() -> int:
    return size() if is_initialized() else 1


class _SetAxis(NamedTuple):
    """A process set seen as the axis the collectives take."""
    size: int
    group: object
    ranks: tuple


def _set_axis(process_set: ProcessSet) -> _SetAxis:
    return _SetAxis(process_set.size(), process_set.group,
                    tuple(process_set.ranks or range(size())))


# -- the eager multi-process sync -----------------------------------------------

def _eager_plan(leaves: Sequence[torch.Tensor], bucket_bytes=None
                ) -> BucketPlan:
    """The JAX eager path's buckets: the planner's, or one bucket for the
    whole tree with ``HVD_TPU_OVERLAP_BUCKETS=0``."""
    from horovod_tpu_torch.common.config import get_config
    if get_config().overlap_buckets and len(leaves) > 1:
        return plan_buckets(list(leaves), bucket_bytes)
    nbytes = sum(leaf_nbytes(l) for l in leaves)
    return BucketPlan((Bucket(tuple(range(len(leaves))), nbytes),), nbytes)


def _start_eager_bucket(vals: List[torch.Tensor], op: ReduceOp,
                        process_set: ProcessSet, compression: Compressor,
                        prescale: float, postscale: float) -> Pending:
    """Issue one bucket of the eager sync; ``wait()`` gives the reduced
    leaves in ``vals`` order. A quantized bucket's pre/wire bytes go to the
    compression metrics, as ``quantized_grouped_allreduce`` counts them."""
    axis = _set_axis(process_set)
    if isinstance(compression, Quantizer):
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(
                f"quantized allreduce supports Sum/Average, got {op}")
        if prescale != 1.0:
            vals = [v * prescale for v in vals]
        entries = []
        pre_bytes = wire_bytes = 0
        for v in vals:
            q, spec = compression.quantize(v)
            pre_bytes += v.numel() * v.element_size()
            wire_bytes += q.wire_bytes
            entries.append((_gathered(q.values, axis),
                            _gathered(q.scales, axis), spec, v.dtype))
        record_compression(compression.name, pre_bytes, wire_bytes)

        def finish_quantized():
            outs = []
            for gv, gs, spec, dtype in entries:
                gv, gs = gv.wait(), gs.wait()
                out = None
                for r in range(axis.size):   # summed in rank order
                    part = compression.dequantize(Quantized(gv[r], gs[r]),
                                                  spec)
                    out = part if out is None else out + part
                if op == ReduceOp.AVERAGE:
                    out = out / axis.size
                out = out.to(dtype)
                outs.append(out * postscale if postscale != 1.0 else out)
            return outs

        return Pending(None, finish_quantized)

    compressed, ctxs = zip(*(compression.compress(v) for v in vals))
    bucket = Bucket(tuple(range(len(vals))), 0)
    vec = pack(compressed, bucket)
    if prescale != 1.0:
        vec = vec * prescale
    reduce = start_preduce(vec, axis, op)

    def finish():
        red = reduce.wait()
        if postscale != 1.0:
            red = red * postscale
        return [compression.decompress(r, c) for r, c in
                zip(unpack(red, bucket, compressed), ctxs)]

    return Pending(None, finish)


def _record_sync_timing(exposed_s: float, total_s: float,
                        n_buckets: int) -> None:
    """Overlap efficiency on the registry, as the JAX eager sync records
    it: how much of the gradient sync was spent BLOCKED on the wire
    (exposed) vs overlapped with local work."""
    from horovod_tpu_torch.metrics.registry import default_registry
    reg = default_registry()
    reg.gauge("hvd_overlap_exposed_comm_seconds",
              help="seconds blocked on collective completion in the last "
              "gradient sync").set(exposed_s)
    reg.gauge("hvd_overlap_sync_seconds",
              help="wall seconds of the last eager gradient sync"
              ).set(total_s)
    reg.counter("hvd_overlap_exposed_comm_seconds_total",
                help="cumulative exposed-communication seconds"
                ).inc(exposed_s)
    reg.gauge("hvd_overlap_bucket_count",
              help="gradient buckets in the active overlap plan"
              ).set(n_buckets)


def _settle(t: torch.Tensor) -> None:
    """Block the host until the caller's stream has run all it was given
    so far (nothing to wait for on the CPU)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _wait_buckets(plan: BucketPlan, pending: Sequence[Pending], t0: float,
                  like: torch.Tensor) -> List[list]:
    """Wait for every bucket of the eager sync (begun at ``t0``) and
    record the sync timing; returns each bucket's reduced leaves.

    Exposed seconds are the host's seconds blocked in the buckets' waits
    after all local work. On the card ``Work.wait()`` only makes the
    caller's stream wait for the collective and returns at once, so the
    port settles the stream: first once before the waits (the backward
    and the codec queued so far are done; ``like`` names the device), then
    after each wait, so a bucket's seconds end when its reduced gradients
    exist on the card, not when its collective was queued."""
    _settle(like)
    exposed, outs = 0.0, []
    for p in pending:
        tw = time.perf_counter()
        out = p.wait()
        if out:
            _settle(out[0])
        exposed += time.perf_counter() - tw
        outs.append(out)
    _record_sync_timing(exposed, time.perf_counter() - t0, plan.num_buckets)
    return outs


def _eager_allreduce_tree(grads, op: ReduceOp, process_set: ProcessSet,
                          compression: Compressor, prescale: float,
                          postscale: float, bucket_bytes=None):
    """Bucketed eager allreduce of a gradient tree (tensors in a list or
    nested mappings, bucketed in JAX flatten order): every bucket is
    issued before the first is waited on; the exposed and total seconds
    land on the overlap metrics (:func:`_wait_buckets`)."""
    leaves, unflatten = tree_flatten(grads)
    if not leaves:
        return grads
    plan = _eager_plan(leaves, bucket_bytes)
    t0 = time.perf_counter()
    pending = [_start_eager_bucket([leaves[i] for i in b.indices], op,
                                   process_set, compression, prescale,
                                   postscale) for b in plan.buckets]
    out: list = [None] * len(leaves)
    for bucket, reduced in zip(plan.buckets,
                               _wait_buckets(plan, pending, t0, leaves[0])):
        for i, r in zip(bucket.indices, reduced):
            out[i] = r
    return unflatten(out)


def _axis_allreduce(grads: List[torch.Tensor], op: ReduceOp, axis,
                    prescale: float, postscale: float) -> List[torch.Tensor]:
    """``_traced_allreduce_tree`` with a live axis: each gradient reduced
    on its own, all issued before the first wait."""
    pending = [start_preduce(g * prescale if prescale != 1.0 else g, axis, op)
               for g in grads]
    out = [p.wait() for p in pending]
    return [g * postscale for g in out] if postscale != 1.0 else out


# -- backward_passes_per_step ---------------------------------------------------

class GradAccumulator:
    """``optax.MultiSteps`` over k backward passes: the running (Welford)
    mean of each parameter's gradient, ``acc + (g − acc) / (n + 1)``."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"backward_passes_per_step must be >= 1, got {k}")
        self.k = k
        self.mini = 0
        self._acc: Dict[int, torch.Tensor] = {}

    @property
    def final(self) -> bool:
        """Whether the current pass is the k-th (the one that steps)."""
        return self.mini == self.k - 1

    def mean(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        """The gradient the k-th pass syncs: the mean over the passes so
        far including this one (``p.grad`` itself when k is 1)."""
        g = p.grad
        if self.k == 1:
            return g
        if g is None:
            g = torch.zeros_like(p)
        acc = self._acc.get(id(p))
        if acc is None:
            acc = torch.zeros_like(g)
        return acc + (g - acc) / (self.mini + 1)

    def advance(self, params: Sequence[torch.Tensor]) -> bool:
        """At ``step()``: True on the k-th pass (sync and step, then
        :meth:`reset`); otherwise fold every gradient into the mean, clear
        it and return False."""
        if self.final:
            return True
        for p in params:
            self._acc[id(p)] = self.mean(p)
            p.grad = None
        self.mini += 1
        return False

    def reset(self) -> None:
        self.mini = 0
        self._acc.clear()


# -- the wrapped torch optimizer ------------------------------------------------

class _DistributedMixin:
    """The ``step`` of a wrapped torch optimizer (see the module doc)."""

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if not self._hvd_multi.advance(self._hvd_params):
            return loss
        self.synchronize()
        super().step()
        self._hvd_multi.reset()
        if self._hvd_hooks is not None:
            self._hvd_hooks.reset()
        return loss

    def _hvd_prepared(self, i: int) -> Optional[torch.Tensor]:
        """Parameter ``i``'s gradient as it goes on the wire: the k-pass
        mean, then the EF round trip through the codec."""
        p = self._hvd_params[i]
        g = self._hvd_multi.mean(p)
        if g is None and self._hvd_regime == "eager":
            g = torch.zeros_like(p)   # every rank reduces every bucket
        if g is not None and self._hvd_ef and g.is_floating_point():
            r = self._hvd_residual.get(p)
            if r is None:
                r = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            g, self._hvd_residual[p] = ef_apply_one(self._hvd_codec, g, r)
        return g

    def _hvd_launch(self, b: int) -> None:
        if not self._hvd_pending:
            self._hvd_sync_t0 = time.perf_counter()   # the sync begins
        bucket = self._hvd_plan.buckets[b]
        vals = [self._hvd_prepared(i) for i in bucket.indices]
        self._hvd_pending[b] = _start_eager_bucket(
            vals, self._hvd_op, self._hvd_process_set, self._hvd_codec,
            self._hvd_prescale, self._hvd_postscale)

    @torch.no_grad()
    def synchronize(self) -> None:
        """Replace every gradient by its synchronized value (waiting on
        every bucket the backward pass launched)."""
        params = self._hvd_params
        if self._hvd_regime == "eager":
            if self._hvd_hooks is None:
                for b in range(self._hvd_plan.num_buckets):
                    self._hvd_launch(b)
            else:
                self._hvd_hooks.launch_rest()
            plan = self._hvd_plan
            pending = [self._hvd_pending.pop(b)
                       for b in range(plan.num_buckets)]
            for bucket, reduced in zip(plan.buckets, _wait_buckets(
                    plan, pending, self._hvd_sync_t0, params[0])):
                for i, g in zip(bucket.indices, reduced):
                    params[i].grad = g
            return
        pairs = [(i, self._hvd_prepared(i)) for i in range(len(params))]
        pairs = [(i, g) for i, g in pairs if g is not None]
        grads = [g for _, g in pairs]
        if self._hvd_regime == "axis":
            grads = _axis_allreduce(grads, self._hvd_op, self._hvd_axis,
                                    self._hvd_prescale, self._hvd_postscale)
        else:
            if self._hvd_prescale != 1.0:
                grads = [g * self._hvd_prescale for g in grads]
            if self._hvd_postscale != 1.0:
                grads = [g * self._hvd_postscale for g in grads]
        for (i, _), g in zip(pairs, grads):
            params[i].grad = g


def _ordered_params(optimizer: torch.optim.Optimizer, named_parameters
                    ) -> List[torch.nn.Parameter]:
    """The optimizer's parameters in the plan's order: the JAX flatten
    order of ``named_parameters`` (then any parameter it does not name, in
    group order), or the groups' order."""
    in_groups = [p for g in optimizer.param_groups for p in g["params"]]
    if named_parameters is None:
        return in_groups
    named = sorted(named_parameters, key=lambda np_: jax_key(np_[0]))
    ids = {id(p) for p in in_groups}
    order = [p for _, p in named if id(p) in ids]
    seen = {id(p) for p in order}
    return order + [p for p in in_groups if id(p) not in seen]


def _wrap(optimizer: torch.optim.Optimizer, named_parameters, compression,
          op: ReduceOp, process_set: ProcessSet, axis, prescale: float,
          postscale: float, backward_passes_per_step: int,
          bucket_bytes) -> torch.optim.Optimizer:
    from horovod_tpu_torch.train.overlap import BucketHooks
    cls = type(optimizer)
    sub = type(cls.__name__, (_DistributedMixin, cls), {})
    out = sub.__new__(sub)
    out.__dict__.update(optimizer.__dict__)    # shares groups and state
    ef = isinstance(compression, ErrorFeedback)
    out._hvd_ef = ef
    out._hvd_codec = compression.inner if ef else compression
    out._hvd_residual = {}
    out._hvd_op = op
    out._hvd_process_set = process_set
    out._hvd_axis = axis
    out._hvd_prescale = float(prescale)
    out._hvd_postscale = float(postscale)
    out._hvd_multi = GradAccumulator(backward_passes_per_step)
    out._hvd_params = _ordered_params(optimizer, named_parameters)
    out._hvd_regime = ("axis" if axis is not None
                       else "eager" if _world() > 1 else "identity")
    out._hvd_hooks = None
    if out._hvd_regime == "eager":
        out._hvd_plan = _eager_plan(out._hvd_params, bucket_bytes)
        out._hvd_pending = {}
        out._hvd_hooks = BucketHooks(
            out._hvd_params, out._hvd_plan, out._hvd_launch,
            armed=lambda: out._hvd_multi.final)
    return out


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression: Compressor = Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         process_set: ProcessSet = global_process_set,
                         axis=None, bucket_bytes: Optional[int] = None,
                         autotune=None):
    """Wrap a torch optimizer with gradient synchronization, or build the
    fused int8 optimizer from ``fused_sgd``/``fused_adam`` and
    ``named_parameters`` (the parameters, named or not). ``axis`` (a
    :class:`~horovod_tpu_torch.parallel.mesh.Axis`) selects the axis
    regime. See the module docstring; the same combinations raise as in
    the JAX package.

    ``autotune=True`` (``None``: ``HVD_TPU_AUTOTUNE_MESH``) warm-starts
    the communication knobs from the plan cache: the parameters'
    fingerprint is looked up in ``HVD_TPU_AUTOTUNE_CACHE_DIR``, and a hit
    applies the tuned ``bucket_bytes`` and, when no ``compression`` was
    given, the tuned codec wrapped in error feedback. A miss keeps the
    settings; the search that fills the cache is
    ``make_overlap_train_step(..., autotune=True)``. Adasum and the fused
    optimizers have no such seam and raise (the env default skips
    them)."""
    from horovod_tpu_torch.train.fused_apply import (FusedOptimizer,
                                                     FusedOptSpec)
    env_autotune = False
    if autotune is None:
        from horovod_tpu_torch.common.config import get_config
        autotune = get_config().autotune_mesh
        env_autotune = bool(autotune)
    if autotune and (op == ReduceOp.ADASUM
                     or isinstance(optimizer, FusedOptSpec)):
        if not env_autotune:
            raise ValueError(
                "autotune= applies to the standard sync path only "
                "(Adasum has no codec/bucket seam; the fused apply "
                "pins its own codec)")
        autotune = False
    if isinstance(optimizer, FusedOptSpec):
        if op == ReduceOp.ADASUM:
            raise ValueError("fused_sgd/fused_adam have no Adasum path")
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "fused apply does not take pre/postscale factors; fold "
                "them into the learning rate")
        if named_parameters is None:
            raise ValueError(
                "fused_sgd/fused_adam need the parameters: "
                "DistributedOptimizer(spec, model.named_parameters(), "
                "compression=...)")
        return FusedOptimizer(named_parameters, optimizer,
                              compression=compression, op=op, axis=axis,
                              process_set=process_set,
                              backward_passes_per_step=backward_passes_per_step)
    if not isinstance(optimizer, torch.optim.Optimizer):
        raise TypeError(f"DistributedOptimizer wraps a torch.optim."
                        f"Optimizer or a FusedOptSpec, got "
                        f"{type(optimizer).__name__}")
    if op == ReduceOp.ADASUM:
        if compression is not Compression.none:
            raise ValueError(
                "op=Adasum has no compression seam (the scaled-add tree "
                "needs exact contributions); drop compression= or use a "
                "different op")
        raise NotImplementedError(
            "op=Adasum arrives with the eager-collectives slice of the port")
    if named_parameters is not None:
        named_parameters = list(named_parameters)
    if autotune:
        compression, bucket_bytes = _warm_start(
            optimizer, named_parameters, compression, bucket_bytes)
    return _wrap(optimizer, named_parameters, compression, op, process_set,
                 axis, prescale_factor, postscale_factor,
                 backward_passes_per_step, bucket_bytes)


def _warm_start(optimizer, named_parameters, compression, bucket_bytes):
    """``(compression, bucket_bytes)`` from the plan cache's entry for
    these parameters at this world (the launcher's hosts x local split),
    or as given on a miss; never raises."""
    try:
        from horovod_tpu_torch.common.basics import local_size
        from horovod_tpu_torch.common.topology import (MeshTopology,
                                                       detect_topology)
        from horovod_tpu_torch.train.autotune import (PlanCache,
                                                      plan_fingerprint,
                                                      resolve_cache_dir,
                                                      topology_key)
        cache_dir = resolve_cache_dir(None)
        if not cache_dir:
            return compression, bucket_bytes
        w, ls = _world(), local_size()
        if ls > 0 and w % ls == 0 and w // ls > 1:
            topo = MeshTopology(w // ls, ls)
        else:
            topo = detect_topology(n=w)
        if named_parameters is not None:
            tree = {n: p for n, p in named_parameters}
        else:
            tree = [p for g in optimizer.param_groups for p in g["params"]]
        plan = PlanCache(cache_dir).load(
            plan_fingerprint(tree, topology_key(topo), w))
        if plan is None:
            return compression, bucket_bytes
        codec = plan.resolve_codec()
        if codec is not None and compression is Compression.none:
            # a lossy wire needs the residual carried to converge
            compression = ErrorFeedback(codec)
        from horovod_tpu_torch.diagnostics.flight_recorder import \
            record_event
        record_event("autotune_warm_start", plan=plan.key)
        from horovod_tpu_torch.metrics.registry import default_registry
        default_registry().counter(
            "hvd_autotune_cache_hits_total",
            help="runs that started from a cached tuned plan with zero "
                 "search trials").inc()
        return compression, plan.bucket_bytes
    except Exception:  # the warm start is best-effort, never fatal
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().debug("autotune warm start failed", exc_info=True)
        return compression, bucket_bytes


# -- distributed_grad -----------------------------------------------------------

def _grad_targets(target):
    """``(leaves, rebuild)`` of what ``distributed_grad`` differentiates
    with respect to: a module's trainable parameters (keyed by name), a
    tensor, or tensors in a list or nested mappings."""
    if isinstance(target, torch.nn.Module):
        target = {n: p for n, p in target.named_parameters()
                  if p.requires_grad}
    return tree_flatten(target)


def distributed_grad(fun: Callable, argnums: int = 0, has_aux: bool = False,
                     op: ReduceOp = Average,
                     process_set: ProcessSet = global_process_set,
                     compression: Compressor = Compression.none,
                     axis=None) -> Callable:
    """``jax.value_and_grad`` with cross-worker gradient reduction, the
    counterpart of ``DistributedGradientTape``: ``wrapped(*args) ->
    (value, grads)`` with the gradients of ``fun``'s value with respect to
    ``args[argnums]`` (a module's parameters, a tensor, or tensors in a
    tree), reduced as ``DistributedOptimizer``'s regimes reduce. With
    ``has_aux`` ``fun`` returns ``(value, aux)`` and so does ``value``.
    Error feedback needs state across steps and raises here."""
    if isinstance(compression, ErrorFeedback):
        raise ValueError(
            "distributed_grad is stateless and cannot carry ErrorFeedback "
            "residuals; wrap your optimizer with DistributedOptimizer("
            "compression=ErrorFeedback(...)) instead")

    def wrapped(*args, **kwargs):
        leaves, rebuild = _grad_targets(args[argnums])
        out = fun(*args, **kwargs)
        value = out[0] if has_aux else out
        grads = list(torch.autograd.grad(value, leaves))
        if axis is not None:
            grads = _axis_allreduce(grads, op, axis, 1.0, 1.0)
        elif _world() > 1:
            grads = _eager_allreduce_tree(grads, op, process_set,
                                          compression, 1.0, 1.0)
        value = value.detach()
        return ((value, out[1]) if has_aux else value), rebuild(grads)

    return wrapped


# -- parameter, state and object broadcast -------------------------------------

def _tensors(params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    elif isinstance(params, (list, tuple)) and params and \
            isinstance(params[0], tuple):
        params = dict(params)            # named_parameters() pairs
    return tree_flatten(params)[0]


def broadcast_parameters(params, root_rank: int = 0,
                         process_set: ProcessSet = global_process_set):
    """Broadcast parameters from ``root_rank`` to every rank of the set, in
    place (reference: ``broadcast_parameters``,
    ``torch/functions.py:29-68``): a module (its ``state_dict``), a
    ``state_dict``, ``named_parameters()`` or a list of tensors. Every
    broadcast is issued before the first wait. Returns ``params``."""
    if process_set.size() == 1:
        return params
    if not isinstance(params, (dict, list, tuple, torch.nn.Module)):
        params = list(params)
    src = process_set.global_rank(root_rank)
    with torch.no_grad():
        works = [dist.broadcast(t.detach(), src=src, group=process_set.group,
                                async_op=True) for t in _tensors(params)]
    for w in works:
        w.wait()
    return params


def _on_wire(t: torch.Tensor) -> bool:
    """Whether the process group moves ``t`` itself (NCCL moves CUDA
    tensors only; the rest travel pickled)."""
    from horovod_tpu_torch.common.basics import backend
    return backend() != "nccl" or t.is_cuda


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0,
                              process_set: ProcessSet = global_process_set):
    """Give every rank ``root_rank``'s optimizer state and hyperparameters
    (reference: ``broadcast_optimizer_state``, ``torch/functions.py:116-
    266``), also where a rank has no state yet: the state's structure and
    scalars travel pickled, its tensors by broadcast. Returns the
    optimizer."""
    if process_set.size() == 1:
        return optimizer
    is_root = process_set.rank() == root_rank
    sd = optimizer.state_dict() if is_root else None
    if is_root:
        skel = {"param_groups": sd["param_groups"], "state": {
            pid: {k: (("tensor", tuple(v.shape), v.dtype)
                      if isinstance(v, torch.Tensor) and _on_wire(v) else v)
                  for k, v in st.items()}
            for pid, st in sd["state"].items()}}
    else:
        skel = None
    skel = broadcast_object(skel, root_rank, process_set=process_set)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for pid in sorted(skel["state"]):
        state[pid] = {}
        for k in sorted(skel["state"][pid]):
            v = skel["state"][pid][k]
            if isinstance(v, tuple) and len(v) == 3 and v[0] == "tensor":
                v = (sd["state"][pid][k] if is_root else
                     torch.empty(v[1], dtype=v[2], device=params[pid].device))
                dist.broadcast(v, src=process_set.global_rank(root_rank),
                               group=process_set.group)
            state[pid][k] = v
    if not is_root:
        optimizer.load_state_dict({"param_groups": skel["param_groups"],
                                   "state": state})
    return optimizer


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set):
    """Pickle-based broadcast of any object from ``root_rank`` (reference:
    ``broadcast_object``, ``torch/functions.py:193-241``)."""
    del name   # the reference names the collective; torch needs no name
    if process_set.size() == 1:
        return obj
    box = [obj if process_set.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=process_set.global_rank(root_rank),
                               group=process_set.group)
    return box[0]


def allgather_object(obj, name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set):
    """Pickle-based allgather: every rank's object, in rank order
    (reference: ``allgather_object``, ``torch/functions.py:233-266``)."""
    del name
    if process_set.size() == 1:
        return [obj]
    out = [None] * process_set.size()
    dist.all_gather_object(out, obj, group=process_set.group)
    return out
