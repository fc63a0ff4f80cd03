"""Backprop/collective overlap engine: bucketed gradient reduction along a
mesh axis, launched from the backward pass and pipelined across
microbatches.

Mirrors ``horovod_tpu/train/overlap.py``: ``resolve_small_floor``,
``bucketed_grad_sync``, ``pipelined_accumulate`` and
``make_overlap_train_step``. The JAX engine leaves the overlap to XLA's
scheduler inside ``lax.scan``; eager PyTorch overlaps for real:

* a post-accumulate-grad hook on every parameter counts the leaves of each
  bucket as backward produces their gradients, and the bucket's
  collective is issued (``async_op``) as soon as its last leaf is in;
* microbatch k−1's buckets stay in flight while microbatch k's forward and
  backward run, and are waited on and summed after it.

``overlap=False`` is the serialized comparator: no hooks, each
microbatch's buckets are reduced and waited on before the next backward.
Buckets come from :mod:`horovod_tpu_torch.train.buckets`, planned over the
parameters in the JAX flatten order; each bucket is one ``psum``/``pmean``
(:func:`~horovod_tpu_torch.ops.mesh_collectives.preduce`), the quantized
``reduce_scatter → quantize → all_gather`` (``preduce_quantized``), the
ring (``pring_allreduce``) or the hierarchical path (``phier_allreduce``).
Reduction is linear, so the pipelined sum equals the reduce-at-the-end
result up to fp reassociation (the quantized path quantizes each
microbatch on its own).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from horovod_tpu_torch.common.tree import jax_key, tree_flatten
from horovod_tpu_torch.ops.mesh_collectives import (
    Pending, phier_allreduce, preduce, pring_allreduce, start_preduce,
    start_preduce_quantized)
from horovod_tpu_torch.ops.reduce_op import Average, ReduceOp, Sum
from horovod_tpu_torch.profiling import annotate
from horovod_tpu_torch.train.buckets import (BucketPlan, pack, plan_buckets,
                                             unpack)
from horovod_tpu_torch.train.guard import (GuardedStep, guarded_apply,
                                           resolve_spec)


def resolve_small_floor(small_floor: Optional[int] = None) -> int:
    """Effective small-bucket latency floor in bytes: explicit argument >
    ``HVD_TPU_SMALL_BUCKET_FLOOR``. 0 disables the latency path."""
    if small_floor is not None:
        return max(0, int(small_floor))
    from horovod_tpu_torch.common.config import get_config
    return max(0, get_config().small_bucket_floor)


class BucketReducer:
    """The reduction of one packed bucket along ``axis``, with the options
    of :func:`bucketed_grad_sync` resolved once."""

    def __init__(self, axis, op: ReduceOp = Average, compression=None,
                 ring: bool = False, algorithm: Optional[str] = None,
                 topology=None, small_floor: Optional[int] = None):
        algo = algorithm or ("ring" if ring else "psum")
        if algo not in ("psum", "ring", "hier"):
            raise ValueError(
                f"unknown bucket algorithm {algorithm!r}; expected "
                "psum | ring | hier")
        if algo == "ring" and compression is not None:
            raise ValueError(
                "ring allreduce has no compression seam (per-hop "
                "requantization accumulates error); use algorithm='psum' or "
                "'hier' with a quantizer")
        if compression is not None and op not in (Sum, ReduceOp.AVERAGE):
            raise ValueError(
                f"quantized bucket sync supports Sum/Average, got {op}")
        if algo == "hier":
            if topology is None:
                from horovod_tpu_torch.common.topology import detect_topology
                topology = detect_topology(n=axis.size)
            if not topology.is_hierarchical:
                algo = "psum"   # flat topology: the two-level path IS psum
        self.axis, self.op, self.compression = axis, op, compression
        self.algo, self.topology = algo, topology
        self.floor = resolve_small_floor(small_floor)

    def start(self, leaves: Sequence[torch.Tensor], bucket) -> Pending:
        """Pack ``bucket``'s leaves and issue their reduction, in the spans
        ``hvd.pack`` and ``hvd.reduce``; the caller marks the wait and the
        unpack ``hvd.unpack`` (where the ring and hierarchical paths do
        their work)."""
        small = self.floor > 0 and bucket.nbytes < self.floor
        dense = small or (self.algo == "psum" and self.compression is None)
        quantized = not dense and self.algo == "psum"
        with annotate("hvd.pack"):
            vec = pack(leaves, bucket,
                       pad_to=self.axis.size if quantized else 1)
        with annotate("hvd.reduce"):
            if dense:
                return start_preduce(vec, self.axis, self.op, inplace=True)
            if quantized:
                pending = start_preduce_quantized(vec, self.axis,
                                                  self.compression, self.op)
            elif self.algo == "ring":
                pending = Pending(None, lambda: pring_allreduce(
                    vec, self.axis, self.op))
            else:
                pending = Pending(None, lambda: phier_allreduce(
                    vec, self.axis, self.topology, self.op,
                    inter_codec=self.compression))
        return pending


def bucketed_grad_sync(grads, axis, plan: Optional[BucketPlan] = None,
                       bucket_bytes: Optional[int] = None,
                       op: ReduceOp = Average, compression=None,
                       ring: bool = False, algorithm: Optional[str] = None,
                       topology=None, small_floor: Optional[int] = None):
    """Reduce a gradient tree (tensors in a list or nested mappings)
    along ``axis`` bucket by bucket; returns a tree of the same structure.

    Every bucket's leaves are packed into one flat vector and reduced with
    one collective, chosen by ``algorithm``: ``"psum"`` (default;
    with ``compression``, a quantizer, the EQuARX ``reduce_scatter →
    quantize → all_gather`` path), ``"ring"`` (``ring=True``; no
    compression seam) or ``"hier"`` (quantizing the inter-host hop only;
    ``topology`` defaults to :func:`~horovod_tpu_torch.common.topology.
    detect_topology` over the axis size, and a flat one degrades to psum).
    Buckets under ``small_floor`` bytes take one dense psum. All buckets
    are issued before the first is waited on; each bucket's wait and
    unpack is the span ``hvd.unpack``. Quantized, ring and hierarchical
    paths support Sum/Average only."""
    leaves, unflatten = tree_flatten(grads)
    if not leaves:
        return grads
    if plan is None:
        plan = plan_buckets(leaves, bucket_bytes)
    reducer = BucketReducer(axis, op, compression, ring, algorithm, topology,
                            small_floor)
    pending = [reducer.start(leaves, b) for b in plan.buckets]
    out: list = [None] * len(leaves)
    for bucket, p in zip(plan.buckets, pending):
        with annotate("hvd.unpack"):
            for i, leaf in zip(bucket.indices,
                               unpack(p.wait(), bucket, leaves)):
                out[i] = leaf
    return unflatten(out)


class BucketHooks:
    """Calls ``launch(b)`` from the backward pass once every leaf of bucket
    ``b`` of ``plan`` (over ``params``) has its gradient, through
    post-accumulate-grad hooks; :meth:`launch_rest` issues the buckets the
    pass left incomplete (leaves that got no gradient). ``armed()`` decides
    per pass whether the hooks launch at all."""

    def __init__(self, params: Sequence[torch.nn.Parameter], plan: BucketPlan,
                 launch: Callable[[int], None],
                 armed: Callable[[], bool] = lambda: True):
        self._plan, self._launch, self._armed = plan, launch, armed
        self._bucket_of = {}
        for b, bucket in enumerate(plan.buckets):
            for i in bucket.indices:
                self._bucket_of[id(params[i])] = b
        self._handles = [p.register_post_accumulate_grad_hook(self._hook)
                         for p in params if p.requires_grad]
        self.reset()

    def reset(self) -> None:
        """Start a new pass: no leaf counted, no bucket launched."""
        self._seen = set()
        self._count = [0] * self._plan.num_buckets
        self.launched = [False] * self._plan.num_buckets

    def _hook(self, p: torch.Tensor) -> None:
        if not self._armed():
            return
        if id(p) in self._seen:
            raise RuntimeError(
                "a gradient was computed twice in one pass: call step() "
                "after every backward (backward_passes_per_step counts "
                "the passes)")
        self._seen.add(id(p))
        b = self._bucket_of[id(p)]
        self._count[b] += 1
        if self._count[b] == len(self._plan.buckets[b].indices):
            self.launched[b] = True
            self._launch(b)

    def launch_rest(self) -> None:
        for b, done in enumerate(self.launched):
            if not done:
                self.launched[b] = True
                self._launch(b)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def bucket_grads(params: Sequence[torch.nn.Parameter], bucket
                 ) -> List[Optional[torch.Tensor]]:
    """A leaf list for :func:`~horovod_tpu_torch.train.buckets.pack`: the
    gradients of ``bucket``'s parameters (zeros where backward left none,
    so every rank reduces the same buckets), None elsewhere."""
    leaves: List[Optional[torch.Tensor]] = [None] * len(params)
    for i in bucket.indices:
        g = params[i].grad
        leaves[i] = g if g is not None else torch.zeros_like(params[i])
    return leaves


def jax_ordered_parameters(model: torch.nn.Module):
    """``(names, params)`` of the trainable parameters in the JAX flatten
    order of the same tree (:func:`~horovod_tpu_torch.common.tree.jax_key`):
    the order every bucket plan of the port is made over."""
    named = sorted(((n, p) for n, p in model.named_parameters()
                    if p.requires_grad), key=lambda np_: jax_key(np_[0]))
    return [n for n, _ in named], [p for _, p in named]


def _accumulate(loss_fn, model, microbatches, reducer: Optional[BucketReducer],
                plan: BucketPlan, params, overlap: bool,
                microbatch_mean: bool):
    """The microbatch loop: ``(mean loss, reduced gradient leaves)``, each
    leaf at ``params``' index, with the microbatch mean applied.
    ``reducer=None`` skips the sync. Each microbatch's forward and
    backward are the spans ``hvd.forward`` and ``hvd.backward``, what
    follows its backward ``hvd.sync_grads`` (the last one unpacks)."""
    n_micro = microbatches[0].shape[0]
    cur: list = []

    def launch(b):
        bucket = plan.buckets[b]
        leaves = bucket_grads(params, bucket)
        cur[b] = (reducer.start(leaves, bucket) if reducer
                  else Pending(None, lambda v=pack(leaves, bucket): v))

    hooks = (BucketHooks(params, plan, launch)
             if overlap and reducer is not None else None)
    acc: list = [None] * plan.num_buckets

    def add(pending):
        for b, p in enumerate(pending):
            with annotate("hvd.unpack"):
                v = p.wait()
            with annotate("hvd.accumulate"):
                acc[b] = v if acc[b] is None else acc[b] + v

    losses = []

    def finish(last):
        """The last buckets in flight, the microbatch means, the leaves."""
        if last is not None:
            add(last)
        mean_loss = (losses[0] + torch.stack(losses[1:]).sum() if n_micro > 1
                     else losses[0]) / n_micro
        vecs = acc
        if microbatch_mean and n_micro > 1:
            with annotate("hvd.accumulate"):
                vecs = [v * (1.0 / n_micro) for v in acc]
        out: list = [None] * len(params)
        for bucket, vec in zip(plan.buckets, vecs):
            with annotate("hvd.unpack"):
                for i, g in zip(bucket.indices, unpack(vec, bucket, params)):
                    out[i] = g
        return mean_loss, out

    in_flight = None
    try:
        for k in range(n_micro):
            for p in params:
                p.grad = None
            cur = [None] * plan.num_buckets
            if hooks is not None:
                hooks.reset()
            with annotate("hvd.forward"):
                loss = loss_fn(model, tuple(x[k] for x in microbatches))
            with annotate("hvd.backward"):
                loss.backward()
            losses.append(loss.detach())
            with annotate("hvd.sync_grads"):
                if hooks is not None:
                    hooks.launch_rest()
                    if in_flight is not None:
                        add(in_flight)  # k−1's buckets, in flight until now
                    in_flight = cur
                else:
                    for b in range(plan.num_buckets):
                        launch(b)
                    add(cur)
                if k == n_micro - 1:
                    result = finish(in_flight)
    finally:
        if hooks is not None:
            hooks.remove()
    return result


def pipelined_accumulate(loss_fn: Callable, model: torch.nn.Module,
                         microbatches: Sequence[torch.Tensor], *, axis,
                         op: ReduceOp = Average,
                         plan: Optional[BucketPlan] = None,
                         bucket_bytes: Optional[int] = None,
                         compression=None, ring: bool = False,
                         algorithm: Optional[str] = None, topology=None,
                         small_floor: Optional[int] = None,
                         overlap: bool = True, sync: bool = True,
                         microbatch_mean: bool = True):
    """Microbatch-accumulated gradients of ``model``'s trainable
    parameters, reduced along ``axis`` bucket by bucket.

    ``loss_fn(model, microbatch) -> scalar loss``; ``microbatches`` holds
    tensors whose leading dimension is the microbatch count. Returns
    ``(mean_loss, grads)``, ``grads`` a dict of parameter name → reduced
    gradient (per ``op``, averaged over microbatches unless
    ``microbatch_mean=False``), in the JAX flatten order, and leaves each
    parameter's ``.grad`` at that value. ``overlap=True`` launches each
    bucket from the backward pass and keeps microbatch k−1's buckets in
    flight through microbatch k's backward; ``overlap=False`` reduces and
    waits after each backward; ``sync=False`` skips the reduction (the
    compute-only baseline)."""
    sizes = {x.shape[0] for x in microbatches}
    if len(sizes) != 1:
        raise ValueError(
            f"microbatch leaves disagree on the leading axis: {sizes}")
    if sizes.pop() < 1:
        raise ValueError("need at least one microbatch")
    names, params = jax_ordered_parameters(model)
    if plan is None:
        plan = plan_buckets(params, bucket_bytes)
    reducer = (BucketReducer(axis, op, compression, ring, algorithm,
                             topology, small_floor) if sync else None)
    loss, grads = _accumulate(loss_fn, model, tuple(microbatches), reducer,
                              plan, params, overlap, microbatch_mean)
    for p, g in zip(params, grads):
        p.grad = g
    return loss, dict(zip(names, grads))


def make_overlap_train_step(loss_fn: Callable, mesh, axis_name: str = "dp",
                            *, n_micro: int = 1, op: ReduceOp = Average,
                            bucket_bytes: Optional[int] = None,
                            compression=None, ring: bool = False,
                            algorithm: Optional[str] = None, topology=None,
                            small_floor: Optional[int] = None,
                            overlap: bool = True, sync: bool = True,
                            autotune=None, guard=None) -> Callable:
    """Data-parallel train step with pipelined bucket overlap:
    ``step(model, optimizer, batch) -> (model, optimizer, loss)``.

    ``batch`` is a tuple of this rank's rows (see
    :func:`~horovod_tpu_torch.parallel.mesh.shard_batch`), split into
    ``n_micro`` microbatches along the leading dimension; gradients go
    through :func:`pipelined_accumulate` along ``mesh.axis(axis_name)``,
    then ``optimizer`` (a torch optimizer over the model's parameters)
    steps, and the returned loss is the microbatch mean averaged over the
    axis. The keyword knobs are :func:`pipelined_accumulate`'s. The step
    is the span ``hvd.step``: each microbatch's ``hvd.forward``,
    ``hvd.backward`` (where the overlapped buckets are packed and issued)
    and ``hvd.sync_grads``, then ``hvd.optimizer``.

    ``guard`` (:mod:`horovod_tpu_torch.train.guard`): ``None`` reads
    ``HVD_TPU_GUARD`` (default on: non-finite or over-norm gradients skip
    the step, parameters and optimizer state unchanged), and the step is
    then a :class:`~horovod_tpu_torch.train.guard.GuardedStep`; ``False``
    steps unconditionally.

    ``autotune`` (``True``, an ``AutotuneOptions`` or a ``Plan``; ``None``
    reads ``HVD_TPU_AUTOTUNE_MESH``) hands the communication knobs to the
    plan search (:func:`~horovod_tpu_torch.train.autotune.
    make_autotuned_train_step`): the knobs given here are its baseline
    candidate, and the returned step searches, locks and then serves the
    winner (a warm plan cache locks it on the first call)."""
    if autotune is None:
        from horovod_tpu_torch.common.config import get_config
        autotune = get_config().autotune_mesh or None
    if autotune:
        from horovod_tpu_torch.train.autotune import \
            make_autotuned_train_step
        return make_autotuned_train_step(
            loss_fn, mesh, axis_name, autotune=autotune, n_micro=n_micro,
            op=op, bucket_bytes=bucket_bytes, compression=compression,
            ring=ring, algorithm=algorithm, topology=topology,
            small_floor=small_floor, overlap=overlap, sync=sync,
            guard=guard)
    axis = mesh.axis(axis_name)
    gspec = resolve_spec(guard)
    kw = dict(axis=axis, op=op, bucket_bytes=bucket_bytes,
              compression=compression, ring=ring, algorithm=algorithm,
              topology=topology, small_floor=small_floor, overlap=overlap,
              sync=sync)

    def _loss_and_step(model, optimizer, batch):
        micro = tuple(x.reshape((n_micro, x.shape[0] // n_micro)
                                + tuple(x.shape[1:])) for x in batch)
        with annotate("hvd.step"):
            loss, _ = pipelined_accumulate(loss_fn, model, micro, **kw)
            with annotate("hvd.optimizer"):
                if gspec.enabled:
                    ok = guarded_apply(optimizer, gspec)
                else:
                    optimizer.step()
                    ok = True
            loss = preduce(loss, axis, Average)
        return model, optimizer, loss, ok

    if not gspec.enabled:
        def step(model, optimizer, batch):
            return _loss_and_step(model, optimizer, batch)[:3]
        return step
    return GuardedStep(_loss_and_step, gspec, canary_axis=axis)
