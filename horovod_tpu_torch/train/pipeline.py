"""Composed dp x pp train step: pipelined training whose dp gradient
traffic goes through the bucketed sync.

Mirrors ``horovod_tpu/train/pipeline.py``: ``_pipeline_metrics``,
``record_measured_bubble``, ``stage_layout_permutation``,
``PipelineTrainStep`` and ``make_pipeline_train_step``, which degenerates
into :func:`~horovod_tpu_torch.train.overlap.make_overlap_train_step`
when the plan has ``pp == 1``. The model contract is layer-major:

* parameters: a tree (mapping) whose every leaf has the leading dim
  ``n_layers`` in the model's natural order;
* ``layer_fn(layer_params, x) -> x`` applies ONE layer (its parameters
  the leaves indexed at that layer), the activation's shape kept;
* ``loss_fn(y, targets) -> scalar`` consumes the last layer's output.

Each pipeline rank holds only its own stages: :meth:`PipelineTrainStep.
prepare_params` takes the natural-order tree and returns this rank's
block of the device-major storage order (:func:`stage_layout_permutation`,
the identity unless interleaved) as a ``torch.nn.ParameterDict``, over
which the caller builds the optimizer; :meth:`~PipelineTrainStep.
restore_params` gathers the blocks over pp and gives the natural order
back, bit for bit. ``step(params, optimizer, batch) -> (params, optimizer,
loss)`` takes this rank's rows ``(x, targets)`` (every stage of a
pipeline the same rows; stage 0 reads ``x``, the last stage
``targets``), runs the plan's schedule
(:mod:`horovod_tpu_torch.parallel.pipeline`), reduces the stage
gradients over dp (``dp_sync="bucketed"``:
:func:`~horovod_tpu_torch.train.overlap.bucketed_grad_sync` with the
plan's buckets, algorithm and codec; ``"dense"``: one pmean a leaf),
then steps the optimizer on this rank's stages; the guard decides with
its squared norm summed over pp, so every stage skips or applies
together. The optimizer must be elementwise (SGD, Adam, AdamW): each
rank steps only its stages.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.common.tree import jax_key
from horovod_tpu_torch.ops.reduce_op import Average, ReduceOp

log = get_logger()


def _pipeline_metrics(plan) -> None:
    """The locked parallelism layout on the registry (the JAX package's
    ``hvd_pipeline_*`` gauges)."""
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        from horovod_tpu_torch.parallel.plan import SCHEDULES
        reg = default_registry()
        reg.gauge("hvd_pipeline_stages",
                  help="pipeline depth (pp mesh axis) of the active "
                       "train step").set(float(plan.pp))
        reg.gauge("hvd_pipeline_virtual_stages",
                  help="virtual stage chunks per device (interleaved "
                       "schedule)").set(float(plan.virtual_stages))
        reg.gauge("hvd_pipeline_microbatches",
                  help="microbatches per step of the active pipeline "
                       "plan").set(float(plan.n_microbatches))
        reg.gauge("hvd_pipeline_bubble_fraction",
                  help="analytic fill+drain bubble fraction of the "
                       "active schedule").set(plan.bubble_fraction())
        for s in SCHEDULES:
            reg.gauge("hvd_pipeline_schedule",
                      help="active pipeline schedule (1 on the locked "
                           "schedule's series)",
                      labels={"schedule": s}).set(
                1.0 if s == plan.schedule else 0.0)
    except Exception:   # metrics are telemetry, never a step failure
        log.debug("pipeline metrics unavailable", exc_info=True)


def record_measured_bubble(measured: float) -> None:
    """The measured bubble fraction of the active pipeline step, beside
    the analytic one: ``1 − t(pp = 1) / t(pp)``, with t(pp = 1) the step
    of the same model on a rank's share of the work (its dp share of the
    batch through every layer: the same compute as one stage's share of
    the pipeline), so what the pipelined step spends beyond it is bubble
    and transfer."""
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        default_registry().gauge(
            "hvd_pipeline_bubble_fraction_measured",
            help="measured bubble fraction of the active pipeline "
                 "step: 1 - compute-only (pp=1) step time / pipelined "
                 "step time").set(
            max(0.0, min(1.0, float(measured))))
    except Exception:
        log.debug("measured-bubble gauge unavailable", exc_info=True)


def stage_layout_permutation(n_layers: int, pp: int,
                             virtual_stages: int = 1) -> np.ndarray:
    """Natural-layer-order -> storage-order permutation for a pp x v
    split. Storage is device-major (device d's chunks contiguous) so a
    contiguous block over ``pp`` hands every pipeline rank its own stages;
    for ``v == 1`` this is the identity. ``perm[i]`` is the natural index
    stored at slot ``i``."""
    if n_layers % (pp * virtual_stages) != 0:
        raise ValueError(
            f"{n_layers} layers not divisible into pp={pp} x "
            f"v={virtual_stages} stages")
    per_stage = n_layers // (pp * virtual_stages)
    order = []
    for d in range(pp):
        for j in range(virtual_stages):
            q = j * pp + d        # semantic stage of chunk j on device d
            order.extend(range(q * per_stage, (q + 1) * per_stage))
    return np.asarray(order, np.int64)


def _names(tree: Mapping):
    return sorted(tree, key=lambda k: jax_key(str(k)))


class PipelineTrainStep:
    """``step(params, optimizer, batch) -> (params, optimizer, loss)`` with
    the plan's layout captured; ``prepare_params``/``restore_params``
    convert between the natural-order tree and this rank's block of the
    storage order (module docstring)."""

    def __init__(self, fn: Callable, plan, mesh, perm: np.ndarray,
                 device) -> None:
        self._fn = fn
        self.plan = plan
        self.mesh = mesh
        self._perm = perm
        self._inv = np.argsort(perm)
        self.device = device

    @property
    def _pp(self):
        return self.mesh.axis("pp")

    def prepare_params(self, tree: Mapping) -> torch.nn.ParameterDict:
        """The natural-order tree (leaves ``[n_layers, ...]``, tensors or
        arrays) → this rank's stages in storage order, as trainable
        parameters on the step's device."""
        L = len(self._perm)
        pp = self._pp
        n = L // pp.size
        rows = torch.from_numpy(self._perm[pp.index * n:(pp.index + 1) * n])
        out = {}
        for k in _names(tree):
            t = torch.as_tensor(np.asarray(tree[k])) if not isinstance(
                tree[k], torch.Tensor) else tree[k].detach()
            if t.shape[0] != L:
                raise ValueError(f"leaf {k} has leading dim {t.shape[0]}, "
                                 f"the model has {L} layers")
            out[k] = torch.nn.Parameter(
                t.index_select(0, rows.to(t.device)).to(self.device).clone())
        return torch.nn.ParameterDict(out)

    def restore_params(self, params: Mapping) -> Dict[str, torch.Tensor]:
        """This rank's stages (storage order) → the whole natural-order
        tree on every rank: the blocks gathered over pp, the storage
        permutation undone (values bit for bit)."""
        from horovod_tpu_torch.ops.mesh_collectives import pallgather
        pp = self._pp
        inv = torch.from_numpy(self._inv)
        out = {}
        for k in _names(params):
            t = params[k].detach()
            full = pallgather(t.contiguous(), pp) if pp.size > 1 else t
            out[k] = full.index_select(0, inv.to(full.device))
        return out

    def __call__(self, params, optimizer, batch):
        return self._fn(params, optimizer, batch)

    def __getattr__(self, name):
        # the pp == 1 path wraps a guarded overlap step: its surface
        # (flush(), skipped, guard_spec) stays reachable
        fn = self.__dict__.get("_fn")
        if fn is None or name.startswith("__"):
            raise AttributeError(name)
        return getattr(fn, name)


def _apply_layers(layer_fn, leaves: Mapping, h, n_layers: int):
    for i in range(n_layers):
        h = layer_fn({n: leaf[i] for n, leaf in leaves.items()}, h)
    return h


def make_pipeline_train_step(layer_fn: Callable, loss_fn: Callable,
                             plan=None, *, n_layers: int, mesh=None,
                             schedule: str = "1f1b",
                             pp: Optional[int] = None, n_micro: int = 1,
                             virtual_stages: int = 1,
                             op: ReduceOp = Average,
                             dp_sync: str = "bucketed",
                             bucket_bytes: Optional[int] = None,
                             compression=None,
                             algorithm: Optional[str] = None,
                             topology=None,
                             small_floor: Optional[int] = None,
                             device=None, autotune=None,
                             guard=None) -> PipelineTrainStep:
    """Build the composed dp x pp train step for a layer-major model
    (module docstring). Pass a :class:`~horovod_tpu_torch.parallel.plan.
    ParallelPlan` (``plan=``, optionally with a nested comms plan) or the
    knobs (``schedule``/``pp``/``n_micro``/``virtual_stages`` and the
    ``bucketed_grad_sync`` communication kwargs). ``pp == 1`` degenerates
    into :func:`~horovod_tpu_torch.train.overlap.make_overlap_train_step`
    (microbatch accumulation, bucket overlap, guard). ``autotune`` (or
    ``HVD_TPU_AUTOTUNE_MESH=1``) hands the layout and the communication
    knobs to the parallel-plan search
    (:func:`~horovod_tpu_torch.train.autotune.make_parallel_train_step`);
    an explicit ``plan=`` pins the layout. ``device=None`` puts the
    parameters on this process's card and raises without one;
    ``device="cpu"`` runs on the CPU. ``guard`` as for the overlap step
    (default on)."""
    from horovod_tpu_torch.common.basics import resolve_device, size
    from horovod_tpu_torch.parallel.mesh import mesh_axis_size
    from horovod_tpu_torch.parallel.plan import ParallelPlan

    if dp_sync not in ("bucketed", "dense"):
        raise ValueError(f"dp_sync must be 'bucketed' or 'dense', got "
                         f"{dp_sync!r}")
    if autotune is None:
        from horovod_tpu_torch.common.config import get_config
        autotune = get_config().autotune_mesh or None
    if autotune and plan is None:
        from horovod_tpu_torch.train.autotune import make_parallel_train_step
        return make_parallel_train_step(
            layer_fn, loss_fn, n_layers=n_layers, autotune=autotune, op=op,
            device=device, guard=guard)

    if plan is None:
        world = math.prod(mesh.shape.values()) if mesh is not None \
            else size()
        pp_ = pp if pp is not None else (
            mesh_axis_size(mesh, "pp") if mesh is not None else 1)
        if world % pp_ != 0:
            raise ValueError(
                f"pp={pp_} does not divide the {world}-device world")
        comms = None
        if bucket_bytes is not None or algorithm is not None \
                or compression is not None or small_floor is not None:
            from horovod_tpu_torch.train.autotune import Plan, _codec_name
            from horovod_tpu_torch.train.buckets import resolve_bucket_bytes
            from horovod_tpu_torch.train.overlap import resolve_small_floor
            comms = Plan(bucket_bytes=resolve_bucket_bytes(bucket_bytes),
                         algorithm=algorithm or "psum",
                         codec=_codec_name(compression),
                         small_floor=resolve_small_floor(small_floor))
        plan = ParallelPlan(
            dp=max(1, world // pp_), pp=pp_,
            schedule=schedule if pp_ > 1 else "1f1b",
            n_microbatches=n_micro,
            virtual_stages=virtual_stages
            if (pp_ > 1 and schedule == "interleaved") else 1,
            comms=comms)
    if mesh is None:
        mesh = plan.build_mesh()
    plan.validate_for(math.prod(mesh.shape.values()), n_layers=n_layers)
    if mesh_axis_size(mesh, "pp") != plan.pp:
        raise ValueError(
            f"mesh pp axis is {mesh_axis_size(mesh, 'pp')} but the plan "
            f"wants pp={plan.pp}; build the mesh with dp_pp_mesh or "
            f"plan.build_mesh()")
    dev = resolve_device(device)

    if compression is None and plan.comms is not None:
        compression = plan.comms.resolve_codec()
    comm_kwargs = dict(
        bucket_bytes=plan.comms.bucket_bytes if plan.comms else bucket_bytes,
        compression=compression,
        algorithm=(plan.comms.algorithm if plan.comms else algorithm),
        topology=topology,
        small_floor=(plan.comms.small_floor if plan.comms else small_floor))

    _pipeline_metrics(plan)

    if plan.pp == 1:
        from horovod_tpu_torch.train.overlap import make_overlap_train_step

        def full_loss(params, batch):
            x, tgt = batch
            return loss_fn(_apply_layers(layer_fn, params, x, n_layers), tgt)

        inner = make_overlap_train_step(
            full_loss, mesh, "dp", n_micro=plan.n_microbatches, op=op,
            autotune=False, guard=guard, **comm_kwargs)
        return PipelineTrainStep(inner, plan, mesh, np.arange(n_layers), dev)

    from horovod_tpu_torch.ops.mesh_collectives import preduce
    from horovod_tpu_torch.parallel.pipeline import (Units, make_schedule,
                                                     run_schedule)
    from horovod_tpu_torch.parallel.plan import compile_step_with_plan
    from horovod_tpu_torch.train.guard import (GuardedStep, guarded_apply,
                                               resolve_spec)
    from horovod_tpu_torch.train.overlap import bucketed_grad_sync

    perm = stage_layout_permutation(n_layers, plan.pp, plan.virtual_stages)
    gspec = resolve_spec(guard)
    S, M, v = plan.pp, plan.n_microbatches, plan.virtual_stages
    per_chunk = n_layers // (S * v)
    sched = make_schedule(plan.schedule, S, M, v)
    pp_axis = mesh.axis("pp")
    dp_axis = mesh.axis("dp") if mesh_axis_size(mesh, "dp") > 1 else None

    def body(params, optimizer, batch):
        x, tgt = batch
        if x.shape[0] % M:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {M} microbatches")
        xm = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        tm = tgt.reshape((M, tgt.shape[0] // M) + tuple(tgt.shape[1:]))
        names = _names(params)
        leaves = [params[k] for k in names]
        chunks = [[p[j * per_chunk:(j + 1) * per_chunk] for p in leaves]
                  for j in range(v)]

        def chunk_fn(j, h, params):
            return (_apply_layers(layer_fn, dict(zip(names, params)), h,
                                  per_chunk),)

        units = Units(chunk_fn, chunks, lambda m: (xm[m],),
                      loss=lambda m, ys: loss_fn(ys[0], tm[m]))
        run_schedule(sched, pp_axis, units, [(tuple(xm.shape[1:]), x.dtype)],
                     x.device)
        local = (torch.stack(units.losses).sum() if units.losses
                 else torch.zeros((), device=x.device))
        loss = preduce(local, pp_axis) / M
        grads = {}
        for i, k in enumerate(names):
            parts = [units.grads[j][i] if units.grads[j][i] is not None
                     else torch.zeros_like(chunks[j][i]) for j in range(v)]
            grads[k] = (torch.cat(parts) if v > 1 else parts[0]) / M
        if dp_axis is not None:
            if dp_sync == "dense":
                grads = {k: preduce(g, dp_axis, op) for k, g in grads.items()}
            else:
                grads = bucketed_grad_sync(grads, dp_axis, op=op,
                                           **comm_kwargs)
            loss = preduce(loss, dp_axis, Average)
        for k in names:
            params[k].grad = grads[k]
        if gspec.enabled:
            ok = guarded_apply(optimizer, gspec, pp_axis=pp_axis)
        else:
            optimizer.step()
            ok = True
        return params, optimizer, loss, ok

    body.__name__ = f"pipeline_body[{plan.key}]"
    bound = compile_step_with_plan(body, mesh, plan)
    if gspec.enabled:
        fn = GuardedStep(bound, gspec, canary_axis=mesh.axis("dp"))
    else:
        def fn(params, optimizer, batch):
            return bound(params, optimizer, batch)[:3]
    return PipelineTrainStep(fn, plan, mesh, perm, dev)
