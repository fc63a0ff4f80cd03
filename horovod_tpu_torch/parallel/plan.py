"""Unified parallelism plan: how a layer-major model runs on a world, as a
frozen, cacheable object.

Mirrors ``horovod_tpu/parallel/plan.py``: :class:`ParallelPlan` fixes the
dp x pp split, the pipeline schedule (GPipe / 1F1B / interleaved 1F1B with
``virtual_stages`` chunks per rank), the microbatch count, and nests a
communication plan (:class:`~horovod_tpu_torch.train.autotune.Plan`) for
the dp gradient traffic; :func:`plan_from_dict` revives either kind from
the plan cache. The validation, ``key``, ``to_dict`` layout and analytic
bubble are the JAX package's, so a plan written by either package loads
in the other.

:func:`compile_step_with_plan` is the one seam that binds a step body to
its mesh. The JAX seam compiles (``jit`` with shardings, ``shard_map``
for map-style bodies, or a mesh-scoped ``jit``); eager PyTorch compiles
nothing, so here the seam checks the plan against the mesh (the world it
tiles, its pp axis) once, when it is bound, and the returned step runs
the body as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

SCHEDULES: Tuple[str, ...] = ("gpipe", "1f1b", "interleaved")


def _comm_plan_cls():
    from horovod_tpu_torch.train.autotune import Plan
    return Plan


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """One point in the parallelism search space.

    ``dp`` x ``pp`` must multiply to the world the plan is bound to.
    ``schedule``: ``gpipe`` (all forwards, then all backwards: every
    microbatch's graph held at once), ``1f1b`` (at most ``pp − s`` graphs
    held on stage ``s``), ``interleaved`` (1F1B with ``virtual_stages``
    chunks per rank: a ``~1/v`` smaller fill/drain bubble at the same
    ``M``). ``comms`` is the nested communication
    :class:`~horovod_tpu_torch.train.autotune.Plan` for the dp gradient
    reduction (None = dense defaults)."""

    dp: int = 1
    pp: int = 1
    schedule: str = "1f1b"
    n_microbatches: int = 1
    virtual_stages: int = 1
    comms: Optional[Any] = None

    def __post_init__(self):
        if self.dp < 1 or self.pp < 1:
            raise ValueError(
                f"dp and pp must be >= 1, got dp={self.dp} pp={self.pp}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULES}")
        if self.n_microbatches < 1:
            raise ValueError("n_microbatches must be >= 1")
        if self.virtual_stages < 1:
            raise ValueError("virtual_stages must be >= 1")
        if self.virtual_stages > 1 and self.schedule != "interleaved":
            raise ValueError(
                f"virtual_stages={self.virtual_stages} only makes sense "
                f"for the interleaved schedule, not {self.schedule!r}")
        if self.pp > 1 and self.n_microbatches < 2:
            raise ValueError(
                "a pipeline (pp > 1) needs n_microbatches >= 2 — with one "
                "microbatch every schedule is pure bubble")
        if self.comms is not None and not hasattr(self.comms, "step_kwargs"):
            raise ValueError(
                f"comms must be a communication Plan (train.autotune.Plan), "
                f"got {self.comms!r}")

    # -- identity -----------------------------------------------------------

    @property
    def world(self) -> int:
        return self.dp * self.pp

    @property
    def total_stages(self) -> int:
        return self.pp * self.virtual_stages

    @property
    def key(self) -> str:
        """Short human label (CSV / flight / metric labels)."""
        base = f"dp{self.dp}xpp{self.pp}/{self.schedule}"
        if self.schedule == "interleaved":
            base += f"v{self.virtual_stages}"
        base += f"/m{self.n_microbatches}"
        if self.comms is not None:
            base += f"[{self.comms.key}]"
        return base

    # the communication-plan facade the autotune controller, its CSV trace
    # and the locked-plan gauges read off any plan they score
    @property
    def bucket_bytes(self) -> int:
        return self.comms.bucket_bytes if self.comms is not None else 0

    @property
    def algorithm(self) -> str:
        return self.comms.algorithm if self.comms is not None else "psum"

    @property
    def codec(self) -> str:
        return self.comms.codec if self.comms is not None else "none"

    @property
    def small_floor(self) -> int:
        return self.comms.small_floor if self.comms is not None else 0

    # -- serialization (plan cache) -----------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": "parallel", "dp": self.dp, "pp": self.pp,
             "schedule": self.schedule,
             "n_microbatches": self.n_microbatches,
             "virtual_stages": self.virtual_stages}
        if self.comms is not None:
            d["comms"] = self.comms.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParallelPlan":
        comms = d.get("comms")
        return cls(dp=int(d["dp"]), pp=int(d["pp"]),
                   schedule=str(d.get("schedule", "1f1b")),
                   n_microbatches=int(d.get("n_microbatches", 1)),
                   virtual_stages=int(d.get("virtual_stages", 1)),
                   comms=_comm_plan_cls().from_dict(comms)
                   if comms is not None else None)

    # -- analytics / binding ------------------------------------------------

    def bubble_fraction(self) -> float:
        """Analytic fill+drain bubble fraction of this plan's schedule
        (0.0 when pp == 1)."""
        from horovod_tpu_torch.parallel.pipeline import bubble_fraction
        return bubble_fraction(self.schedule, self.pp,
                               self.n_microbatches, self.virtual_stages)

    def build_mesh(self):
        """This plan's dp x pp mesh over the world
        (:func:`~horovod_tpu_torch.parallel.mesh.dp_pp_mesh`; collective)."""
        from horovod_tpu_torch.parallel.mesh import dp_pp_mesh
        return dp_pp_mesh(dp=self.dp, pp=self.pp)

    def validate_for(self, n_devices: int, n_layers: Optional[int] = None,
                     batch_per_replica: Optional[int] = None) -> None:
        """Bind-time checks: the plan must tile ``n_devices`` (ranks)
        exactly; ``n_layers`` (when known) must split into
        ``total_stages`` equal chunks; the per-replica batch must split
        into microbatches."""
        if self.world != n_devices:
            raise ValueError(
                f"plan {self.key} needs dp*pp == {self.world} devices, "
                f"have {n_devices}")
        if n_layers is not None and n_layers % self.total_stages != 0:
            raise ValueError(
                f"{n_layers} layers not divisible into "
                f"{self.total_stages} stages (pp={self.pp} x "
                f"v={self.virtual_stages})")
        if batch_per_replica is not None \
                and batch_per_replica % self.n_microbatches != 0:
            raise ValueError(
                f"per-replica batch {batch_per_replica} not divisible by "
                f"{self.n_microbatches} microbatches")


def plan_from_dict(d: Dict[str, Any]):
    """Revive a plan of either kind from its cache dict: a
    :class:`ParallelPlan` when the doc says so (``kind`` tag or pipeline
    fields), else a communication
    :class:`~horovod_tpu_torch.train.autotune.Plan`."""
    if d.get("kind") == "parallel" or "schedule" in d:
        return ParallelPlan.from_dict(d)
    return _comm_plan_cls().from_dict(d)


def compile_step_with_plan(step_fn: Callable, mesh,
                           plan: Optional[ParallelPlan] = None) -> Callable:
    """Bind ``step_fn`` to ``mesh`` under ``plan``, the one seam every
    pipeline step goes through. The JAX seam picks how to compile (pjit,
    shard_map or a plain jit); PyTorch compiles nothing, so this seam
    checks, once, that the plan tiles the mesh (``dp·pp`` ranks, the
    mesh's pp axis the plan's) and returns a step that runs ``step_fn``
    eagerly, named after the plan."""
    if mesh is not None:
        world = math.prod(mesh.shape.values())
        if plan is not None:
            plan.validate_for(world)
            if mesh.shape.get("pp", 1) != plan.pp:
                raise ValueError(
                    f"mesh pp axis is {mesh.shape.get('pp', 1)} but the plan "
                    f"wants pp={plan.pp}; build the mesh with dp_pp_mesh or "
                    f"plan.build_mesh()")

    def bound(*args, **kwargs):
        return step_fn(*args, **kwargs)

    bound.__name__ = getattr(step_fn, "__name__", "step")
    bound.plan, bound.mesh = plan, mesh
    return bound
