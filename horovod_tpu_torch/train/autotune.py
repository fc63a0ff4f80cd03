"""Mesh-path plan search: successive halving over candidate plans, scored
by measured step time, with a persistent tuning cache.

Mirrors ``horovod_tpu/train/autotune.py``: :class:`Plan` (bucket bytes x
algorithm {psum, ring, hier} x codec {none, int8, fp8} x small-bucket
floor), ``candidate_plans``, ``topology_key``, ``plan_fingerprint`` (the
same document, so the same fingerprint for the same tree, world and
codecs), :class:`PlanCache` (one JSON file a fingerprint; a load never
raises), ``invalidate_plan_cache``, :class:`AutotuneController` (its CSV
trace and the ``hvd_autotune_*`` metrics), :class:`AutotuneOptions`,
:class:`AutotunedStep` and ``make_autotuned_train_step`` (the
``autotune=`` seam of ``make_overlap_train_step``), and the parallelism
search: ``parallel_candidate_plans``, :class:`ParallelAutotunedStep` and
``make_parallel_train_step`` (the ``autotune=`` seam of
``make_pipeline_train_step``).

What differs from the JAX package: it runs one program over all devices,
here every rank runs the search, so each measured step time is the
maximum over the world (one small allreduce a searched step) and every
rank takes the same decisions; the step is timed after
``torch.cuda.synchronize()`` where the JAX step blocks on its result, and
the clock is injectable (``AutotuneOptions.clock``). A torch optimizer is
bound to its parameter tensors, so the parallel search keeps the caller's
parameters whole and in natural layer order on every rank: a candidate
layout runs on a copy of them in its own storage order, its gradients are
gathered back into the natural order, and the caller's optimizer steps
(elementwise optimizers give every rank the same update, as each stage's
optimizer would). Once locked, :meth:`ParallelAutotunedStep.pin` returns
the winner's own :class:`~horovod_tpu_torch.train.pipeline.
PipelineTrainStep` for steady state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.common.logging import get_logger

log = get_logger()

PLAN_CACHE_VERSION = 2   # v2: the cache may hold a ParallelPlan
_ALGORITHMS = ("psum", "ring", "hier")
_CODECS = ("none", "int8", "fp8")
DEFAULT_SMALL_FLOOR = 32 * 1024  # latency-path floor candidate (bytes)


# ---------------------------------------------------------------------------
# Plan: one point in the search space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """One communication configuration of the dp gradient sync.

    ``algorithm``: ``psum`` (flat), ``ring`` (chunked point-to-point), or
    ``hier`` (two-level). ``codec``: ``none``/``int8``/``fp8``, applied
    EQuARX-style (the gather phase of psum, the inter-host hop of hier;
    ring has no codec seam). ``small_floor``: buckets under this many
    bytes take the dense latency path."""

    bucket_bytes: int
    algorithm: str = "psum"
    codec: str = "none"
    small_floor: int = 0

    def __post_init__(self):
        if self.algorithm not in _ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; "
                             f"expected one of {_ALGORITHMS}")
        if self.codec not in _CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; "
                             f"expected one of {_CODECS}")
        if self.algorithm == "ring" and self.codec != "none":
            raise ValueError("ring has no compression seam")
        if self.bucket_bytes < 1:
            raise ValueError("bucket_bytes must be >= 1")
        if self.small_floor < 0:
            raise ValueError("small_floor must be >= 0")

    @property
    def key(self) -> str:
        """Short human label (CSV / flight / metric labels)."""
        return (f"{self.algorithm}/{self.codec}"
                f"/b{self.bucket_bytes}/f{self.small_floor}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Plan":
        return cls(bucket_bytes=int(d["bucket_bytes"]),
                   algorithm=str(d.get("algorithm", "psum")),
                   codec=str(d.get("codec", "none")),
                   small_floor=int(d.get("small_floor", 0)))

    def resolve_codec(self):
        """The codec string as a live quantizer (None for ``none``)."""
        if self.codec == "none":
            return None
        from horovod_tpu_torch.compression.quantizers import \
            resolve_compressor
        return resolve_compressor(self.codec)

    def step_kwargs(self, topology=None) -> Dict[str, Any]:
        """Keyword arguments for ``make_overlap_train_step`` /
        ``bucketed_grad_sync`` realizing this plan."""
        return dict(bucket_bytes=self.bucket_bytes,
                    algorithm=self.algorithm,
                    compression=self.resolve_codec(),
                    small_floor=self.small_floor,
                    topology=topology)


def _codec_name(compression) -> str:
    if compression is None:
        return "none"
    name = getattr(compression, "name", None)
    if name not in _CODECS:
        raise ValueError(
            f"autotune searches codecs {_CODECS}; got compression="
            f"{compression!r} — drop autotune= or pass a supported codec")
    return name


def _codecs_available() -> Tuple[str, ...]:
    from horovod_tpu_torch.compression.quantizers import fp8_supported
    return ("none", "int8") + (("fp8",) if fp8_supported() else ())


def candidate_plans(topology=None, *, baseline: Optional[Plan] = None,
                    include_fp8: bool = False) -> List[Plan]:
    """The default discrete search space, most promising first (the
    controller trims the tail when the budget cannot score them all). Floor
    variants only where the floor changes the plan (a codec or a non-flat
    algorithm)."""
    from horovod_tpu_torch.train.buckets import resolve_bucket_bytes
    hier_ok = topology is not None and topology.is_hierarchical
    combos: List[Tuple[str, str]] = [("psum", "none"), ("psum", "int8")]
    if hier_ok:
        combos += [("hier", "none"), ("hier", "int8")]
    combos.append(("ring", "none"))
    if include_fp8 and "fp8" in _codecs_available():
        combos.append(("psum", "fp8"))
        if hier_ok:
            combos.append(("hier", "fp8"))
    default_bucket = resolve_bucket_bytes(None)
    buckets = []
    for b in (default_bucket, 1 << 20):
        if b not in buckets:
            buckets.append(b)
    plans: List[Plan] = []
    if baseline is not None:
        plans.append(baseline)
    for bucket in buckets:
        for algo, codec in combos:
            plans.append(Plan(bucket, algo, codec, 0))
    for bucket in buckets:
        for algo, codec in combos:
            if algo == "psum" and codec == "none":
                continue  # the floor is a no-op on the dense flat path
            plans.append(Plan(bucket, algo, codec, DEFAULT_SMALL_FLOOR))
    return list(dict.fromkeys(plans))


# ---------------------------------------------------------------------------
# Fingerprint + persistent plan cache
# ---------------------------------------------------------------------------

def topology_key(topology, pp: int = 1) -> Dict[str, int]:
    """The mesh component of the cache fingerprint: the reduction's width
    and its (hosts x local) structure, without the axis name, and the pp
    size the plan was tuned under (``pp=0``: the dp x pp split is itself
    searched, keyed by the whole world), so communication and
    parallelism entries of one model never shadow each other."""
    return {"world": int(topology.world),
            "hosts": int(topology.num_hosts),
            "local": int(topology.local_size),
            "pp": int(pp)}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tree_leaves(tree) -> list:
    """The leaves of a module (its trainable parameters), a tensor, or
    tensors in lists and nested mappings, in JAX's flatten order."""
    if isinstance(tree, torch.nn.Module):
        from horovod_tpu_torch.train.overlap import jax_ordered_parameters
        return jax_ordered_parameters(tree)[1]
    from horovod_tpu_torch.common.tree import tree_flatten
    return tree_flatten(tree)[0]


def plan_fingerprint(tree, mesh_shape: Dict[str, int], world: int,
                     dtype: Optional[str] = None) -> str:
    """Cache key of a tuned plan: sha256 over what changes which plan
    wins, the JAX package's document: the gradient tree's structure (leaf
    shapes and dtypes in JAX flatten order), the topology key
    (:func:`topology_key`), the world size, the compute dtype and the
    codecs this build can run."""
    import numpy as np
    struct = [[[int(d) for d in (leaf.shape if hasattr(leaf, "shape")
                                  else np.shape(leaf))],
               _dtype_name(leaf.dtype if hasattr(leaf, "dtype")
                           else np.asarray(leaf).dtype)]
              for leaf in _tree_leaves(tree)]
    doc = {
        "v": PLAN_CACHE_VERSION,
        "tree": struct,
        "mesh": sorted((str(k), int(v)) for k, v in mesh_shape.items()),
        "world": int(world),
        "dtype": dtype or (struct[0][1] if struct else "none"),
        "codecs": list(_codecs_available()),
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def resolve_cache_dir(cache_dir: Optional[str] = None) -> str:
    """Explicit argument > ``HVD_TPU_AUTOTUNE_CACHE_DIR``. Empty: no
    persistence (the search still runs)."""
    if cache_dir is not None:
        return cache_dir
    from horovod_tpu_torch.common.config import get_config
    return get_config().autotune_cache_dir


class PlanCache:
    """Fingerprint-keyed JSON plan store (one small file a fingerprint).
    Load never raises: a corrupt file, a fingerprint mismatch or an
    unreadable plan logs a warning and returns None (a retune, not a
    crash)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory

    def path(self, fingerprint: str) -> str:
        return os.path.join(self.directory,
                            f"plan_{fingerprint[:32]}.json")

    def load(self, fingerprint: str):
        if not self.directory:
            return None
        path = self.path(fingerprint)
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            log.warning("autotune plan cache %s unreadable (%s); "
                        "retuning", path, e)
            return None
        try:
            if doc.get("version") != PLAN_CACHE_VERSION:
                log.warning(
                    "autotune plan cache %s has spec version %r (want "
                    "%d); retuning", path, doc.get("version"),
                    PLAN_CACHE_VERSION)
                return None
            if doc.get("fingerprint") != fingerprint:
                log.warning(
                    "autotune plan cache %s fingerprint mismatch "
                    "(stale entry for a different tree/mesh/world); "
                    "retuning", path)
                return None
            from horovod_tpu_torch.parallel.plan import plan_from_dict
            return plan_from_dict(doc["plan"])
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            log.warning("autotune plan cache %s carries an invalid "
                        "plan (%s); retuning", path, e)
            return None

    def invalidate(self, fingerprint: Optional[str] = None) -> int:
        """Drop one cached plan (or every plan of the directory); returns
        how many entries were removed. Never raises."""
        if not self.directory:
            return 0
        if fingerprint is not None:
            try:
                os.remove(self.path(fingerprint))
                return 1
            except OSError:
                return 0
        removed = 0
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        for name in names:
            if name.startswith("plan_") and name.endswith(".json"):
                try:
                    os.remove(os.path.join(self.directory, name))
                    removed += 1
                except OSError:
                    pass
        return removed

    def store(self, fingerprint: str, plan,
              meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Atomic write (tmp + rename); a failure logs and returns None."""
        if not self.directory:
            return None
        doc = {"version": PLAN_CACHE_VERSION,
               "fingerprint": fingerprint,
               "plan": plan.to_dict(),
               "meta": meta or {}}
        path = self.path(fingerprint)
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            return path
        except OSError as e:
            log.warning("autotune plan cache write failed (%s); the "
                        "tuned plan will not survive this process", e)
            return None


def invalidate_plan_cache(cache_dir: Optional[str] = None) -> int:
    """Drop every persisted plan under the resolved cache directory;
    returns the number of entries removed (0 when persistence is off)."""
    directory = resolve_cache_dir(cache_dir)
    removed = PlanCache(directory).invalidate()
    if removed:
        log.warning("autotune plan cache invalidated: %d entr%s removed "
                    "from %s", removed, "y" if removed == 1 else "ies",
                    directory)
    return removed


# ---------------------------------------------------------------------------
# Online search: successive halving over measured step time
# ---------------------------------------------------------------------------

def _autotune_metrics():
    from horovod_tpu_torch.metrics.registry import default_registry
    return default_registry()


def _record_locked_plan(plan, best_s: Optional[float], from_cache: bool,
                        trials: int) -> None:
    reg = _autotune_metrics()
    reg.gauge("hvd_autotune_locked",
              help="1 once the mesh autotuner locked a plan").set(1.0)
    reg.gauge("hvd_autotune_plan_bucket_bytes",
              help="bucket byte budget of the locked plan"
              ).set(float(plan.bucket_bytes))
    reg.gauge("hvd_autotune_plan_small_floor_bytes",
              help="small-bucket latency floor of the locked plan"
              ).set(float(plan.small_floor))
    # exactly one combination reads 1, a re-lock zeroes the others
    for algo in _ALGORITHMS:
        for codec in _CODECS:
            reg.gauge("hvd_autotune_plan",
                      help="locked plan identity (1 on the active "
                           "algorithm/codec combination)",
                      labels={"algorithm": algo, "codec": codec}).set(
                1.0 if (algo, codec) == (plan.algorithm, plan.codec)
                else 0.0)
    if best_s is not None:
        reg.gauge("hvd_autotune_best_step_seconds",
                  help="measured step seconds of the locked plan"
                  ).set(best_s)
    if hasattr(plan, "schedule"):
        from horovod_tpu_torch.train.pipeline import _pipeline_metrics
        _pipeline_metrics(plan)
    if from_cache:
        reg.counter("hvd_autotune_cache_hits_total",
                    help="runs that started from a cached tuned plan "
                         "with zero search trials").inc()
    from horovod_tpu_torch.diagnostics.flight_recorder import record_event
    record_event("autotune_locked", plan=plan.key,
                 from_cache=from_cache, trials=trials,
                 best_step_s=best_s)


class AutotuneController:
    """Budget-bounded successive halving over candidate plans.

    ``begin_step()`` names the plan to run, ``end_step(seconds)`` (or
    :meth:`observe`) scores it. The first step a plan runs in a round is
    a warm-up and is never scored. When one survivor remains, or
    ``budget_steps`` search steps are spent, the best plan locks:
    ``locked_plan`` is set, metrics, flight recorder and CSV trace record
    it, and the cache (when configured) is written, so the next run starts
    locked with zero trials. A plan's score is the minimum over its
    window (contention only adds time)."""

    def __init__(self, plans: Sequence, *,
                 budget_steps: Optional[int] = None,
                 steps_per_trial: int = 2,
                 log_path: Optional[str] = None,
                 cache: Optional[PlanCache] = None,
                 fingerprint: Optional[str] = None) -> None:
        if not plans:
            raise ValueError("need at least one candidate plan")
        if budget_steps is None:
            from horovod_tpu_torch.common.config import get_config
            budget_steps = get_config().autotune_budget_steps
        self.budget_steps = max(1, int(budget_steps))
        self.steps_per_trial = max(1, int(steps_per_trial))
        self.cache = cache
        self.fingerprint = fingerprint
        self._log_path = log_path
        self._log_header_written = False
        per_plan = 1 + self.steps_per_trial
        max_plans = max(1, self.budget_steps // per_plan)
        plans = list(dict.fromkeys(plans))
        if len(plans) > max_plans:
            dropped = plans[max_plans:]
            log.warning(
                "autotune budget %d steps fits %d of %d candidate "
                "plans (%d steps each); dropping: %s",
                self.budget_steps, max_plans, len(plans), per_plan,
                ", ".join(p.key for p in dropped))
            plans = plans[:max_plans]
        self._survivors: List = plans
        self._round = 0
        self._trial_steps = self.steps_per_trial
        self._scores: Dict[Any, float] = {}
        self._samples: List[float] = []
        self._plan_idx = 0
        self._step_in_plan = 0
        self.steps_used = 0
        self.trials = 0
        self.from_cache = False
        self.locked_plan = None
        self.best_seconds: Optional[float] = None
        self._pending = None

    def try_cache(self) -> bool:
        """Adopt the cached plan of this controller's fingerprint; True
        when warm (zero trials will run)."""
        if self.cache is None or not self.fingerprint:
            return False
        plan = self.cache.load(self.fingerprint)
        if plan is None:
            return False
        self.from_cache = True
        self._lock(plan, best=None)
        log.info("autotune: warm plan cache hit — locked %s with zero "
                 "search trials", plan.key)
        return True

    @property
    def done(self) -> bool:
        return self.locked_plan is not None

    def begin_step(self):
        """The plan the next training step should run."""
        if self.locked_plan is not None:
            return self.locked_plan
        self._pending = self._survivors[self._plan_idx]
        return self._pending

    def end_step(self, seconds: float) -> None:
        """Score the step issued by the last ``begin_step``."""
        if self.locked_plan is not None:
            return
        plan = self._pending
        if plan is None:
            return
        self._pending = None
        self.steps_used += 1
        warmup = self._step_in_plan == 0
        self._step_in_plan += 1
        if not warmup:
            self._samples.append(float(seconds))
            self.trials += 1
            reg = _autotune_metrics()
            reg.counter("hvd_autotune_trials_total",
                        help="scored mesh-autotune trial steps").inc()
            reg.gauge("hvd_autotune_trial_step_seconds",
                      help="last scored trial step time",
                      labels={"plan": plan.key}).set(float(seconds))
            from horovod_tpu_torch.diagnostics.flight_recorder import \
                record_event
            record_event("autotune_trial", plan=plan.key,
                         round=self._round, step_s=round(seconds, 6))
        if self._step_in_plan >= 1 + self._trial_steps:
            if self._samples:
                score = min(self._samples)
                self._scores[plan] = score
                self._log_trial(plan, score)
            self._samples = []
            self._step_in_plan = 0
            self._plan_idx += 1
            if self._plan_idx >= len(self._survivors):
                self._finish_round()
        if self.locked_plan is None and self.steps_used >= self.budget_steps:
            self._lock_best("step budget exhausted")

    observe = end_step

    def _finish_round(self) -> None:
        scored = [p for p in self._survivors if p in self._scores]
        if not scored:
            self._lock_best("no scored plans")
            return
        scored.sort(key=lambda p: self._scores[p])
        keep = max(1, len(scored) // 2)
        if keep == 1 or self.steps_used >= self.budget_steps:
            self._lock(scored[0], best=self._scores[scored[0]])
            return
        self._survivors = scored[:keep]
        self._round += 1
        self._trial_steps *= 2
        self._plan_idx = 0
        self._step_in_plan = 0
        log.info("autotune round %d: %d survivors (best %s @ %.6fs)",
                 self._round, len(self._survivors), scored[0].key,
                 self._scores[scored[0]])

    def _lock_best(self, why: str) -> None:
        if self._scores:
            best = min(self._scores, key=self._scores.get)
            self._lock(best, best=self._scores[best])
        else:
            self._lock(self._survivors[0], best=None)
        log.info("autotune: locked %s (%s, %d scored trials, %d steps)",
                 self.locked_plan.key, why, self.trials, self.steps_used)

    def _lock(self, plan, best: Optional[float]) -> None:
        self.locked_plan = plan
        self.best_seconds = best
        _record_locked_plan(plan, best, self.from_cache, self.trials)
        self._log_trial(plan, best if best is not None else float("nan"),
                        final=True)
        if self.cache is not None and self.fingerprint \
                and not self.from_cache:
            self.cache.store(self.fingerprint, plan, meta={
                "best_step_seconds": best,
                "trials": self.trials,
                "steps_used": self.steps_used,
            })

    _CSV_HEADER = ("round,bucket_bytes,algorithm,codec,small_floor,"
                   "plan,step_s,final\n")

    def _log_trial(self, plan, score: float, final: bool = False) -> None:
        if not self._log_path:
            return
        try:
            # append-only; a trace written under an older column schema is
            # rotated to <path>.v1 first
            if not self._log_header_written \
                    and os.path.exists(self._log_path):
                with open(self._log_path) as f:
                    first = f.readline()
                if first and first != self._CSV_HEADER:
                    os.replace(self._log_path, self._log_path + ".v1")
                    log.info("autotune CSV trace %s used an older "
                             "schema; rotated to %s.v1",
                             self._log_path, self._log_path)
            with open(self._log_path, "a") as f:
                if not self._log_header_written:
                    if f.tell() == 0:
                        f.write(self._CSV_HEADER)
                    self._log_header_written = True
                f.write(f"{self._round},{plan.bucket_bytes},"
                        f"{plan.algorithm},{plan.codec},"
                        f"{plan.small_floor},{plan.key},{score:.6f},"
                        f"{1 if final else 0}\n")
        except OSError:
            pass  # the trace is advisory, never fatal


# ---------------------------------------------------------------------------
# The autotune= seam behind make_overlap_train_step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AutotuneOptions:
    """Configuration of the ``autotune=`` seams. ``True`` resolves to the
    env-driven defaults (``HVD_TPU_AUTOTUNE_BUDGET_STEPS``,
    ``HVD_TPU_AUTOTUNE_CACHE_DIR``, ``HVD_TPU_AUTOTUNE_LOG``). ``clock``
    times a searched step (default ``time.perf_counter``)."""

    budget_steps: Optional[int] = None
    steps_per_trial: int = 2
    cache_dir: Optional[str] = None
    log_path: Optional[str] = None
    plans: Optional[Sequence] = None
    include_fp8: bool = False
    clock: Optional[Callable[[], float]] = None

    @classmethod
    def resolve(cls, autotune) -> "AutotuneOptions":
        if isinstance(autotune, AutotuneOptions):
            return autotune
        if autotune is True or autotune is None:
            return cls()
        if isinstance(autotune, Plan):
            return cls(plans=[autotune], budget_steps=1)
        raise TypeError(
            f"autotune= takes True, AutotuneOptions or Plan; got "
            f"{autotune!r}")

    def resolved_log_path(self) -> str:
        if self.log_path is not None:
            return self.log_path
        from horovod_tpu_torch.common.config import get_config
        base = get_config().autotune_log
        return (base + ".mesh.csv") if base else ""


def _settled_seconds(t0: float, clock, tensors) -> float:
    """Seconds since ``t0`` once the step's work is done (its card work
    synchronized), the maximum over the world so every rank scores the
    same number."""
    import torch.distributed as dist
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    seconds = clock() - t0
    if dist.is_initialized() and dist.get_world_size() > 1:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([seconds], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        seconds = float(t)
    return seconds


class AutotunedStep:
    """A train step that searches, then serves: while searching, each call
    runs the controller's candidate plan's step, times it and feeds the
    time back; once locked (search converged, budget spent, or a warm
    cache hit on the first call) calls go straight to the winner's step."""

    def __init__(self, build_step: Callable, controller_factory: Callable,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._build_step = build_step
        self._controller_factory = controller_factory
        self._clock = clock or time.perf_counter
        self._steps: Dict[Any, Callable] = {}
        self.autotune: Optional[AutotuneController] = None
        self._locked_fn: Optional[Callable] = None

    def _get(self, plan) -> Callable:
        fn = self._steps.get(plan)
        if fn is None:
            fn = self._steps[plan] = self._build_step(plan)
        return fn

    def __call__(self, model, optimizer, batch):
        if self.autotune is None:
            # the parameters are in hand: fingerprint, try the cache
            self.autotune = self._controller_factory(model)
        ctl = self.autotune
        if self._locked_fn is None and ctl.locked_plan is not None:
            self._locked_fn = self._get(ctl.locked_plan)
        if self._locked_fn is not None:
            return self._locked_fn(model, optimizer, batch)
        plan = ctl.begin_step()
        fn = self._get(plan)
        t0 = self._clock()
        out = fn(model, optimizer, batch)
        ctl.end_step(_settled_seconds(t0, self._clock, out[2:3]))
        if ctl.locked_plan is not None:
            self._locked_fn = self._get(ctl.locked_plan)
        return out


def make_autotuned_train_step(loss_fn: Callable, mesh, axis_name: str = "dp",
                              *, autotune=True, n_micro: int = 1, op=None,
                              bucket_bytes: Optional[int] = None,
                              compression=None, ring: bool = False,
                              algorithm: Optional[str] = None,
                              topology=None,
                              small_floor: Optional[int] = None,
                              overlap: bool = True, sync: bool = True,
                              guard=None) -> AutotunedStep:
    """The searching/serving step of ``make_overlap_train_step(...,
    autotune=...)``. The explicit communication kwargs are the baseline
    candidate: the search can only confirm or beat them."""
    from horovod_tpu_torch.common.topology import detect_topology
    from horovod_tpu_torch.ops.reduce_op import Average
    from horovod_tpu_torch.train.buckets import resolve_bucket_bytes
    from horovod_tpu_torch.train.overlap import (make_overlap_train_step,
                                                 resolve_small_floor)

    opts = AutotuneOptions.resolve(autotune)
    if op is None:
        op = Average
    topo = topology if topology is not None \
        else detect_topology(mesh, axis_name)
    world = int(mesh.shape[axis_name])
    baseline = Plan(
        bucket_bytes=resolve_bucket_bytes(bucket_bytes),
        algorithm=algorithm or ("ring" if ring else "psum"),
        codec=_codec_name(compression),
        small_floor=resolve_small_floor(small_floor))
    plans = list(opts.plans) if opts.plans else candidate_plans(
        topo, baseline=baseline, include_fp8=opts.include_fp8)
    cache_dir = resolve_cache_dir(opts.cache_dir)
    cache = PlanCache(cache_dir) if cache_dir else None
    mesh_shape = topology_key(topo, pp=int(mesh.shape.get("pp", 1)))

    def build_step(plan: Plan):
        # autotune=False: with HVD_TPU_AUTOTUNE_MESH=1 the factory's env
        # default would otherwise come back here for every candidate
        return make_overlap_train_step(
            loss_fn, mesh, axis_name, n_micro=n_micro, op=op,
            overlap=overlap, sync=sync, autotune=False, guard=guard,
            **plan.step_kwargs(topo))

    def controller_factory(model) -> AutotuneController:
        fp = plan_fingerprint(model, mesh_shape, world)
        ctl = AutotuneController(
            plans, budget_steps=opts.budget_steps,
            steps_per_trial=opts.steps_per_trial,
            log_path=opts.resolved_log_path(),
            cache=cache, fingerprint=fp)
        ctl.try_cache()
        return ctl

    return AutotunedStep(build_step, controller_factory, opts.clock)


# ---------------------------------------------------------------------------
# The parallelism plan joins the same search
# ---------------------------------------------------------------------------

def parallel_candidate_plans(world: int, n_layers: int, *, baseline=None,
                             schedules: Sequence[str] = ("1f1b", "gpipe",
                                                         "interleaved"),
                             max_pp: Optional[int] = None,
                             include_comms: bool = True) -> List[Any]:
    """The (dp x pp) x schedule x n_microbatches x comms search space of
    :func:`make_parallel_train_step`, most promising first: pure dp
    (``pp=1``) first; per pp dividing the world and the layers, each
    schedule at ``M`` in {pp, 2·pp}, interleaved at ``v=2`` where the
    layers split; with ``include_comms`` an int8-codec variant of each
    layout with dp > 1."""
    from horovod_tpu_torch.parallel.plan import ParallelPlan
    from horovod_tpu_torch.train.buckets import resolve_bucket_bytes

    plans: List[Any] = []
    if baseline is not None:
        plans.append(baseline)
    plans.append(ParallelPlan(dp=world, pp=1))
    pps = [p for p in range(2, (max_pp or world) + 1)
           if world % p == 0 and n_layers % p == 0]
    comm_variant = Plan(resolve_bucket_bytes(None), "psum", "int8") \
        if include_comms else None
    for pp in pps:
        dp = world // pp
        for M in (pp, 2 * pp):
            for schedule in schedules:
                if schedule == "interleaved":
                    if n_layers % (pp * 2) != 0:
                        continue
                    v = 2
                else:
                    v = 1
                plans.append(ParallelPlan(
                    dp=dp, pp=pp, schedule=schedule, n_microbatches=M,
                    virtual_stages=v))
                if comm_variant is not None and dp > 1:
                    plans.append(ParallelPlan(
                        dp=dp, pp=pp, schedule=schedule,
                        n_microbatches=M, virtual_stages=v,
                        comms=comm_variant))
    return list(dict.fromkeys(plans))


class _Collect:
    """The optimizer a candidate layout steps: it leaves the gradients
    where the step put them, for the caller's optimizer to apply."""

    def step(self):
        pass


class ParallelAutotunedStep:
    """Searching/serving step over whole parallelism plans (module
    docstring): ``step(params, optimizer, batch) -> (params, optimizer,
    loss)`` with ``params`` the natural-order tree (a ``ParameterDict`` of
    ``[n_layers, ...]`` leaves) on every rank, ``optimizer`` over it, and
    ``batch`` the global ``(x, targets)`` on every rank (a plan runs each
    dp replica on its block of rows). The controller is built on the
    first call, when the batch is in hand: a plan whose ``dp ·
    n_microbatches`` does not tile it is skipped."""

    def __init__(self, build_step: Callable, controller_factory: Callable,
                 n_layers: int, guard=None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        from horovod_tpu_torch.train.guard import resolve_spec
        self._build_step = build_step
        self._controller_factory = controller_factory
        self._n_layers = n_layers
        self._gspec = resolve_spec(guard)
        self._guard = guard
        self._clock = clock or time.perf_counter
        self._raw: Dict[Any, Any] = {}
        self.autotune: Optional[AutotuneController] = None
        self._guarded = None

    def _fits(self, plan, batch_dim: int, n_layers: int) -> bool:
        return (batch_dim % plan.dp == 0
                and (batch_dim // plan.dp) % plan.n_microbatches == 0
                and n_layers % plan.total_stages == 0)

    def _get(self, plan):
        raw = self._raw.get(plan)
        if raw is None:
            raw = self._raw[plan] = self._build_step(plan)
        return raw

    def pin(self):
        """The locked plan's own step (built with the caller's guard),
        or None while still searching: ``prepare_params`` once, build the
        optimizer over its parameters, and call it with this rank's dp
        block of the batch."""
        ctl = self.autotune
        if ctl is None or ctl.locked_plan is None:
            return None
        return self._build_step(ctl.locked_plan, guard=self._guard)

    def _run(self, plan, params, optimizer, batch):
        """One step of ``plan`` on a storage-order copy of ``params``;
        the gradients gathered back into ``params`` in natural order,
        then the caller's optimizer (guarded) steps."""
        from horovod_tpu_torch.train.guard import guarded_apply
        raw = self._get(plan)
        dp = raw.mesh.axis("dp")
        n = batch[0].shape[0] // plan.dp
        x, tgt = (t.narrow(0, dp.index * n, n) for t in batch)
        local = raw.prepare_params(params)
        _, _, loss = raw(local, _Collect(), (x, tgt))
        grads = raw.restore_params({k: p.grad for k, p in local.items()})
        for k, p in params.items():
            p.grad = grads[k].to(p.dtype)
        if self._gspec.enabled:
            ok = guarded_apply(optimizer, self._gspec)
        else:
            optimizer.step()
            ok = True
        return params, optimizer, loss, ok

    def __call__(self, params, optimizer, batch):
        from horovod_tpu_torch.train.guard import GuardedStep
        if self.autotune is None:
            batch_dim = int(batch[0].shape[0])
            self.autotune = self._controller_factory(
                params, batch_dim,
                lambda plan: self._fits(plan, batch_dim, self._n_layers))
        ctl = self.autotune
        plan = ctl.begin_step()

        def fn(p, o, b):
            return self._run(plan, p, o, b)

        if self._gspec.enabled:
            if self._guarded is None:
                self._guarded = GuardedStep(fn, self._gspec)
            self._guarded._fn = fn
            call = self._guarded
        else:
            def call(p, o, b):
                return fn(p, o, b)[:3]
        if ctl.locked_plan is not None:
            return call(params, optimizer, batch)
        t0 = self._clock()
        out = call(params, optimizer, batch)
        ctl.end_step(_settled_seconds(t0, self._clock, out[2:3]))
        return out


def make_parallel_train_step(layer_fn: Callable, loss_fn: Callable, *,
                             n_layers: int, autotune=True, op=None,
                             device=None, guard=None
                             ) -> ParallelAutotunedStep:
    """Search the parallelism space: the dp x pp split, the schedule, the
    microbatch count and the dp communication plan, scored together by
    measured step time on the layer-major model (the contract of
    :func:`~horovod_tpu_torch.train.pipeline.make_pipeline_train_step`),
    successive-halving style; the winner goes to the same plan cache as
    the communication search, keyed by the world (``topology_key(...,
    pp=0)``), so a warm hit locks the whole plan with zero trials. Pure
    dp (``pp=1``) is always the baseline candidate."""
    import torch.distributed as dist

    from horovod_tpu_torch.common.topology import (detect_topology,
                                                   flat_topology)
    from horovod_tpu_torch.ops.reduce_op import Average

    if op is None:
        op = Average
    opts = AutotuneOptions.resolve(autotune)
    world = dist.get_world_size() if dist.is_initialized() else 1
    try:
        topo = detect_topology(n=world)
    except Exception:
        topo = flat_topology(world)
    plans = list(opts.plans) if opts.plans else parallel_candidate_plans(
        world, n_layers)
    cache_dir = resolve_cache_dir(opts.cache_dir)
    cache = PlanCache(cache_dir) if cache_dir else None
    mesh_shape = topology_key(topo, pp=0)
    meshes: Dict[Tuple[int, int], Any] = {}

    def build_step(plan, guard=False):
        from horovod_tpu_torch.train.pipeline import make_pipeline_train_step
        key = (plan.dp, plan.pp)
        if key not in meshes:
            # collective: every rank reaches each new layout in one order
            meshes[key] = plan.build_mesh()
        return make_pipeline_train_step(
            layer_fn, loss_fn, plan=plan, n_layers=n_layers,
            mesh=meshes[key], op=op, device=device, autotune=False,
            guard=guard)

    def controller_factory(params, batch_dim: int,
                           fits) -> AutotuneController:
        usable = [p for p in plans if fits(p)]
        dropped = [p for p in plans if not fits(p)]
        if dropped:
            log.info(
                "parallel autotune: %d of %d candidate plans cannot "
                "tile batch=%d x %d layers and were skipped: %s",
                len(dropped), len(plans), batch_dim, n_layers,
                ", ".join(p.key for p in dropped[:8])
                + ("..." if len(dropped) > 8 else ""))
        if not usable:
            raise ValueError(
                f"no parallelism plan tiles global batch {batch_dim} "
                f"over {world} devices with {n_layers} layers")
        fp = plan_fingerprint(params, mesh_shape, world)
        ctl = AutotuneController(
            usable, budget_steps=opts.budget_steps,
            steps_per_trial=opts.steps_per_trial,
            log_path=opts.resolved_log_path(),
            cache=cache, fingerprint=fp)
        # the fingerprint covers the tree and the world, not the batch: a
        # cached plan that cannot tile this batch is retuned
        cached = cache.load(fp) if cache is not None else None
        if cached is not None and (not hasattr(cached, "total_stages")
                                   or not fits(cached)):
            log.warning(
                "cached parallelism plan %s cannot tile global batch "
                "%d x %d layers on this run; retuning",
                getattr(cached, "key", cached), batch_dim, n_layers)
        else:
            ctl.try_cache()
        return ctl

    return ParallelAutotunedStep(build_step, controller_factory, n_layers,
                                 guard=guard, clock=opts.clock)
