"""Numeric guardrail of the train step, and the cross-replica canary.

Mirrors ``horovod_tpu/train/guard.py``:

* **Grad guard**: ``GuardSpec`` (env defaults: ``HVD_TPU_GUARD`` on,
  ``HVD_TPU_GUARD_MAX_NORM`` 0 = no cap, ``HVD_TPU_GUARD_ESCALATE`` 3),
  ``resolve_spec``, ``grads_ok`` and ``guarded_apply``: a step whose
  synchronized gradients are non-finite, or over the norm cap, is skipped
  with the parameters and the optimizer state as they were. One scalar,
  the fp32 sum of the squared post-sync gradients (replicated across dp,
  so no collective), decides; under pipeline parallelism it is summed over
  pp, so that every stage skips or applies together.

  As the JAX step does, ``guarded_apply`` decides on the device, with no
  host sync. A fused torch Adam/AdamW (``models.adamw``) takes the verdict
  as its ``found_inf`` and skips the update itself, step count included.
  Any other optimizer steps, and every device tensor it changed is
  ``torch.where``-selected in place against a copy taken before; state
  that lives on the host (a CPU step count, a Python counter, state the
  step created) is put back when the verdict is read one step late, by
  :class:`GuardedStep`, before the next step runs. The verdict reaches the
  host through a pinned copy and an event, not a stream sync.
* **Skip accounting** (:class:`GuardedStep`, the JAX ``GuardObserver``):
  every skipped step counts ``hvd_guard_skipped_steps_total`` and lands a
  ``guard_skip`` flight event; every ``HVD_TPU_GUARD_ESCALATE``-th
  consecutive skip reports a ``grad_nonfinite`` anomaly finding.
* **Replica canary** (:class:`ReplicaCanary`): every
  ``HVD_TPU_CANARY_EVERY`` steps (0 = off), allgather a CRC32 digest
  (:func:`param_digest`) of a fixed slice of every leaf and flag the odd
  rank out as a ``replica_divergence`` finding (a tie is counted and
  recorded as ``canary_mismatch``). It catches compute that went silently
  wrong on one replica. The digest equals the JAX package's for the same
  values.

The JAX canary digests whole logical arrays, identical across every
layout. A port rank holds only its shards, which differ from its tp, pp,
sp and ep neighbours' by design, so the port compares digests over the dp
axis group (the replicas of the same shards), and over the world only
where there is no mesh.

The chaos ``grad`` seam: when the armed fault plan holds ``grad`` rules
for this rank, :class:`GuardedStep` evaluates the seam at each step's
index and :func:`guarded_apply` corrupts the synchronized gradients with
:func:`apply_injection` before the verdict (``nan``/``inf``: the guard
must skip the step; ``scale``: a finite spike only the canary can see).
Without such a rule nothing is evaluated and no kernel is launched.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import zlib
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from horovod_tpu_torch.checkpoint.format import tensor_storage
from horovod_tpu_torch.common.config import env_bool, env_float, env_int
from horovod_tpu_torch.common.tree import nest_dotted, tree_leaves

log = logging.getLogger("horovod_tpu_torch")

#: elements digested per leaf (a FIXED parameter slice — cheap, and enough
#: that real divergence cannot hide: a replica whose math went wrong
#: diverges everywhere, not in one element)
DIGEST_ELEMS_PER_LEAF = 256


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Resolved guard configuration."""
    enabled: bool = True
    max_norm: float = 0.0        # 0 = finiteness only, no norm cap
    escalate_after: int = 3      # consecutive skips -> grad_nonfinite

    @staticmethod
    def from_env() -> "GuardSpec":
        return GuardSpec(enabled=env_bool("GUARD", True),
                         max_norm=max(0.0, env_float("GUARD_MAX_NORM", 0.0)),
                         escalate_after=max(1, env_int("GUARD_ESCALATE", 3)))


def resolve_spec(guard) -> GuardSpec:
    """The factories' ``guard=`` seam: ``None`` reads env, ``False``
    disables, ``True`` is the env-tuned default, a :class:`GuardSpec`
    pins everything."""
    if isinstance(guard, GuardSpec):
        return guard
    if guard is None:
        return GuardSpec.from_env()
    if guard is False:
        return GuardSpec(enabled=False)
    if guard is True:
        return dataclasses.replace(GuardSpec.from_env(), enabled=True)
    raise TypeError(f"guard must be None/bool/GuardSpec, got {guard!r}")


def grads_ok(grads: Iterable[torch.Tensor], spec: GuardSpec,
             pp_axis=None) -> torch.Tensor:
    """The verdict, a bool tensor on the gradients' device: the fp32 sum of
    squared gradients is finite, and under ``max_norm**2`` when a cap is
    set. Sum-of-squares overflow counts as a spike. ``pp_axis`` (a mesh
    :class:`~horovod_tpu_torch.parallel.mesh.Axis`) sums the scalar over
    the pipeline's stages, which hold different gradients, so that every
    stage reaches the same verdict; the sum stays on the device."""
    sq = None
    for g in grads:
        s = g.float().square().sum()
        sq = s if sq is None else sq + s
    live_pp = pp_axis is not None and pp_axis.size > 1
    if sq is None and not live_pp:
        return torch.tensor(True)
    if live_pp:
        from horovod_tpu_torch.ops.mesh_collectives import preduce
        sq = preduce(sq if sq is not None else torch.zeros(()), pp_axis)
    ok = torch.isfinite(sq)
    if spec.max_norm > 0:
        # filled on the device: a host scalar copied in would sync
        cap = torch.full((), spec.max_norm, dtype=torch.float32,
                         device=sq.device)
        ok = ok & (sq <= cap ** 2)
    return ok


_MISSING = object()
_ON_DEVICE = object()      # a state entry the device copy holds


def _takes_found_inf(optimizer) -> bool:
    """A fused torch Adam or AdamW: its step reads ``found_inf`` on the
    device, leaves the parameters and moments as they were where it is 1
    and takes its step count back, as ``GradScaler`` uses it. (Fused SGD
    reads it too, but on a skipped first step it keeps an uninitialized
    momentum buffer; subclasses, such as a ``DistributedOptimizer``, keep
    state of their own.)"""
    return (type(optimizer) in (torch.optim.Adam, torch.optim.AdamW)
            and all(g.get("fused") for g in optimizer.param_groups))


def _state_tables(optimizer) -> list:
    """The per-parameter state of ``optimizer``: its ``state`` and the EF
    residuals a ``DistributedOptimizer`` keeps beside it."""
    tables = [optimizer.state]
    residual = getattr(optimizer, "_hvd_residual", None)
    if residual is not None:
        tables.append(residual)
    return tables


class _Saved:
    """The parameters and optimizer state before a step, for an optimizer
    that does not take ``found_inf``: a device copy of every device tensor
    the step may change, and the host's copy of everything else, put back
    once the verdict is read."""

    def __init__(self, optimizer, params, device: torch.device) -> None:
        self.device = device
        self.params = params
        self.tables = [(table, {p: self._keep(table.get(p, _MISSING))
                                for p in params})
                       for table in _state_tables(optimizer)]
        slots = [s for s, _ in self._device_tensors()]
        news = [t for _, t in self._device_tensors()]
        olds = [torch.empty_like(t) for t in news]
        if news:
            torch._foreach_copy_(olds, news)
        self.old = dict(zip(slots, olds))

    def _on_device(self, v) -> bool:
        return isinstance(v, torch.Tensor) and v.device == self.device

    def _keep(self, entry):
        """The host's copy of a state entry: device tensors are marked
        (the device copy holds them), CPU tensors cloned, values kept."""
        if isinstance(entry, dict):
            return {k: self._keep(v) for k, v in entry.items()}
        if self._on_device(entry):
            return _ON_DEVICE
        if isinstance(entry, torch.Tensor):
            return entry.detach().clone()
        return entry

    def _device_tensors(self):
        """``(slot, tensor)`` of every device tensor the step may change,
        as it stands now: the parameters, then the state in table order."""
        for i, p in enumerate(self.params):
            yield (None, i, None), p
        for n, (table, _) in enumerate(self.tables):
            for i, p in enumerate(self.params):
                entry = table.get(p, _MISSING)
                if isinstance(entry, dict):
                    for k, v in entry.items():
                        if self._on_device(v):
                            yield (n, i, k), v
                elif self._on_device(entry):
                    yield (n, i, None), entry

    @torch.no_grad()
    def select(self, ok: torch.Tensor) -> None:
        """Old or new, in place on the device, for every device tensor the
        step left: state the step created selects against zero, a fresh
        state's value."""
        for s, t in self._device_tensors():
            old = self.old.get(s)
            if old is None or old.shape != t.shape or old.dtype != t.dtype:
                old = t.new_zeros(())
            torch.where(ok, t, old, out=t)

    def restore_host(self) -> None:
        """After a skip: put back the state the host holds (CPU tensors,
        Python values) and drop state the skipped step created."""
        for table, before in self.tables:
            for p, old in before.items():
                new = table.get(p, _MISSING)
                if old is _MISSING:
                    table.pop(p, None)
                elif isinstance(new, dict) and isinstance(old, dict):
                    for k in list(new):
                        if k not in old:
                            del new[k]
                        elif old[k] is not _ON_DEVICE:
                            new[k] = old[k]
                elif old is not _ON_DEVICE:
                    table[p] = old


class Verdict:
    """One step's verdict. ``ok`` stays on the device; :meth:`settle` (or
    ``bool()``) reads it through a pinned copy made when the step ran,
    waiting on that step's event rather than syncing the stream, and on a
    skip restores the host-side state the step advanced. Settle it before
    the optimizer steps again."""

    def __init__(self, ok: torch.Tensor, saved: Optional[_Saved]) -> None:
        self.ok = ok
        self._saved = saved
        self._ready = None
        if ok.is_cuda:
            self._host = torch.empty((), dtype=torch.bool, pin_memory=True)
            self._host.copy_(ok, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
        else:
            self._host = ok
        self._value: Optional[bool] = None

    def settle(self) -> bool:
        if self._value is None:
            if self._ready is not None:
                self._ready.synchronize()
            self._value = bool(self._host)
            if not self._value and self._saved is not None:
                self._saved.restore_host()
            self._saved = None
        return self._value

    __bool__ = settle


def apply_injection(grads, code: int, factor: float = 0.0):
    """Chaos ``grad`` seam (``horovod_tpu/train/guard.py:99-115``):
    corrupt every gradient of ``grads`` (a tensor or a tree of them) in
    place and return ``grads``. ``code`` is a
    :data:`horovod_tpu_torch.chaos.GRAD_CODES` value: 0 leaves the
    gradients alone (no launch), 1 adds nan, 2 adds inf, 3 multiplies by
    ``factor``, cast to each gradient's dtype first, as the JAX seam
    casts it."""
    code = int(code)
    if code == 0:
        return grads
    if code not in (1, 2, 3):
        raise ValueError(f"unknown grad injection code {code}")
    for g in tree_leaves(grads):
        if code == 1:
            g.add_(float("nan"))
        elif code == 2:
            g.add_(float("inf"))
        else:
            g.mul_(float(torch.tensor(factor, dtype=torch.float32)
                         .to(g.dtype)))
    return grads


#: the (code, factor) the running :class:`GuardedStep` drew from the
#: ``grad`` seam for its step, read by :func:`guarded_apply`
_INJECTION = threading.local()


def _pending_injection() -> Tuple[int, float]:
    return getattr(_INJECTION, "value", (0, 0.0))


def guarded_apply(optimizer: torch.optim.Optimizer, spec: GuardSpec,
                  pp_axis=None) -> Verdict:
    """Step ``optimizer`` on its parameters' gradients where the verdict
    holds, and keep the old parameters and state where it fails (a
    skipped step, not a zero update), decided on the device as the JAX
    ``guarded_apply`` does. A fused torch Adam/AdamW is given the verdict
    as ``found_inf`` and skips by itself, with no copy; any other
    optimizer steps, and every device tensor it changed is selected
    against a copy taken before. ``pp_axis`` as in :func:`grads_ok`.
    A ``grad`` fault drawn by the running :class:`GuardedStep` corrupts
    the gradients first. Returns the :class:`Verdict`."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.grad is not None]
    code, factor = _pending_injection()
    if code:
        # on the synchronized gradients, as the JAX steps inject
        # (horovod_tpu/train/overlap.py:366, pipeline.py:409)
        apply_injection([p.grad for p in params], code, factor)
    with record_function("hvd.guard"):
        ok = grads_ok([p.grad for p in params], spec, pp_axis)
        if _takes_found_inf(optimizer):
            optimizer.found_inf = (~ok).float()
            saved = None
        else:
            saved = _Saved(optimizer, params, ok.device)
    try:
        optimizer.step()
    finally:
        optimizer.__dict__.pop("found_inf", None)
    if saved is not None:
        with record_function("hvd.guard"):
            saved.select(ok)
    return Verdict(ok, saved)


# -- replica canary -----------------------------------------------------------

def param_digest(tree, elems_per_leaf: int = DIGEST_ELEMS_PER_LEAF) -> int:
    """Deterministic CRC32 digest of a fixed slice of every leaf (the
    first ``elems_per_leaf`` elements of its flattened value), chained in
    ``jax.tree_util``'s flatten order: CRC32 over the bytes, then over the
    numpy dtype name. Equal to the JAX ``param_digest`` for the same
    values (bf16 included). A module is digested as its ``state_dict``
    nested by its dots (the JAX parameter tree's order). Only the slice
    crosses from the device to the host; other leaves are digested as
    ``np.asarray`` sees them, as the JAX digest does, and skipped where
    it cannot."""
    if isinstance(tree, torch.nn.Module):
        tree = nest_dotted(tree.state_dict())
    crc = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            # bf16 as its raw 16 bits under the name "bfloat16", as the
            # checkpoint stores it and ml_dtypes would give it
            arr, name = tensor_storage(
                leaf.detach().reshape(-1)[:elems_per_leaf].cpu())
            data = arr.tobytes()
        else:
            try:
                flat = np.ascontiguousarray(
                    np.asarray(leaf).reshape(-1)[:elems_per_leaf])
            except (TypeError, ValueError):
                continue  # not array-like
            data, name = flat.tobytes(), str(flat.dtype)
        crc = zlib.crc32(data, crc)
        crc = zlib.crc32(name.encode(), crc)
    return crc & 0x7FFFFFFF


def divergent_ranks(digests) -> List[int]:
    """Majority vote over per-rank digests: ranks whose digest differs
    from the STRICT-majority value are the odd ones out. No strict
    majority (a 50/50 split, or everyone different) attributes nothing."""
    values = [int(d) for d in digests]
    if len(values) < 2:
        return []
    counts: dict = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    modal, n = max(counts.items(), key=lambda kv: kv[1])
    if n * 2 <= len(values):
        return []
    return [r for r, v in enumerate(values) if v != modal]


def _count(name: str, help: str) -> None:
    from horovod_tpu_torch.metrics.registry import default_registry
    default_registry().counter(name, help=help).inc()


class ReplicaCanary:
    """Cross-replica divergence detector.

    ``check(step, tree, axis=None)`` digests this rank's state, gathers one
    int64 per rank over ``axis`` (a mesh
    :class:`~horovod_tpu_torch.parallel.mesh.Axis`: the dp axis under a
    mesh, whose ranks hold the same shards) or, with ``axis=None``, over
    the world (no mesh: every rank a replica), and reports a
    ``replica_divergence`` anomaly finding naming each odd rank out (its
    world rank). :class:`GuardedStep` runs it every
    ``HVD_TPU_CANARY_EVERY`` steps (0 = off, the default: the gather is
    cheap, but it is a collective)."""

    def __init__(self, every: int,
                 elems_per_leaf: int = DIGEST_ELEMS_PER_LEAF) -> None:
        self.every = int(every)
        self.elems_per_leaf = elems_per_leaf

    @staticmethod
    def from_env() -> Optional["ReplicaCanary"]:
        every = env_int("CANARY_EVERY", 0)
        return ReplicaCanary(every) if every > 0 else None

    def maybe_check(self, step: int, tree, axis=None) -> List[dict]:
        if self.every <= 0 or step <= 0 or step % self.every != 0:
            return []
        return self.check(step, tree, axis)

    def check(self, step: int, tree, axis=None) -> List[dict]:
        """Returns the findings reported (usually []). A no-op unless the
        process group is up with two or more replicas to compare."""
        from horovod_tpu_torch.common.basics import (backend, device,
                                                     is_initialized, rank)
        if not is_initialized():
            return []
        import torch.distributed as dist
        if axis is None:
            group, ranks = None, list(range(dist.get_world_size()))
        else:
            group, ranks = axis.group, list(axis.ranks)
        world = len(ranks)
        if world < 2:
            return []
        digest = param_digest(tree, self.elems_per_leaf)
        dev = device() if backend() == "nccl" else torch.device("cpu")
        mine = torch.full((1,), digest, dtype=torch.int64, device=dev)
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine, group=group)
        digests = [int(p.item()) for p in parts]
        _count("hvd_canary_checks_total",
               "cross-replica canary digest comparisons run")
        odd = divergent_ranks(digests)
        findings = []
        if not odd and len(set(digests)) > 1:
            # replicas DISAGREE but no strict majority can convict a rank
            # (two replicas, a 50/50 split): count it and say so
            _count("hvd_canary_divergence_total",
                   "canary checks that flagged a divergent replica")
            from horovod_tpu_torch.diagnostics.flight_recorder import (
                record_event)
            record_event("canary_mismatch", step=int(step),
                         digests=[hex(d) for d in digests])
            log.error(
                "canary: replica digests DISAGREE at step %d with no "
                "attributable majority (%d replicas: %s) — data corruption "
                "somewhere, but no rank can be convicted", step, world,
                [hex(d) for d in digests])
        majority = [d for i, d in enumerate(digests) if i not in odd]
        for i in odd:
            _count("hvd_canary_divergence_total",
                   "canary checks that flagged a divergent replica")
            log.error(
                "canary: replica DIVERGENCE at step %d — rank %d digest "
                "%#x disagrees with the majority (%d replicas, own rank "
                "%d); silent data corruption upstream of the wire",
                step, ranks[i], digests[i], world, rank())
            from horovod_tpu_torch.metrics.anomaly import report_finding
            f = report_finding("replica_divergence", rank=int(ranks[i]),
                               step=int(step), digest=int(digests[i]),
                               majority=int(majority[0]), world=int(world))
            if f:
                findings.append(f)
        return findings


# -- the step wrapper -----------------------------------------------------------

class GuardedStep:
    """The step a guarded factory returns: ``fn(model, optimizer, batch)
    -> (model, optimizer, loss, ok)`` called as ``step(model, optimizer,
    batch) -> (model, optimizer, loss)``, each verdict observed at the
    next call or at :meth:`flush`. ``skipped`` counts the skipped steps,
    ``consecutive`` the skips in a row; every ``escalate_after``-th
    consecutive skip reports a ``grad_nonfinite`` finding. ``canary`` (by
    default from ``HVD_TPU_CANARY_EVERY``) checks the model over
    ``canary_axis`` (the replicas' axis; ``None`` is the world) every N
    steps."""

    def __init__(self, fn, spec: GuardSpec,
                 canary: Optional[ReplicaCanary] = "env",
                 canary_axis=None) -> None:
        self._fn = fn
        self.guard_spec = spec
        self.canary = ReplicaCanary.from_env() if canary == "env" \
            else canary
        self.canary_axis = canary_axis
        self.skipped = 0
        self.consecutive = 0
        self._step = 0
        self._pending: Optional[Tuple[int, bool]] = None

    def __call__(self, model, optimizer, batch):
        self.flush()
        # chaos ``grad`` seam (horovod_tpu/train/guard.py:399-406): drawn
        # only while a grad rule is armed for this rank, applied by
        # guarded_apply inside the step
        from horovod_tpu_torch import chaos
        inject = (chaos.grad_injection(self._step)
                  if chaos.grad_rules_armed() else (0, 0.0))
        _INJECTION.value = inject
        try:
            model, optimizer, loss, ok = self._fn(model, optimizer, batch)
        finally:
            _INJECTION.value = (0, 0.0)
        self._pending = (self._step, ok)
        if self.canary is not None:
            self.canary.maybe_check(self._step, model, self.canary_axis)
        self._step += 1
        return model, optimizer, loss

    def flush(self) -> None:
        """Observe the previous step's verdict."""
        if self._pending is None:
            return
        step, ok = self._pending
        self._pending = None
        if ok.settle() if isinstance(ok, Verdict) else ok:
            self.consecutive = 0
            return
        self.skipped += 1
        self.consecutive += 1
        _count("hvd_guard_skipped_steps_total",
               "train steps skipped by the numeric guardrail (non-finite "
               "or over-norm gradients; parameters and optimizer state "
               "kept)")
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event("guard_skip", step=int(step),
                     consecutive=self.consecutive)
        log.warning("guard: skipped step %d (non-finite or over-norm "
                    "gradients; %d consecutive)", step, self.consecutive)
        if self.consecutive % self.guard_spec.escalate_after == 0:
            # every Nth consecutive skip re-reports: a run that stays
            # poisoned keeps saying so instead of going quiet
            from horovod_tpu_torch.metrics.anomaly import report_finding
            report_finding("grad_nonfinite", step=int(step),
                           consecutive=self.consecutive)
