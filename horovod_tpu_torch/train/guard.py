"""Numeric guardrail of the train step: a step whose synchronized gradients
are non-finite, or over a norm cap, is skipped with the parameters and the
optimizer state as they were.

Mirrors the grad guard of ``horovod_tpu/train/guard.py``: ``GuardSpec``
(env defaults: ``HVD_TPU_GUARD`` on, ``HVD_TPU_GUARD_MAX_NORM`` 0 = no
cap), ``resolve_spec``, ``grads_ok``, ``guarded_apply`` and
``GuardedStep``, which observes each verdict one step late and counts the
skips (``flush()`` drains the last one) on
``hvd_guard_skipped_steps_total`` with a ``guard_skip`` flight event, as
the JAX ``GuardObserver`` does. One scalar, the fp32 sum of the squared
post-sync gradients (replicated across dp, so no collective), decides;
under pipeline parallelism it is summed over pp, so that every stage
skips or applies together.

As the JAX step does, ``guarded_apply`` decides on the device, with no
host sync. A fused torch Adam/AdamW (``models.adamw``) takes the verdict
as its ``found_inf`` and skips the update itself, step count included.
Any other optimizer steps, and every device tensor it changed is
``torch.where``-selected in place against a copy taken before; state that
lives on the host (a CPU step count, a Python counter, state the step
created) is put back when the verdict is read one step late, by
:class:`GuardedStep`, before the next step runs. The verdict reaches the
host through a pinned copy and an event, not a stream sync. The chaos seam, anomaly escalation
(``grad_nonfinite`` findings), ``param_digest`` and ``ReplicaCanary``
arrive with later slices.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Optional, Tuple

import torch
from torch.profiler import record_function

from horovod_tpu_torch.common.config import env_bool, env_float

log = logging.getLogger("horovod_tpu_torch")


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Resolved guard configuration."""
    enabled: bool = True
    max_norm: float = 0.0        # 0 = finiteness only, no norm cap

    @staticmethod
    def from_env() -> "GuardSpec":
        return GuardSpec(enabled=env_bool("GUARD", True),
                         max_norm=max(0.0, env_float("GUARD_MAX_NORM", 0.0)))


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


def guarded_apply(optimizer: torch.optim.Optimizer, spec: GuardSpec,
                  pp_axis=None) -> Verdict:
    """Step ``optimizer`` on its parameters' gradients where the verdict
    holds, and keep the old parameters and state where it fails (a
    skipped step, not a zero update), decided on the device as the JAX
    ``guarded_apply`` does. A fused torch Adam/AdamW is given the verdict
    as ``found_inf`` and skips by itself, with no copy; any other
    optimizer steps, and every device tensor it changed is selected
    against a copy taken before. ``pp_axis`` as in :func:`grads_ok`.
    Returns the :class:`Verdict`."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.grad is not None]
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


class GuardedStep:
    """The step a guarded factory returns: ``fn(model, optimizer, batch)
    -> (model, optimizer, loss, ok)`` called as ``step(model, optimizer,
    batch) -> (model, optimizer, loss)``, each verdict observed at the
    next call or at :meth:`flush`. ``skipped`` counts the skipped steps,
    ``consecutive`` the skips in a row."""

    def __init__(self, fn, spec: GuardSpec) -> None:
        self._fn = fn
        self.guard_spec = spec
        self.skipped = 0
        self.consecutive = 0
        self._step = 0
        self._pending: Optional[Tuple[int, bool]] = None

    def __call__(self, model, optimizer, batch):
        self.flush()
        model, optimizer, loss, ok = self._fn(model, optimizer, batch)
        self._pending = (self._step, ok)
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
        try:
            from horovod_tpu_torch.metrics.registry import default_registry
            default_registry().counter(
                "hvd_guard_skipped_steps_total",
                help="train steps skipped by the numeric guardrail "
                     "(non-finite or over-norm gradients; parameters "
                     "and optimizer state kept)").inc()
        except Exception:
            pass
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event("guard_skip", step=int(step),
                     consecutive=self.consecutive)
        log.warning("guard: skipped step %d (non-finite or over-norm "
                    "gradients; %d consecutive)", step, self.consecutive)
