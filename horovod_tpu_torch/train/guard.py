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
post-sync gradients (replicated across dp, so no collective), decides. The JAX step selects old or new state inside the compiled
program; here ``guarded_apply`` reads the verdict on the host before
calling the optimizer, one device sync a step. The chaos seam, anomaly
escalation (``grad_nonfinite`` findings), ``param_digest`` and
``ReplicaCanary`` arrive with later slices.
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


def grads_ok(grads: Iterable[torch.Tensor], spec: GuardSpec) -> torch.Tensor:
    """The verdict, a bool tensor: the fp32 sum of squared gradients is
    finite, and under ``max_norm**2`` when a cap is set. Sum-of-squares
    overflow counts as a spike."""
    sq = None
    for g in grads:
        s = g.float().square().sum()
        sq = s if sq is None else sq + s
    if sq is None:
        return torch.tensor(True)
    ok = torch.isfinite(sq)
    if spec.max_norm > 0:
        ok = ok & (sq <= torch.tensor(spec.max_norm, dtype=torch.float32,
                                      device=sq.device) ** 2)
    return ok


def guarded_apply(optimizer: torch.optim.Optimizer, spec: GuardSpec) -> bool:
    """Step ``optimizer`` on its parameters' gradients unless the verdict
    fails; returns the verdict. A failed verdict leaves the parameters and
    the optimizer state untouched (a skipped step, not a zero update)."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    with record_function("hvd.guard"):
        ok = bool(grads_ok(grads, spec))
    if ok:
        optimizer.step()
    return ok


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
        if ok:
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
