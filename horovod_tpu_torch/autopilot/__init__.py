"""Fleet autopilot: finding→remediation policies with a full decision
audit trail (docs/OBSERVABILITY.md "Autopilot").

The observability plane *detects* (anomaly engine, recompile storms,
HBM slow leaks, persistent stragglers, the measured re-mesh SLO) and
the control plane can *act* (proactive drain, plan-cache re-tune,
durable commit, elastic re-mesh) — this package closes the loop the
reference's ParameterManager closed for knobs, at the membership/
placement level: declarative, rate-limited, SLO-gated policies whose
every decision — fired, suppressed, or dry-run — is itself a
first-class observable artifact.

* :mod:`horovod_tpu_torch.autopilot.policy` — the JSON policy spec
  (``HVD_TPU_AUTOPILOT_POLICY`` inline-or-file, strict validation) and
  the ``HVD_TPU_AUTOPILOT`` mode knob (off / observe / act; observe —
  record everything, touch nothing — is the default);
* :mod:`horovod_tpu_torch.autopilot.engine` — the policy engine: hysteresis,
  cooldown, action budgets, SLO gates, and the four-channel audit
  trail (``hvd_autopilot_*`` metrics, ``autopilot_decision`` flight
  events, the ``actions_rank<r>.jsonl`` log behind
  ``python -m horovod_tpu_torch.metrics history --actions``, the autopsy
  summary's ``actions`` section);
* :mod:`horovod_tpu_torch.autopilot.actions` — the wired remediations:
  straggler drain-and-replace and HBM planned restart over the KV
  ``action/`` scope, recompile-storm freeze/alert, topology re-tune.

Subscription is automatic: the anomaly engine routes every finding —
native ``_flag`` detectors and external ``report_finding()`` detectors
alike — through :func:`on_finding`.

A copy of ``horovod_tpu/autopilot/__init__.py``.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from horovod_tpu_torch.autopilot.policy import (ACTIONS, AutopilotError, MODES,
                                          Policy, default_policies,
                                          load_policies_from_env, mode,
                                          parse_policies)
from horovod_tpu_torch.autopilot.engine import PolicyEngine, remesh_p50_s
from horovod_tpu_torch.autopilot import actions

__all__ = [
    "ACTIONS", "AutopilotError", "MODES", "Policy", "PolicyEngine",
    "parse_policies", "default_policies", "load_policies_from_env",
    "mode", "enabled", "on_finding", "default_engine", "ensure_engine",
    "recent_decisions", "remesh_p50_s", "actions", "reset",
]

_ENGINE: Optional[PolicyEngine] = None
_ENGINE_KEY = None
_LOCK = threading.Lock()


def enabled() -> bool:
    return mode() != "off"


def _env_key() -> tuple:
    return (mode(), os.environ.get("HVD_TPU_AUTOPILOT_POLICY", ""))


def default_engine() -> Optional[PolicyEngine]:
    """The process-wide engine (None when ``HVD_TPU_AUTOPILOT=off``),
    rebuilt when the mode or policy env changes (elastic re-init,
    tests).  A policy document that fails validation here is swallowed
    into None — :func:`ensure_engine` (called from ``hvd.init``) is the
    loud path for config errors."""
    global _ENGINE, _ENGINE_KEY
    if not enabled():
        return None
    key = _env_key()
    eng = _ENGINE
    if eng is not None and _ENGINE_KEY == key:
        # the engine survives elastic re-inits (cooldown/budget state
        # must persist across world changes) but its recorded identity
        # must not go stale when a re-mesh renumbers this worker
        eng.refresh_identity()
        return eng
    with _LOCK:
        if _ENGINE is None or _ENGINE_KEY != key:
            try:
                _ENGINE = PolicyEngine()
                _ENGINE_KEY = key
            except AutopilotError:
                return None
        return _ENGINE


def ensure_engine() -> Optional[PolicyEngine]:
    """Arm the engine, surfacing policy-document errors LOUDLY —
    called from ``hvd.init`` so a typo'd ``HVD_TPU_AUTOPILOT_POLICY``
    fails the job at startup instead of running policy-free
    (the same contract as a typo'd chaos fault plan)."""
    global _ENGINE, _ENGINE_KEY
    if not enabled():
        return None
    key = _env_key()
    with _LOCK:
        if _ENGINE is None or _ENGINE_KEY != key:
            _ENGINE = PolicyEngine()  # AutopilotError propagates
            _ENGINE_KEY = key
        else:
            _ENGINE.refresh_identity()  # re-init may have renumbered us
        return _ENGINE


def on_finding(finding: dict) -> List[dict]:
    """The anomaly engine's fan-out hook: one call per flagged finding
    (cheap None check when the autopilot is off)."""
    eng = default_engine()
    return eng.on_finding(finding) if eng is not None else []


def recent_decisions() -> List[dict]:
    """Decisions so far (empty when the engine never armed) — what the
    autopsy summary embeds under ``actions``."""
    eng = _ENGINE
    return eng.recent_decisions() if eng is not None else []


def reset() -> None:
    """Drop the engine and action-module state so env is re-read
    (tests, elastic re-init)."""
    global _ENGINE, _ENGINE_KEY
    with _LOCK:
        _ENGINE = None
        _ENGINE_KEY = None
    actions.reset()
