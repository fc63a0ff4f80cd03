"""Declarative finding→remediation policies: schema + validation.

A policy document is JSON (inline in ``HVD_TPU_AUTOPILOT_POLICY`` or a
path to a file — the same inline-or-file convention as the chaos fault
plans) describing WHICH anomaly findings trigger WHICH remediation,
and under what rate limits and gates:

.. code-block:: json

    {
      "policies": [
        {"name": "straggler-drain",
         "finding": "persistent_straggler",
         "action": "drain_and_replace",
         "cooldown_s": 300, "hysteresis": 1,
         "max_actions": 2, "window_s": 3600,
         "horizon_steps": 500, "max_remesh_p50_s": 0}
      ]
    }

Policy fields:

* ``name`` (required) — unique policy id; every decision is recorded
  under it (metrics label, flight event, action log).
* ``finding`` (required) — the anomaly finding ``kind`` this policy
  subscribes to.  Both the engine's native step/fleet detectors and
  external ``report_finding()`` detectors take the same path.
* ``action`` (required) — one of the :data:`ACTIONS` catalog below.
* ``cooldown_s`` — after a fired (or dry-run) decision, further
  findings are suppressed for this long (default 300).
* ``hysteresis`` — consecutive matching findings required before the
  policy may fire (default 1; the recompile-storm policy uses 2 —
  one storm report is noise, a repeat on the same function is a bug).
* ``max_actions`` / ``window_s`` — at most ``max_actions`` fired/dry-run
  decisions per sliding ``window_s`` seconds (defaults 2 / 3600);
  beyond it decisions are suppressed with reason ``budget``.
* ``key_field`` — optional finding field name scoping hysteresis,
  cooldown and budget PER distinct value (the recompile-storm policy
  keys on ``function``: storms on two different functions are two
  independent decision streams).
* action parameters — ``horizon_steps`` + ``max_remesh_p50_s``
  (``drain_and_replace``: the SLO gate projects the straggler's loss
  over ``horizon_steps`` and refuses a re-mesh whose measured p50 cost
  exceeds it; ``max_remesh_p50_s`` > 0 additionally caps the
  acceptable p50 outright), ``max_margin_frac``
  (``commit_restart``: fire only when the fleet OOM margin has fallen
  below this fraction of the device limit).

Validation is strict — a typo'd field or an unknown action is a config
error surfaced when the engine arms, not a silently dead policy.

``HVD_TPU_AUTOPILOT`` ∈ {``off``, ``observe``, ``act``} selects the
mode (default ``observe``): ``observe`` evaluates every gate and
records the identical decision stream ``act`` would, without acting —
the audit trail IS the dry run.

A copy of ``horovod_tpu/autopilot/policy.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Union

#: remediation catalog: action name -> True when the remediation needs
#: the elastic driver (it is requested over the KV ``action/`` scope;
#: without a driver the decision is recorded and the dispatch skipped)
ACTIONS: Dict[str, bool] = {
    "drain_and_replace": True,   # plan the world around a sick worker
    "commit_restart": True,      # final durable commit + planned restart
    "freeze_alert": False,       # name the offender, stop the bleeding
    "retune": False,             # invalidate plan cache + re-search
    # data-plane integrity (docs/OBSERVABILITY.md "Autopilot"):
    "quarantine_rank": True,     # drain the SDC-divergent rank AND
    #                              blocklist its host with evidence —
    #                              unlike a preemption drain, the exit
    #                              is held against the hardware
    "rollback_restore": False,   # persistent grad_nonfinite: restore
    #                              the last durable checkpoint via the
    #                              registered rollback hooks instead of
    #                              committing a poisoned state forward
    # zero-drop serving (docs/SERVING.md):
    "scale_out": False,          # serving slo_breach: raise the replica
    #                              fleet's target size via the
    #                              registered scale-out hooks (the
    #                              ReplicaFleet wires itself in)
    # canary weight rollout (docs/SERVING.md "Canary rollout"):
    # both subscribe to the SAME rollout_verdict finding;
    # the engine's SLO gate passes each policy only when the verdict
    # matches its action, so one comparator report drives exactly one
    # of the two transitions
    "promote_rollout": False,    # verdict "promote": advance the
    #                              canary stage (N% → 50% → fleet-wide)
    #                              via the registered rollout hooks
    "rollback_rollout": False,   # verdict "rollback": repin every
    #                              canary replica to the incumbent
    #                              version — the same atomic
    #                              between-batch flip as a hot swap,
    #                              so zero requests fail
}

MODES = ("off", "observe", "act")

DEFAULT_COOLDOWN_S = 300.0
DEFAULT_MAX_ACTIONS = 2
DEFAULT_WINDOW_S = 3600.0
DEFAULT_HORIZON_STEPS = 500
DEFAULT_MAX_MARGIN_FRAC = 0.1


class AutopilotError(ValueError):
    """An autopilot policy document failed validation."""


@dataclasses.dataclass
class Policy:
    name: str
    finding: str
    action: str
    cooldown_s: float = DEFAULT_COOLDOWN_S
    hysteresis: int = 1
    max_actions: int = DEFAULT_MAX_ACTIONS
    window_s: float = DEFAULT_WINDOW_S
    key_field: Optional[str] = None
    # drain_and_replace SLO gate
    horizon_steps: int = DEFAULT_HORIZON_STEPS
    max_remesh_p50_s: float = 0.0        # 0 = no absolute cap
    # commit_restart SLO gate
    max_margin_frac: float = DEFAULT_MAX_MARGIN_FRAC

    def needs_driver(self) -> bool:
        return ACTIONS[self.action]


_POLICY_KEYS = {"name", "finding", "action", "cooldown_s", "hysteresis",
                "max_actions", "window_s", "key_field", "horizon_steps",
                "max_remesh_p50_s", "max_margin_frac"}


def _parse_policy(doc: Dict[str, Any], index: int) -> Policy:
    if not isinstance(doc, dict):
        raise AutopilotError(f"policy #{index}: not an object: {doc!r}")
    unknown = set(doc) - _POLICY_KEYS
    if unknown:
        raise AutopilotError(
            f"policy #{index}: unknown keys {sorted(unknown)}")
    for key in ("name", "finding", "action"):
        v = doc.get(key)
        if not isinstance(v, str) or not v:
            raise AutopilotError(
                f"policy #{index}: {key!r} must be a non-empty string")
    action = doc["action"]
    if action not in ACTIONS:
        raise AutopilotError(
            f"policy #{index}: unknown action {action!r} "
            f"(known: {sorted(ACTIONS)})")
    key_field = doc.get("key_field")
    if key_field is not None and (not isinstance(key_field, str)
                                  or not key_field):
        raise AutopilotError(
            f"policy #{index}: 'key_field' must be a non-empty string")
    try:
        cooldown_s = float(doc.get("cooldown_s", DEFAULT_COOLDOWN_S))
        hysteresis = int(doc.get("hysteresis", 1))
        max_actions = int(doc.get("max_actions", DEFAULT_MAX_ACTIONS))
        window_s = float(doc.get("window_s", DEFAULT_WINDOW_S))
        horizon_steps = int(doc.get("horizon_steps",
                                    DEFAULT_HORIZON_STEPS))
        max_remesh_p50_s = float(doc.get("max_remesh_p50_s", 0.0))
        max_margin_frac = float(doc.get("max_margin_frac",
                                        DEFAULT_MAX_MARGIN_FRAC))
    except (TypeError, ValueError) as e:
        raise AutopilotError(
            f"policy #{index}: bad field value: {e}") from None
    if cooldown_s < 0 or window_s <= 0 or max_remesh_p50_s < 0:
        raise AutopilotError(
            f"policy #{index}: negative cooldown/window/p50 cap")
    if hysteresis < 1:
        raise AutopilotError(
            f"policy #{index}: hysteresis must be >= 1")
    if max_actions < 1:
        # a 0-action policy is a policy that can never fire: config bug
        raise AutopilotError(
            f"policy #{index}: max_actions must be >= 1 (remove the "
            "policy, or run HVD_TPU_AUTOPILOT=observe, to disable it)")
    if horizon_steps < 1:
        raise AutopilotError(
            f"policy #{index}: horizon_steps must be >= 1")
    if not (0.0 <= max_margin_frac <= 1.0):
        raise AutopilotError(
            f"policy #{index}: max_margin_frac must be in [0, 1]")
    return Policy(name=doc["name"], finding=doc["finding"], action=action,
                  cooldown_s=cooldown_s, hysteresis=hysteresis,
                  max_actions=max_actions, window_s=window_s,
                  key_field=key_field, horizon_steps=horizon_steps,
                  max_remesh_p50_s=max_remesh_p50_s,
                  max_margin_frac=max_margin_frac)


def parse_policies(doc: Union[str, Dict[str, Any]]) -> List[Policy]:
    """Parse + validate a policy document from a JSON string or an
    already-decoded dict; raises :class:`AutopilotError` on any schema
    violation (including duplicate policy names — decisions are keyed
    by name, two policies sharing one would corrupt the audit trail)."""
    if isinstance(doc, str):
        try:
            doc = json.loads(doc)
        except ValueError as e:
            raise AutopilotError(
                f"autopilot policy document is not valid JSON: {e}") \
                from None
    if not isinstance(doc, dict):
        raise AutopilotError(
            f"autopilot policy document must be an object, got "
            f"{type(doc).__name__}")
    unknown = set(doc) - {"policies"}
    if unknown:
        raise AutopilotError(f"unknown document keys {sorted(unknown)}")
    raw = doc.get("policies", [])
    if not isinstance(raw, list):
        raise AutopilotError("'policies' must be a list")
    policies = [_parse_policy(p, i) for i, p in enumerate(raw)]
    names = [p.name for p in policies]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise AutopilotError(f"duplicate policy names {dupes}")
    return policies


def default_policies() -> List[Policy]:
    """The shipped policy set — the four membership and tuning
    remediations, the two data-plane integrity ones, the serving SLO
    scale-out and the canary rollout's pair.  Used when
    ``HVD_TPU_AUTOPILOT_POLICY`` is unset; a custom document REPLACES
    it (policies are explicit, not merged)."""
    return [
        Policy(name="straggler-drain", finding="persistent_straggler",
               action="drain_and_replace"),
        Policy(name="hbm-planned-restart", finding="hbm_growth",
               action="commit_restart"),
        Policy(name="recompile-freeze", finding="recompile_storm",
               action="freeze_alert", hysteresis=2, key_field="function"),
        Policy(name="topology-retune", finding="world_changed",
               action="retune", cooldown_s=60.0),
        # a replica whose canary digest disagrees with the majority is
        # producing silently-wrong math (docs/TROUBLESHOOTING.md "My
        # replicas disagree"): one finding is enough — SDC does not
        # heal, and every step it stays in the allreduce poisons the
        # others' gradients
        Policy(name="replica-quarantine", finding="replica_divergence",
               action="quarantine_rank"),
        # persistent non-finite gradients (the guard's escalation,
        # train/guard.py): the optimizer state may already be poisoned
        # — roll back to the last durable commit rather than carry it
        Policy(name="nonfinite-rollback", finding="grad_nonfinite",
               action="rollback_restore"),
        # serving p99 over SLO for consecutive windows
        # (horovod_tpu_torch/serving/metrics.py): more replicas is the
        # remediation the fleet can apply itself; 60s cooldown — a
        # scale-out needs a replica cold-start before it can help,
        # re-firing faster than that just overshoots
        Policy(name="serving-slo-scaleout", finding="slo_breach",
               action="scale_out", cooldown_s=60.0),
        # canary weight rollout: the comparator reports one
        # rollout_verdict per evaluation window; the verdict gate
        # routes it to exactly one of these.  Promotion advances
        # through MULTIPLE stages (canary → 50% → fleet-wide) within
        # one rollout, so its cooldown is just hysteresis against a
        # duplicate report and its budget covers every stage; rollback
        # is one-shot per rollout and keeps the conservative defaults
        Policy(name="rollout-promote", finding="rollout_verdict",
               action="promote_rollout", cooldown_s=1.0,
               max_actions=6, window_s=3600.0),
        Policy(name="rollout-rollback", finding="rollout_verdict",
               action="rollback_rollout", cooldown_s=60.0),
    ]


def load_policies_from_env() -> List[Policy]:
    """The policy set named by ``HVD_TPU_AUTOPILOT_POLICY`` (inline JSON
    when the value starts with ``{``, else a file path); the default
    set when unset."""
    raw = os.environ.get("HVD_TPU_AUTOPILOT_POLICY", "").strip()
    if not raw:
        return default_policies()
    if not raw.startswith("{"):
        try:
            with open(raw) as f:
                raw = f.read()
        except OSError as e:
            raise AutopilotError(
                f"HVD_TPU_AUTOPILOT_POLICY names an unreadable file: {e}"
            ) from None
    return parse_policies(raw)


def mode() -> str:
    """``HVD_TPU_AUTOPILOT`` ∈ {off, observe, act}; default observe.
    An unknown value degrades to ``observe`` with a warning — the safe
    mode records everything and touches nothing."""
    from horovod_tpu_torch.common.config import env_str
    m = env_str("AUTOPILOT", "observe").strip().lower()
    if m not in MODES:
        try:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning(
                "HVD_TPU_AUTOPILOT=%r is not one of %s; running in "
                "'observe'", m, MODES)
        except Exception:
            pass
        return "observe"
    return m
