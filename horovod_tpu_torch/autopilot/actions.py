"""The wired remediations: what a fired policy actually does.

Two shapes (docs/OBSERVABILITY.md "Autopilot"):

* **Driver actions** (``drain_and_replace``, ``commit_restart``,
  ``quarantine_rank``) travel worker→driver as a JSON request PUT into
  the KV ``action/`` scope — relay-routed up the same tree as drain
  notices (:mod:`horovod_tpu_torch.runner.kv_relay`), consumed by the elastic
  driver's poll loop (``runner/elastic/driver.py``), which plans the
  target worker out of the world through the preemption-drain path: the
  exit is DRAINED, never FAILURE.
  ``drain_and_replace`` reserves the sick host for the drain cooldown
  (the replacement lands elsewhere when capacity exists);
  ``commit_restart`` leaves the host admitted so the planned restart
  respawns in place immediately — the drain-stamped world doc already
  guarantees the doomed worker's final durable commit is flushed
  before it exits (``elastic.run``'s preemption_drain branch);
  ``quarantine_rank`` is the one planned exit that IS held
  against the hardware — after the drain re-mesh succeeds the driver
  blocklists the divergent rank's host WITH the canary evidence that
  convicted it (silent data corruption is a device property, and a
  replacement landing back on the same chip would diverge again).
* **Local actions** (``freeze_alert``, ``retune``,
  ``rollback_restore``) act in-process: ``freeze_alert`` names the
  offending function loudly and adds it to the frozen set
  (``hvd_autopilot_frozen_functions``); ``retune`` invalidates the
  persistent autotune plan cache
  (:func:`horovod_tpu_torch.train.autotune.invalidate_plan_cache`) and runs
  any registered re-tune hooks in the background, so the next plan
  lookup re-searches against the CURRENT topology;
  ``rollback_restore`` runs the registered rollback hooks
  (:func:`register_rollback_hook`) so a run whose gradients went
  persistently non-finite restores the last durable checkpoint instead
  of committing a poisoned optimizer state forward.

Dispatch always happens on a short-lived daemon thread: the decision
itself is made under the anomaly engine's lock, and a KV round-trip
(or a slow shared filesystem) must never stall detection.

A copy of ``horovod_tpu/autopilot/actions.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, List, Optional, Set

from horovod_tpu_torch.autopilot.policy import Policy

_lock = threading.Lock()
_seq = 0
_frozen: Set[str] = set()
_retune_hooks: List[Callable[[], None]] = []
_rollback_hooks: List[Callable[[], None]] = []
_scale_out_hooks: List[Callable[[], None]] = []
_promote_rollout_hooks: List[Callable[[dict], None]] = []
_rollback_rollout_hooks: List[Callable[[dict], None]] = []

#: finding fields carried as quarantine EVIDENCE into the driver's
#: blocklist record (docs/OBSERVABILITY.md "Autopilot"): the canary
#: digests that convicted the rank travel with the action, so the
#: audit trail says WHY the host was blocklisted, not just that it was
_EVIDENCE_FIELDS = ("step", "digest", "majority", "world", "consecutive")


def dispatch(policy: Policy, finding: dict, decision: dict) -> None:
    """Run the policy's remediation asynchronously (never raises)."""
    t = threading.Thread(target=_run, args=(policy, finding, decision),
                         name=f"hvd-tpu-autopilot-{policy.action}",
                         daemon=True)
    t.start()


def _run(policy: Policy, finding: dict, decision: dict) -> None:
    try:
        if policy.action == "drain_and_replace":
            _request_driver_action("drain", int(finding["rank"]),
                                   policy, decision)
        elif policy.action == "commit_restart":
            _request_driver_action("restart", _own_rank(),
                                   policy, decision)
        elif policy.action == "quarantine_rank":
            _request_driver_action(
                "quarantine", int(finding["rank"]), policy, decision,
                evidence={k: finding[k] for k in _EVIDENCE_FIELDS
                          if k in finding})
        elif policy.action == "rollback_restore":
            rollback(policy, finding)
        elif policy.action == "scale_out":
            scale_out(policy, finding)
        elif policy.action == "promote_rollout":
            promote_rollout(policy, finding, decision)
        elif policy.action == "rollback_rollout":
            rollback_rollout(policy, finding, decision)
        elif policy.action == "freeze_alert":
            freeze(str(finding.get("function", "unknown")), policy,
                   finding)
        elif policy.action == "retune":
            retune(policy, finding)
    except Exception:
        try:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("autopilot: %s remediation failed",
                                 policy.action, exc_info=True)
        except Exception:
            pass


def _own_rank() -> int:
    v = os.environ.get("HOROVOD_RANK", os.environ.get("HVD_TPU_RANK",
                                                      "0"))
    try:
        return int(v)
    except ValueError:
        return 0


def _flight(kind: str, **fields) -> None:
    try:
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event(kind, **fields)
    except Exception:
        pass


# -- driver actions (the KV ``action/`` scope) --------------------------------
def _request_driver_action(kind: str, target_rank: int, policy: Policy,
                           decision: dict, evidence=None) -> bool:
    """PUT the action request at the elastic driver's KV, relay-routed.
    Returns False (with the evidence recorded) when no driver manages
    this job — a standalone run's decision is still a first-class audit
    artifact, it just has nobody to drain for it."""
    global _seq
    from horovod_tpu_torch.runner import kv_relay
    try:
        endpoint = kv_relay.elastic_kv_endpoint()
    except ValueError as e:
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().warning(
            "autopilot: %s; %s for rank %d dropped", e, kind,
            target_rank)
        return False
    if endpoint is None:
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().warning(
            "autopilot: %s for rank %d has nowhere to go: no elastic "
            "driver KV (HVD_ELASTIC_KV)", kind, target_rank)
        _flight("autopilot_action_unroutable", action=kind,
                target_rank=target_rank, policy=policy.name)
        return False
    addr, port_i = endpoint
    with _lock:
        _seq += 1
        seq = _seq
    body = {
        "action": kind,
        "rank": int(target_rank),
        "policy": policy.name,
        "finding": decision.get("finding"),
        "source": "autopilot",
        "from_rank": _own_rank(),
        "generation": int(os.environ.get("HVD_ELASTIC_GENERATION", "0")),
        "at": time.time()}
    if evidence:
        body["evidence"] = evidence
    # causal tracing: the action doc continues the decision's trace
    # (which continued the finding's) — the driver childs from the
    # embedded traceparent when it handles the request, so finding →
    # decision → action → drain → re-mesh share ONE trace id
    from horovod_tpu_torch import tracing
    actx = tracing.child(
        tracing.decode(decision.get(tracing.TRACEPARENT)), "autopilot")
    if actx is not None:
        body[tracing.TRACEPARENT] = actx.traceparent
    doc = json.dumps(body).encode()
    with tracing.activate(actx):
        kv_relay.client(addr, port_i).put(
            "action", f"{_own_rank()}-{seq}", doc, timeout=5.0,
            site="autopilot.action")
        _flight("autopilot_action_published", action=kind,
                target_rank=target_rank, policy=policy.name)
    return True


# -- local actions ------------------------------------------------------------
def freeze(function: str, policy: Optional[Policy] = None,
           finding: Optional[dict] = None) -> None:
    """Repeated recompile storms on one function: name it LOUDLY and
    add it to the frozen set.  The alert is the remediation — shape
    drift is a code bug only the owner can fix; what the autopilot can
    do is make sure the function's NAME reaches the operator through
    every channel instead of dying as compiler mush."""
    with _lock:
        _frozen.add(function)
        n = len(_frozen)
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        default_registry().gauge(
            "hvd_autopilot_frozen_functions",
            help="functions frozen by the recompile-storm policy"
        ).set(float(n))
    except Exception:
        pass
    _flight("autopilot_freeze", function=function,
            policy=policy.name if policy else None,
            compiles=(finding or {}).get("compiles"))
    try:
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().error(
            "autopilot: function %r is in a recompile storm (%s "
            "compiles) — its input shapes/dtypes are drifting every "
            "step; pin them (pad the ragged batch, hash-check traced "
            "python scalars).  See docs/TROUBLESHOOTING.md.",
            function, (finding or {}).get("compiles", "?"))
    except Exception:
        pass


def frozen_functions() -> Set[str]:
    with _lock:
        return set(_frozen)


def register_rollback_hook(fn: Callable[[], None]) -> None:
    """Training loops that own restorable durable state register a
    zero-arg callable here (typically ``lambda: state.restore()`` over
    an elastic ``ObjectState``, or a ``restore_latest`` into the live
    pytree); the ``rollback_restore`` remediation runs every hook in
    the background when persistent ``grad_nonfinite`` findings fire."""
    with _lock:
        _rollback_hooks.append(fn)


def rollback(policy: Optional[Policy] = None,
             finding: Optional[dict] = None) -> int:
    """Persistent non-finite gradients: the optimizer state advancing
    under a poisoned data plane must not be the state that commits
    forward — restore the last durable checkpoint through the
    registered hooks.  Returns how many hooks ran.  With no hooks
    registered the decision is still a first-class audit artifact; the
    alert names what SHOULD have been restored."""
    with _lock:
        hooks = list(_rollback_hooks)
    ran = 0
    for fn in hooks:
        try:
            fn()
            ran += 1
        except Exception:
            try:
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning(
                    "autopilot: rollback hook %r failed", fn,
                    exc_info=True)
            except Exception:
                pass
    _flight("autopilot_rollback", policy=policy.name if policy else None,
            hooks=len(hooks), ran=ran,
            step=(finding or {}).get("step"),
            consecutive=(finding or {}).get("consecutive"))
    try:
        from horovod_tpu_torch.common.logging import get_logger
        if hooks:
            get_logger().error(
                "autopilot: persistent non-finite gradients (%s "
                "consecutive skipped steps) — restored the last durable "
                "checkpoint via %d/%d rollback hook(s)",
                (finding or {}).get("consecutive", "?"), ran, len(hooks))
        else:
            get_logger().error(
                "autopilot: persistent non-finite gradients (%s "
                "consecutive skipped steps) and NO rollback hook is "
                "registered — restore the last committed checkpoint "
                "manually (docs/TROUBLESHOOTING.md \"My loss went "
                "NaN\")", (finding or {}).get("consecutive", "?"))
    except Exception:
        pass
    return ran


def register_scale_out_hook(fn: Callable[[], None]) -> None:
    """A serving fleet registers a zero-arg callable raising its
    replica target (``ReplicaFleet.register_autopilot_hook``); the
    ``scale_out`` remediation runs every hook when a sustained
    ``slo_breach`` finding fires (docs/SERVING.md)."""
    with _lock:
        _scale_out_hooks.append(fn)


def scale_out(policy: Optional[Policy] = None,
              finding: Optional[dict] = None) -> int:
    """Sustained serving SLO breach: capacity, not tuning, is the
    remediation the fleet owns — run the registered scale-out hooks.
    Returns how many ran; with none registered the decision is still a
    first-class audit artifact (the alert says what SHOULD have grown).
    """
    with _lock:
        hooks = list(_scale_out_hooks)
    ran = 0
    for fn in hooks:
        try:
            fn()
            ran += 1
        except Exception:
            try:
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning(
                    "autopilot: scale-out hook %r failed", fn,
                    exc_info=True)
            except Exception:
                pass
    _flight("autopilot_scale_out",
            policy=policy.name if policy else None, hooks=len(hooks),
            ran=ran, p99_s=(finding or {}).get("p99_s"),
            slo_s=(finding or {}).get("slo_s"))
    try:
        from horovod_tpu_torch.common.logging import get_logger
        if hooks:
            get_logger().error(
                "autopilot: serving p99 %.4fs over SLO %.4fs — scaled "
                "the replica fleet out via %d/%d hook(s)",
                (finding or {}).get("p99_s", float("nan")),
                (finding or {}).get("slo_s", float("nan")),
                ran, len(hooks))
        else:
            get_logger().error(
                "autopilot: serving SLO breach (p99 %s over %s) and NO "
                "scale-out hook is registered — grow the replica fleet "
                "manually (docs/SERVING.md runbook)",
                (finding or {}).get("p99_s"),
                (finding or {}).get("slo_s"))
    except Exception:
        pass
    return ran


def register_promote_rollout_hook(fn: Callable[[dict], None]) -> None:
    """A rollout controller registers a one-arg callable (receiving the
    ``rollout_verdict`` finding) that advances its canary stage; the
    ``promote_rollout`` remediation runs every hook when a "promote"
    verdict fires (docs/SERVING.md "Canary rollout")."""
    with _lock:
        _promote_rollout_hooks.append(fn)


def register_rollback_rollout_hook(fn: Callable[[dict], None]) -> None:
    """A rollout controller registers a one-arg callable (receiving the
    ``rollout_verdict`` finding) that repins every canary replica to
    the incumbent version; the ``rollback_rollout`` remediation runs
    every hook when a "rollback" verdict fires."""
    with _lock:
        _rollback_rollout_hooks.append(fn)


def _run_rollout_hooks(which: str, hooks: List[Callable[[dict], None]],
                       policy: Optional[Policy], finding: Optional[dict],
                       decision: Optional[dict]) -> int:
    """Shared promote/rollback machinery: run the hooks INSIDE the
    decision's trace (finding → decision → action → repin flips share
    one id — the whole governed transition is one causal tree), record
    the flight event, and alert loudly either way."""
    finding = finding or {}
    from horovod_tpu_torch import tracing
    actx = tracing.child(
        tracing.decode((decision or {}).get(tracing.TRACEPARENT)),
        "autopilot")
    ran = 0
    t0 = time.time()
    with tracing.activate(actx):
        for fn in hooks:
            try:
                fn(finding)
                ran += 1
            except Exception:
                try:
                    from horovod_tpu_torch.common.logging import get_logger
                    get_logger().warning(
                        "autopilot: %s hook %r failed", which, fn,
                        exc_info=True)
                except Exception:
                    pass
    tracing.record_span("autopilot", which, actx, start=t0,
                        dur_s=time.time() - t0,
                        rollout=finding.get("rollout_id"),
                        verdict=finding.get("verdict"))
    _flight(f"autopilot_{which}",
            policy=policy.name if policy else None, hooks=len(hooks),
            ran=ran, verdict=finding.get("verdict"),
            rollout_id=finding.get("rollout_id"),
            candidate=finding.get("candidate"),
            incumbent=finding.get("incumbent"))
    return ran


def promote_rollout(policy: Optional[Policy] = None,
                    finding: Optional[dict] = None,
                    decision: Optional[dict] = None) -> int:
    """A "promote" rollout verdict: the candidate version beat its SLO
    comparison against the incumbent — advance the canary stage via
    the registered hooks.  Returns how many ran; with none registered
    the decision is still a first-class audit artifact."""
    with _lock:
        hooks = list(_promote_rollout_hooks)
    ran = _run_rollout_hooks("promote_rollout", hooks, policy, finding,
                             decision)
    try:
        from horovod_tpu_torch.common.logging import get_logger
        f = finding or {}
        if hooks:
            get_logger().error(
                "autopilot: rollout %s — candidate v%s healthy vs "
                "incumbent v%s; advanced the canary stage via %d/%d "
                "hook(s)", f.get("rollout_id", "?"),
                f.get("candidate", "?"), f.get("incumbent", "?"),
                ran, len(hooks))
        else:
            get_logger().error(
                "autopilot: rollout %s verdict 'promote' and NO "
                "promote hook is registered — advance the rollout "
                "manually (docs/SERVING.md \"Canary rollout\")",
                f.get("rollout_id", "?"))
    except Exception:
        pass
    return ran


def rollback_rollout(policy: Optional[Policy] = None,
                     finding: Optional[dict] = None,
                     decision: Optional[dict] = None) -> int:
    """A "rollback" rollout verdict: the candidate version degraded
    latency/errors or diverged on the golden set — repin every canary
    replica to the incumbent through the registered hooks.  The repin
    is the same atomic between-batch flip as a hot swap, so in-flight
    requests finish on whichever version computed them and ZERO
    requests fail.  Returns how many hooks ran."""
    with _lock:
        hooks = list(_rollback_rollout_hooks)
    ran = _run_rollout_hooks("rollback_rollout", hooks, policy, finding,
                             decision)
    try:
        from horovod_tpu_torch.common.logging import get_logger
        f = finding or {}
        if hooks:
            get_logger().error(
                "autopilot: rollout %s — candidate v%s FAILED its "
                "canary vs incumbent v%s (%s); repinned every canary "
                "replica to the incumbent via %d/%d hook(s)",
                f.get("rollout_id", "?"), f.get("candidate", "?"),
                f.get("incumbent", "?"), f.get("reason", "verdict"),
                ran, len(hooks))
        else:
            get_logger().error(
                "autopilot: rollout %s verdict 'rollback' and NO "
                "rollback hook is registered — repin the canary "
                "replicas to the incumbent manually (docs/SERVING.md "
                "\"Canary rollout\" runbook)", f.get("rollout_id", "?"))
    except Exception:
        pass
    return ran


def register_retune_hook(fn: Callable[[], None]) -> None:
    """Training loops that hold a live autotuned step register a zero-
    arg callable here; the ``retune`` remediation runs every hook (in
    the background) after invalidating the plan cache."""
    with _lock:
        _retune_hooks.append(fn)


def retune(policy: Optional[Policy] = None,
           finding: Optional[dict] = None) -> int:
    """Topology/world change: drop every persisted autotune plan (the
    tuned plans encode the OLD world's measured tradeoffs) and kick the
    registered re-tune hooks.  Returns how many cache entries were
    invalidated."""
    removed = 0
    try:
        from horovod_tpu_torch.train.autotune import invalidate_plan_cache
        removed = invalidate_plan_cache()
    except Exception:
        try:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("autopilot: plan-cache invalidation "
                                 "failed", exc_info=True)
        except Exception:
            pass
    with _lock:
        hooks = list(_retune_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception:
            try:
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning("autopilot: retune hook %r failed",
                                     fn, exc_info=True)
            except Exception:
                pass
    _flight("autopilot_retune", policy=policy.name if policy else None,
            invalidated=removed, hooks=len(hooks),
            old_size=(finding or {}).get("old_size"),
            new_size=(finding or {}).get("new_size"))
    try:
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().warning(
            "autopilot: topology change — invalidated %d cached "
            "autotune plan(s), ran %d retune hook(s)", removed,
            len(hooks))
    except Exception:
        pass
    return removed


def reset() -> None:
    """Tests: forget frozen functions, hooks, and the action sequence."""
    global _seq
    with _lock:
        _frozen.clear()
        _retune_hooks.clear()
        _rollback_hooks.clear()
        _scale_out_hooks.clear()
        _promote_rollout_hooks.clear()
        _rollback_rollout_hooks.clear()
        _seq = 0
