"""The policy engine: anomaly findings in, audited decisions out.

One :class:`PolicyEngine` per process, subscribed to every finding the
anomaly engine flags (:mod:`horovod_tpu_torch.metrics.anomaly` calls
:func:`horovod_tpu_torch.autopilot.on_finding` from ``_flag`` — the native
step/fleet detectors and external ``report_finding()`` detectors take
the identical path).  For each finding it evaluates the matching
policies' gates IN ORDER — hysteresis, cooldown, action budget, then
the action-specific SLO gate — and emits exactly one decision per
(policy, finding):

* ``fired``      — all gates passed and ``HVD_TPU_AUTOPILOT=act``: the
  remediation dispatches (:mod:`horovod_tpu_torch.autopilot.actions`);
* ``dry_run``    — all gates passed under ``observe``: the decision is
  recorded IDENTICALLY (cooldown and budget bookkeeping advance the
  same way), nothing acts — run the same chaos plan under both modes
  and the audit trails must match except for the outcome field;
* ``suppressed`` — a gate refused, with the reason
  (``hysteresis`` / ``cooldown`` / ``budget`` / ``slo``) and the gate's
  inputs recorded.

Every decision lands four ways (docs/OBSERVABILITY.md "Autopilot"):
``hvd_autopilot_decisions_total{policy=,outcome=}`` (and
``hvd_autopilot_actions_total{action=}`` for fired ones) on
``/metrics``, an ``autopilot_decision`` flight event carrying the gate
inputs, a bounded in-memory ring the autopsy summary embeds under
``actions``, and — when ``HVD_TPU_OBS_DIR`` is set — an append-only
``actions_rank<r>.jsonl`` log rendered by
``python -m horovod_tpu_torch.metrics history --actions``.

The drain_and_replace SLO gate is the re-mesh timeline history
(docs/OBSERVABILITY.md "Re-mesh timeline"): the measured p50 recovery
cost of past episodes, against the straggler's projected loss over the
policy's horizon — the cure must beat the disease, with receipts.

A copy of ``horovod_tpu/autopilot/engine.py``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from horovod_tpu_torch.autopilot.policy import (Policy, load_policies_from_env,
                                          mode as policy_mode)

MAX_DECISIONS = 256

_MODE_VALUE = {"off": 0.0, "observe": 1.0, "act": 2.0}


def _median(values: List[float]) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def remesh_p50_s() -> Optional[float]:
    """Measured p50 of completed re-mesh episodes, from the time-series
    history (the in-memory ring plus, when ``HVD_TPU_OBS_DIR`` is set,
    the persisted JSONL — a restarted rank 0 keeps its evidence).
    None when no episode was ever measured: with no evidence a re-mesh
    is expensive, the gate has nothing to refuse on."""
    def _key(p, v):
        return (p.get("ts"), round(float(v), 6))

    totals: List[float] = []
    try:
        from horovod_tpu_torch.metrics import timeseries
        d = timeseries.obs_dir()
        disk = timeseries.read_series(d) if d else []
        disk_keys = set()
        for p in disk:
            v = p.get("remesh_total_s")
            if isinstance(v, (int, float)) and p.get("complete", True):
                totals.append(float(v))
                disk_keys.add(_key(p, v))
        for p in timeseries.recorder().ring.points():
            v = p.get("remesh_total_s")
            if isinstance(v, (int, float)) and p.get("complete", True):
                # an episode still in the ring is usually ALSO on disk
                # (the recorder writes both); counting it twice would
                # weight the p50 toward recent episodes and skew the
                # SLO gate — only ring points the disk does not already
                # hold (persistence off, write failed, rotated away)
                # contribute
                if _key(p, v) in disk_keys:
                    continue
                totals.append(float(v))
    except Exception:
        return None
    return _median(totals)


class _PolicyState:
    """Per-(policy, key) gate bookkeeping."""

    def __init__(self) -> None:
        self.streak = 0
        self.cooldown_until = 0.0
        self.fired_at: Deque[float] = collections.deque()


class PolicyEngine:
    """Evaluate findings against the policy set; record every decision.

    ``mode``/``policies``/``registry`` are injectable for tests; the
    process-wide instance reads them from env
    (:func:`horovod_tpu_torch.autopilot.default_engine`).
    """

    def __init__(self, policies: Optional[List[Policy]] = None,
                 registry=None, mode: Optional[str] = None,
                 rank: Optional[int] = None) -> None:
        self.policies = load_policies_from_env() \
            if policies is None else list(policies)
        self.mode = policy_mode() if mode is None else mode
        self._by_finding: Dict[str, List[Policy]] = {}
        for p in self.policies:
            self._by_finding.setdefault(p.finding, []).append(p)
        self._reg = registry
        self._lock = threading.Lock()
        self._state: Dict[tuple, _PolicyState] = {}
        self.decisions: Deque[dict] = collections.deque(
            maxlen=MAX_DECISIONS)
        if rank is None:
            from horovod_tpu_torch.diagnostics.flight_recorder import (
                _best_effort_rank)
            rank = _best_effort_rank()
        self.rank = rank
        self._writer = None
        self._writer_dir = None
        # own lock: _log_jsonl runs from _decide, which suppressed-path
        # callers may reach with gate state of their own in play — the
        # writer must never share the gate lock
        self._writer_lock = threading.Lock()
        try:
            self._registry().gauge(
                "hvd_autopilot_mode",
                help="autopilot mode (0=off, 1=observe, 2=act)").set(
                _MODE_VALUE.get(self.mode, 1.0))
        except Exception:
            pass

    def _registry(self):
        if self._reg is None:
            from horovod_tpu_torch.metrics.registry import default_registry
            self._reg = default_registry()
        return self._reg

    def refresh_identity(self) -> None:
        """Re-read this process's rank — an elastic re-mesh can
        renumber us, and the engine deliberately SURVIVES re-init (its
        cooldown/budget state must not reset with every world change),
        so the identity stamped into decisions and the JSONL filename
        has to follow the live env instead (the preemption watcher
        makes the same call)."""
        from horovod_tpu_torch.diagnostics.flight_recorder import (
            _best_effort_rank)
        rank = _best_effort_rank()
        with self._writer_lock:
            if rank != self.rank:
                self.rank = rank
                self._writer = None  # reopen as actions_rank<new>
                self._writer_dir = None

    # -- the subscription seam ----------------------------------------------
    def on_finding(self, finding: dict) -> List[dict]:
        """Evaluate one finding; returns the decisions recorded (one per
        matching policy, [] when no policy subscribes to the kind).
        Called with the anomaly engine's lock held — everything here is
        in-process bookkeeping; a fired action's KV traffic happens on a
        background thread (:mod:`horovod_tpu_torch.autopilot.actions`)."""
        kind = finding.get("kind")
        out = []
        for policy in self._by_finding.get(kind, ()):
            try:
                out.append(self._evaluate(policy, finding))
            except Exception:
                # a broken gate must never break detection
                try:
                    from horovod_tpu_torch.common.logging import get_logger
                    get_logger().warning(
                        "autopilot: policy %r failed on finding %r",
                        policy.name, kind, exc_info=True)
                except Exception:
                    pass
        return out

    # -- gates ---------------------------------------------------------------
    def _evaluate(self, policy: Policy, finding: dict) -> dict:
        key = None
        if policy.key_field is not None:
            key = finding.get(policy.key_field)
        now = time.monotonic()
        gate: Dict[str, Any] = {}
        # the gate verdict is computed under the lock; the decision is
        # RECORDED outside it (_decide fans out to the JSONL writer,
        # registry, and flight ring — none of which may nest under this
        # non-reentrant lock)
        reason: Optional[str] = None
        with self._lock:
            st = self._state.setdefault((policy.name, key),
                                        _PolicyState())
            st.streak += 1
            gate["streak"] = st.streak
            if st.streak < policy.hysteresis:
                gate["hysteresis"] = policy.hysteresis
                reason = "hysteresis"
            elif now < st.cooldown_until:
                gate["cooldown_remaining_s"] = round(
                    st.cooldown_until - now, 1)
                reason = "cooldown"
            else:
                while st.fired_at and \
                        now - st.fired_at[0] > policy.window_s:
                    st.fired_at.popleft()
                gate["actions_in_window"] = len(st.fired_at)
                if len(st.fired_at) >= policy.max_actions:
                    gate["max_actions"] = policy.max_actions
                    reason = "budget"
        if reason is not None:
            return self._decide(policy, finding, key, "suppressed",
                                reason, gate)
        ok, slo_gate = self._slo_gate(policy, finding)
        gate.update(slo_gate)
        if not ok:
            return self._decide(policy, finding, key, "suppressed",
                                "slo", gate)
        # all gates passed: the decision is made — observe records it
        # without acting, and the bookkeeping advances IDENTICALLY so
        # both modes produce the same decision stream
        with self._lock:
            st = self._state[(policy.name, key)]
            st.streak = 0
            st.cooldown_until = now + policy.cooldown_s
            st.fired_at.append(now)
        outcome = "fired" if self.mode == "act" else "dry_run"
        decision = self._decide(policy, finding, key, outcome, None, gate)
        if outcome == "fired":
            try:
                self._registry().counter(
                    "hvd_autopilot_actions_total",
                    help="autopilot remediations dispatched, per action",
                    labels={"action": policy.action}).inc()
            except Exception:
                pass
            from horovod_tpu_torch.autopilot import actions
            actions.dispatch(policy, finding, decision)
        return decision

    def _slo_gate(self, policy: Policy, finding: dict) -> tuple:
        """(passes, gate-inputs) for the policy's action.  Every input
        consulted lands in the decision — a suppressed remediation must
        say what number stopped it."""
        if policy.action == "drain_and_replace":
            gate: Dict[str, Any] = {"horizon_steps": policy.horizon_steps}
            p50 = remesh_p50_s()
            gate["remesh_p50_s"] = round(p50, 4) if p50 is not None \
                else None
            excess = None
            win = finding.get("win_step_time")
            mean = finding.get("fleet_mean")
            if isinstance(win, (int, float)) and \
                    isinstance(mean, (int, float)):
                excess = max(0.0, float(win) - float(mean))
                gate["straggler_excess_s"] = round(excess, 4)
                gate["projected_loss_s"] = round(
                    excess * policy.horizon_steps, 4)
            if policy.max_remesh_p50_s > 0 and p50 is not None \
                    and p50 > policy.max_remesh_p50_s:
                gate["max_remesh_p50_s"] = policy.max_remesh_p50_s
                return False, gate
            if p50 is not None and excess is not None \
                    and excess * policy.horizon_steps <= p50:
                # the cure measurably costs more than the disease
                return False, gate
            return True, gate
        if policy.action == "commit_restart":
            gate = {"max_margin_frac": policy.max_margin_frac}
            margin = limit = None
            try:
                reg = self._registry()
                m = reg.get("hvd_hbm_oom_margin_bytes")
                li = reg.get("hvd_hbm_limit_bytes")
                margin = m.value if m is not None else None
                limit = li.value if li is not None else None
            except Exception:
                pass
            gate["oom_margin_bytes"] = margin
            gate["limit_bytes"] = limit
            if not limit:
                # growth alone is not "past the OOM margin": without a
                # margin measurement the planned restart stays parked
                return False, gate
            frac = max(0.0, float(margin or 0.0)) / float(limit)
            gate["margin_frac"] = round(frac, 4)
            return frac < policy.max_margin_frac, gate
        if policy.action in ("promote_rollout", "rollback_rollout"):
            # both rollout policies subscribe to the SAME
            # rollout_verdict finding; the verdict field routes it to
            # exactly one of them — the other's decision is suppressed
            # here with the mismatched verdict recorded as the reason
            want = "promote" if policy.action == "promote_rollout" \
                else "rollback"
            verdict = finding.get("verdict")
            return verdict == want, {"verdict": verdict, "want": want}
        return True, {}

    # -- the audit trail -----------------------------------------------------
    def _decide(self, policy: Policy, finding: dict, key,
                outcome: str, reason: Optional[str],
                gate: Dict[str, Any]) -> dict:
        decision = {
            "ts": round(time.time(), 3),
            "policy": policy.name,
            "action": policy.action,
            "finding": finding.get("kind"),
            "outcome": outcome,
            "mode": self.mode,
            "rank": self.rank,
            "gate": gate,
        }
        try:
            # continue the finding's trace: the decision is a child
            # span, and fired remediations child from the decision (the
            # action/ doc carries decision["traceparent"] to the
            # driver) — docs/OBSERVABILITY.md "Causal tracing"
            from horovod_tpu_torch import tracing
            dctx = tracing.child(
                tracing.decode(finding.get(tracing.TRACEPARENT)),
                "autopilot")
            if dctx is not None:
                decision.update(dctx.fields())
                decision[tracing.TRACEPARENT] = dctx.traceparent
        except Exception:
            pass
        if reason is not None:
            decision["reason"] = reason
        if key is not None:
            decision["key"] = key
        if isinstance(finding.get("rank"), int):
            decision["target_rank"] = finding["rank"]
        if isinstance(finding.get("step"), int):
            decision["step"] = finding["step"]
        self.decisions.append(decision)
        try:
            self._registry().counter(
                "hvd_autopilot_decisions_total",
                help="autopilot policy decisions, per policy and outcome",
                labels={"policy": policy.name,
                        "outcome": outcome}).inc()
        except Exception:
            pass
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import (
                record_event)
            record_event("autopilot_decision",
                         **{k: v for k, v in decision.items()
                            if k not in ("ts", "traceparent")})
        except Exception:
            pass
        self._log_jsonl(decision)
        try:
            from horovod_tpu_torch.common.logging import get_logger
            log = get_logger()
            if outcome == "fired":
                log.warning("autopilot: FIRING %s (policy %s) on %s %s",
                            policy.action, policy.name,
                            decision["finding"], gate)
            elif outcome == "dry_run":
                log.warning("autopilot[observe]: would fire %s (policy "
                            "%s) on %s %s", policy.action, policy.name,
                            decision["finding"], gate)
            else:
                log.info("autopilot: suppressed %s (policy %s, %s) %s",
                         policy.action, policy.name, reason, gate)
        except Exception:
            pass
        return decision

    def _log_jsonl(self, decision: dict) -> None:
        """Bounded action log (``HVD_TPU_OBS_DIR`` unset = ring only),
        same writer/size-rotation machinery as the step series —
        ``actions_rank<r>.jsonl`` rotates at
        ``HVD_TPU_ACTIONS_MAX_BYTES`` (default: the OBS store's bound)
        with one previous generation kept; ``history --actions`` reads
        across the boundary."""
        try:
            from horovod_tpu_torch.common.config import env_int
            from horovod_tpu_torch.metrics import timeseries
            d = timeseries.obs_dir()
            if not d:
                return
            with self._writer_lock:
                if self._writer is None or self._writer_dir != d:
                    self._writer = timeseries.SeriesWriter(
                        d, rank=self.rank, basename="actions",
                        max_bytes=env_int("ACTIONS_MAX_BYTES", 0)
                        or None)
                    self._writer_dir = d
                writer = self._writer
            writer.write(decision)
        except Exception:
            pass

    def recent_decisions(self, last_n: int = MAX_DECISIONS) -> List[dict]:
        return list(self.decisions)[-last_n:]
