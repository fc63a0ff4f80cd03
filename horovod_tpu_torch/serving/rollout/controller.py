"""The rollout controller: a governed train→serve transition.

State machine (docs/SERVING.md "Canary rollout")::

    idle ──begin()──▶ canary ──promote──▶ expanding ──promote──▶ promoted
                        │                     │
                        └──────rollback───────┴──▶ rolling_back ──▶ rolled_back

``begin(candidate, incumbent)`` pins a canary subset of fleet slots to
the candidate commit (heal pin = the INCUMBENT: a crashed canary's
replacement must shrink the canary, not re-grow it), pins the rest to
the incumbent (an unpinned replica would chase latest — which IS the
candidate — and silently widen the canary), and installs the router's
version split.  From there the controller only MEASURES:
``evaluate()`` reduces the stage's request-log window (plus the
optional golden-request quality probe) to a ``rollout_verdict``
finding, and the AUTOPILOT decides — the ``rollout-promote`` /
``rollout-rollback`` policies gate on the verdict and call back into
:meth:`_on_promote` / :meth:`_on_rollback` through the registered
action hooks.  In ``observe`` mode the decision stream shows exactly
what ``act`` would have done, and the rollout simply holds at its
current stage.

Every transition — begin, each verdict, each repin — continues ONE
trace id rooted at ``begin()`` (the finding carries the controller's
traceparent; the anomaly engine, the decision, and the action hooks
all child from it), so ``python -m horovod_tpu_torch.diagnostics trace <id>``
prints the whole governed transition as a single causal tree.

Rollback leaves every slot PINNED to the incumbent: the poisoned
candidate is still the newest commit in the store, and an unpinned
replica would hot-swap right back into it.  Clearing the pins is the
operator's explicit decision (or the next ``begin()``'s).

A copy of ``horovod_tpu/serving/rollout/controller.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from horovod_tpu_torch import tracing
from horovod_tpu_torch.common.config import env_float, env_int, env_str
from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.metrics.anomaly import report_finding
from horovod_tpu_torch.serving import metrics as smetrics
from horovod_tpu_torch.serving.rollout import comparator

STATUS_FILE = "rollout_status.json"


def _flight(kind: str, **fields) -> None:
    try:
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event(kind, **fields)
    except Exception:
        pass


@dataclasses.dataclass
class RolloutConfig:
    """Knobs (KNOBS.md): env defaults, constructor overrides."""

    canary_pct: int = 25          # first-stage traffic share
    expand_pct: int = 50          # second stage before fleet-wide
    window_s: float = 5.0         # min seconds per evaluation window
    min_requests: int = 20        # per ARM before any verdict
    max_p99_ratio: float = 2.0    # canary p99 cap vs incumbent p99
    max_error_rate: float = 0.05  # canary error-rate cap
    golden_path: str = ""         # golden request set ("" = no probe)
    golden_max: float = 0.5       # max |y_canary - y_incumbent|

    @classmethod
    def from_env(cls) -> "RolloutConfig":
        return cls(
            canary_pct=env_int("ROLLOUT_CANARY_PCT", 25),
            expand_pct=env_int("ROLLOUT_EXPAND_PCT", 50),
            window_s=env_float("ROLLOUT_WINDOW_S", 5.0),
            min_requests=env_int("ROLLOUT_MIN_REQUESTS", 20),
            max_p99_ratio=env_float("ROLLOUT_MAX_P99_RATIO", 2.0),
            max_error_rate=env_float("ROLLOUT_MAX_ERROR_RATE", 0.05),
            golden_path=env_str("ROLLOUT_GOLDEN_SET", ""),
            golden_max=env_float("ROLLOUT_GOLDEN_MAX_DIVERGENCE", 0.5))


class RolloutController:
    """Drives one rollout at a time over a fleet + router pair.

    ``fleet`` needs the :class:`~horovod_tpu_torch.serving.fleet.ReplicaFleet`
    rollout surface — ``slots()``, ``pin_slot()``, ``unpin_slot()``,
    ``endpoints_at(version)`` — so tests can substitute an in-process
    adapter.  ``router`` is the live :class:`Router` whose request log
    the comparator reads.
    """

    def __init__(self, fleet: Any, router: Any,
                 config: Optional[RolloutConfig] = None,
                 store_dir: Optional[str] = None) -> None:
        self.fleet = fleet
        self.router = router
        self.config = config or RolloutConfig.from_env()
        self.store_dir = store_dir
        self.state = "idle"
        self.rollout_id: Optional[str] = None
        self.candidate: Optional[int] = None
        self.incumbent: Optional[int] = None
        self.canary_slots: List[int] = []
        self.trace = None
        self.history: List[dict] = []  # transition audit
        self._seq = 0
        self._stage_started = 0.0
        self._stage_log_start = 0
        self._lock = threading.RLock()
        smetrics.set_rollout_state(self.state)

    # -- state machine -------------------------------------------------------
    def _set_state(self, state: str, **fields) -> None:
        prev = self.state
        self.state = state
        smetrics.set_rollout_state(state)
        smetrics.inc_rollout_transition(state)
        ctx = tracing.child(self.trace, "rollout")
        tracing.record_span("rollout", f"state:{state}", ctx,
                            start=time.time(), dur_s=0.0,
                            rollout=self.rollout_id,
                            prev=prev, **fields)
        self.history.append({"ts": round(time.time(), 3), "from": prev,
                             "to": state, **fields})
        _flight("rollout_transition", rollout=self.rollout_id,
                prev=prev, state=state, **fields)
        get_logger().warning("rollout %s: %s -> %s %s", self.rollout_id,
                             prev, state, fields or "")
        self._persist()

    def _new_stage(self) -> None:
        """Each traffic stage measures a FRESH window — evidence from
        a 25% canary must not leak into the 50% stage's verdict.  The
        anchor is the log's absolute sequence number, not a list
        index: the in-memory trim deletes head entries, and an index
        anchor would over-skip current-stage evidence after each
        trim."""
        self._stage_started = time.time()
        self._stage_log_start = self.router.log.seq_now()

    def begin(self, candidate: int, incumbent: int) -> dict:
        """Start a rollout: pin the canary subset to ``candidate``
        (healing at ``incumbent``), pin the rest to ``incumbent``, and
        split traffic.  Returns the initial status doc."""
        with self._lock:
            if self.state not in ("idle", "promoted", "rolled_back"):
                raise RuntimeError(
                    f"rollout already in progress (state={self.state})")
            self._seq += 1
            self.candidate = int(candidate)
            self.incumbent = int(incumbent)
            self.rollout_id = f"rollout-{self._seq}-v{candidate}"
            self.trace = tracing.new_trace("rollout")
            slots = list(self.fleet.slots())
            if len(slots) < 2:
                # the canary invariant is "at least 1, never the whole
                # fleet": a 1-slot fleet cannot keep an incumbent arm,
                # so there would be nothing to compare against and no
                # endpoint for the golden probe's incumbent side
                raise RuntimeError(
                    "rollout: need at least 2 live slots (canary + "
                    f"incumbent arm), have {len(slots)}")
            n_canary = max(1, round(len(slots)
                                    * self.config.canary_pct / 100.0))
            n_canary = min(n_canary, len(slots) - 1)
            self.canary_slots = slots[:n_canary]
            with tracing.activate(self.trace):
                for slot in slots:
                    if slot in self.canary_slots:
                        self.fleet.pin_slot(
                            slot, self.candidate, reason="pin",
                            heal_version=self.incumbent)
                    else:
                        # an unpinned replica chases latest — which IS
                        # the candidate: the incumbent arm must be
                        # pinned too or the canary silently widens
                        self.fleet.pin_slot(slot, self.incumbent,
                                            reason="pin")
                self._install_split(self.config.canary_pct)
            self._new_stage()
            self._set_state("canary", candidate=self.candidate,
                            incumbent=self.incumbent,
                            canary_slots=list(self.canary_slots),
                            pct=self.config.canary_pct)
            return self.status()

    def _install_split(self, pct: int) -> None:
        fleet, cand, inc = self.fleet, self.candidate, self.incumbent
        self.router.set_version_split(
            pct,
            lambda: fleet.endpoints_at(cand),
            lambda: fleet.endpoints_at(inc),
            canary_version=cand, incumbent_version=inc)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, force: bool = False) -> Optional[dict]:
        """Reduce the current stage's evidence to a ``rollout_verdict``
        finding (returned), or ``None`` when the stage window is still
        open / traffic is insufficient / no rollout is live.  The
        finding carries the rollout's traceparent, so the autopilot
        decision and action it triggers continue the SAME trace."""
        with self._lock:
            if self.state not in ("canary", "expanding"):
                return None
            if not force and time.time() - self._stage_started \
                    < self.config.window_s:
                return None
            entries = self.router.log.since(self._stage_log_start)
            stats = comparator.version_windows(
                entries, [self.candidate, self.incumbent])
            canary = stats[self.candidate]
            incumbent = stats[self.incumbent]
            golden = None
            if self.config.golden_path:
                golden = self._golden_probe()
            verdict, reason = comparator.compare(
                canary, incumbent,
                min_requests=self.config.min_requests,
                max_p99_ratio=self.config.max_p99_ratio,
                max_error_rate=self.config.max_error_rate,
                golden_divergence=golden,
                golden_max=self.config.golden_max)
            _flight("rollout_evaluate", rollout=self.rollout_id,
                    state=self.state, verdict=verdict, reason=reason,
                    golden_divergence=golden,
                    canary_requests=canary["requests"],
                    incumbent_requests=incumbent["requests"])
            if verdict is None:
                return None
            smetrics.inc_rollout_verdict(verdict)
            fields: Dict[str, Any] = {
                "verdict": verdict, "reason": reason,
                "rollout_id": self.rollout_id,
                "candidate": self.candidate,
                "incumbent": self.incumbent,
                "state": self.state,
                "canary_stats": canary, "incumbent_stats": incumbent}
            if golden is not None:
                fields["golden_divergence"] = round(golden, 6)
            if self.trace is not None:
                fields[tracing.TRACEPARENT] = self.trace.traceparent
            return report_finding("rollout_verdict", **fields)

    def _golden_probe(self) -> Optional[float]:
        """Max output divergence candidate vs incumbent on the golden
        set; ``inf`` when the probe itself fails (an unanswerable
        canary is rollback evidence, not a skip)."""
        canary_eps = self.fleet.endpoints_at(self.candidate)
        incumbent_eps = self.fleet.endpoints_at(self.incumbent)
        if not canary_eps or not incumbent_eps:
            return None  # mid-heal: no arm to probe yet
        try:
            requests = comparator.load_golden_set(self.config.golden_path)
            return comparator.golden_divergence(
                canary_eps[0], incumbent_eps[0], requests)
        except Exception:
            get_logger().warning(
                "rollout %s: golden probe failed — counting it as "
                "divergence", self.rollout_id, exc_info=True)
            return float("inf")

    # -- autopilot action hooks ---------------------------------------------
    def register_autopilot_hooks(self) -> "RolloutController":
        """Wire this controller as the promote/rollback remediation
        target (the serving analog of
        ``ReplicaFleet.register_autopilot_hook``)."""
        from horovod_tpu_torch.autopilot import actions
        actions.register_promote_rollout_hook(self._on_promote)
        actions.register_rollback_rollout_hook(self._on_rollback)
        return self

    def _on_promote(self, finding: dict) -> None:
        with self._lock:
            if finding.get("rollout_id") not in (None, self.rollout_id):
                return  # a stale finding from a previous rollout
            if self.state == "canary":
                self._install_split(self.config.expand_pct)
                self._new_stage()
                self._set_state("expanding",
                                pct=self.config.expand_pct)
            elif self.state == "expanding":
                # fleet-wide: flip every slot to the candidate, then
                # unpin — chase-latest and the candidate now agree
                for slot in self.fleet.slots():
                    self.fleet.pin_slot(slot, self.candidate,
                                        reason="pin")
                    self.fleet.unpin_slot(slot)
                self.router.clear_version_split()
                self.canary_slots = []
                self._set_state("promoted", version=self.candidate)

    def _on_rollback(self, finding: dict) -> None:
        with self._lock:
            if finding.get("rollout_id") not in (None, self.rollout_id):
                return
            if self.state not in ("canary", "expanding"):
                return
            self._set_state("rolling_back",
                            reason=finding.get("reason"))
            # EVERY slot ends pinned to the incumbent — the poisoned
            # candidate is still the newest commit in the store, and
            # an unpinned replica would hot-swap right back into it.
            # The repin is the same atomic between-batch flip as a hot
            # swap: in-flight requests finish on the version that
            # computed them, zero requests fail
            for slot in self.fleet.slots():
                self.fleet.pin_slot(slot, self.incumbent,
                                    reason="rollback")
            self.router.clear_version_split()
            self.canary_slots = []
            self._set_state("rolled_back", version=self.incumbent)

    def rollback(self, reason: str = "manual") -> None:
        """Operator escape hatch (docs/SERVING.md "Canary rollout"
        runbook): force the rollback path without waiting for a
        verdict.  Idempotent — a no-op outside canary/expanding."""
        self._on_rollback({"rollout_id": self.rollout_id,
                           "reason": reason})

    # -- status --------------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            split = None
            try:
                split = self.router.version_split()
            except Exception:
                pass
            doc = {
                "rollout_id": self.rollout_id,
                "state": self.state,
                "candidate": self.candidate,
                "incumbent": self.incumbent,
                "canary_slots": list(self.canary_slots),
                "split": split,
                "history": list(self.history),
                "updated_at": round(time.time(), 3),
            }
            if self.trace is not None:
                doc["trace"] = self.trace.trace_id
            return doc

    def _persist(self) -> None:
        """Durable status (atomic rename) so ``python -m
        horovod_tpu_torch.serving rollout status`` answers from OUTSIDE the
        controller process — the stuck-rollout runbook's first stop."""
        if not self.store_dir:
            return
        try:
            path = os.path.join(self.store_dir, STATUS_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.status(), f, indent=1)
            os.replace(tmp, path)
        except OSError:
            get_logger().warning("rollout: status persist failed",
                                 exc_info=True)


def read_status(store_dir: str) -> Optional[dict]:
    """The persisted status doc, or ``None`` when no rollout ever ran
    against this store."""
    try:
        with open(os.path.join(store_dir, STATUS_FILE)) as f:
            return json.load(f)
    except OSError:
        return None
    except ValueError:
        return None
