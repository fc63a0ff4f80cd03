"""Declarative fault plans: schema, validation, deterministic schedules.

A fault plan is a JSON document (inline in ``HVD_TPU_FAULT_PLAN`` or a
path to a file) describing WHICH seams misbehave, WHEN, and HOW:

.. code-block:: json

    {
      "seed": 7,
      "faults": [
        {"seam": "step", "kind": "kill", "rank": 2, "start": 3,
         "count": 1, "marker": "/tmp/job/killed_once"},
        {"seam": "kv.request", "kind": "blackout", "start": 2, "stop": 6},
        {"seam": "transport.recv", "kind": "delay", "rank": 1, "peer": 0,
         "start": 10, "count": 20, "delay_ms": 30},
        {"seam": "checkpoint.write", "kind": "io_error", "rank": 0,
         "start": 1, "count": 1}
      ]
    }

Rule fields:

* ``seam`` (required) — one of the :data:`SEAMS` catalog below.
* ``kind`` (required) — the fault flavor, validated per seam.
* ``rank`` — int, list of ints, or ``"*"`` (default): which ranks arm
  this rule.  Matched against the worker's launched rank at install time
  (re-evaluated on elastic re-init, when ranks can renumber).
* ``start`` / ``stop`` — half-open invocation window ``[start, stop)``
  over the seam's 0-based invocation index (for the ``step`` seam the
  index IS the training step the caller passes).  Defaults: whole run.
* ``count`` — at most this many fires per process (0 = unlimited).
* ``probability`` — per-invocation chance in ``(0, 1]``; the draw is a
  pure function of ``(seed, rule, index)``, so the same plan + seed
  yields the same fire schedule on every run and every rank.
* ``marker`` — optional filesystem path making the rule at-most-once
  ACROSS process restarts: a rule whose marker file exists is disarmed,
  and firing creates it.  Without this, a ``step``-seam ``kill`` under an
  elastic driver would kill every replacement at the same step forever.
  A ``{rank}`` placeholder expands to the firing rank — one correlated
  multi-host rule (``"rank": [2, 3]``) then takes out EVERY rank of the
  group exactly once each, instead of the first kill's marker disarming
  the rest of the group.
* ``groups`` — ``kv.partition`` only: the two sides of the cut, each a
  list of worker ranks (the literal ``"driver"`` names the root KV
  server).  A KV request whose sender and target fall on opposite sides
  is refused, in both directions, for the rule's window.
* kind parameters: ``delay_ms`` (delay/slow kinds), ``peer``
  (transport kinds; int or ``"*"``), ``stall_s`` (step stall),
  ``exit_code`` (step exit).

Validation is strict — a typo'd seam name or an overlapping window is a
config error surfaced at install time, not a silently dead fault.

A copy of ``horovod_tpu/chaos/plan.py``: a plan written for one package
reads the same in the other, and :meth:`FaultRule.decides_fire` is the
same pure function of ``(seed, rule, index)``, so one plan gives one fire
schedule in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Union

#: seam -> allowed fault kinds.  Python-injected seams are fired by the
#: instrumented call sites (see docs/CHAOS.md for the catalog semantics);
#: ``transport.*`` seams are compiled to the C++ core's
#: ``HVD_TPU_CHAOS_TRANSPORT`` env spec at install time.
SEAMS: Dict[str, frozenset] = {
    "kv.request": frozenset({"error", "blackout", "delay"}),
    # network partition between HOST GROUPS: a KV request whose sender
    # and target fall on opposite sides of the cut is refused, in BOTH
    # directions.  Fired by the KV clients with the target's identity
    # (a worker rank for relay hops, the literal "driver" for the root
    # KV) — see docs/CHAOS.md.
    "kv.partition": frozenset({"partition"}),
    "checkpoint.write": frozenset({"io_error", "slow_fsync"}),
    "step": frozenset({"kill", "stall", "exit"}),
    # advance preemption notice (the TPU maintenance-event analog):
    # non-destructive — the PreemptionWatcher polls this seam and treats
    # a fire as "this host is doomed", driving the proactive drain path
    # (docs/ELASTIC.md "Proactive drain & preemption").
    "preemption": frozenset({"notice"}),
    "transport.send": frozenset({"delay", "drop", "close", "bit_flip"}),
    "transport.recv": frozenset({"delay", "drop", "close", "bit_flip"}),
    # serving request path (docs/CHAOS.md, docs/SERVING.md): fired by
    # the replica's /infer handler per request — ``error`` fails the
    # request with 500 (the router must retry it to a survivor),
    # ``delay`` sleeps in the handler (the router's hedge must cover
    # it), ``shed`` forces an explicit 429 (backpressure must surface,
    # never silently drop).  Invocation index = per-process request
    # count.
    "serving.request": frozenset({"error", "delay", "shed"}),
    # KV page-pool starvation (docs/CHAOS.md): fired by the generate
    # engine's page pool per allocation attempt — ``starve`` makes the
    # pool refuse the grant as if it could not cover the request, so
    # admitted traffic piles up in ``page_wait`` (the request ledger
    # must attribute it there and the ``kv_thrash`` detector must name
    # it).  Invocation index = per-process allocation attempt count.
    "serving.kv": frozenset({"starve"}),
    # gradient corruption at the train step (docs/CHAOS.md): the seam
    # index IS the training step (like ``step``); the armed kinds are
    # read by the guard-integrated train steps
    # (horovod_tpu_torch/train/guard.py) and applied to the step's
    # gradients — ``nan``/``inf`` poison them (the numeric guardrail
    # must skip the step), ``scale`` multiplies them by ``factor``
    # (a finite SDC stand-in the guard cannot see but the cross-replica
    # canary must).  Pure signal at the seam: nothing raises here.
    "grad": frozenset({"nan", "inf", "scale"}),
    # the elastic DRIVER process (docs/CHAOS.md, docs/ELASTIC.md "Driver
    # failover & takeover"): fired by the driver's own poll loop, one
    # invocation per poll tick — ``kill``/``exit`` terminate the control
    # plane mid-flight (the launcher's supervisor respawns it into a
    # journal takeover), ``stall`` freezes the poll loop so workers must
    # ride the outage out under HVD_TPU_DRIVER_OUTAGE_GRACE_S.  Driver
    # rules should leave ``rank`` unset (the driver is not a worker —
    # only the wildcard matches it) and use ``marker`` for at-most-once
    # across supervisor respawns.
    "driver": frozenset({"kill", "stall", "exit"}),
}

_UNBOUNDED = 2 ** 62


class FaultPlanError(ValueError):
    """A fault plan failed validation (bad seam/kind, malformed window,
    overlapping windows for the same seam+kind, ...)."""


@dataclasses.dataclass
class FaultRule:
    seam: str
    kind: str
    ranks: Optional[frozenset] = None   # None = all ranks
    start: int = 0
    stop: int = _UNBOUNDED              # half-open [start, stop)
    count: int = 0                      # max fires per process; 0 = inf
    probability: float = 1.0
    delay_ms: float = 0.0
    peer: int = -1                      # transport seams; -1 = any peer
    stall_s: float = 0.0
    exit_code: int = 1
    # transport bit_flip only: frames under this payload size are immune
    # — flips target tensor DATA frames, not the small lockstep
    # negotiation frames whose per-peer index is timing-dependent
    min_bytes: int = 0
    # grad scale only: the multiplicative spike applied to the rank's
    # gradients while the rule fires
    factor: float = 0.0
    marker: str = ""
    # kv.partition only: the two sides of the cut.  Members are worker
    # ranks (ints) or the literal "driver" (the root KV server).
    groups: Optional[tuple] = None      # (frozenset, frozenset)
    index: int = 0                      # position in the plan (rule id)

    def matches_rank(self, rank: int) -> bool:
        return self.ranks is None or rank in self.ranks

    def matches_pair(self, rank, peer) -> bool:
        """kv.partition: does (sender ``rank``, target ``peer``) cross
        the cut?  Bidirectional by construction."""
        if self.groups is None or peer is None:
            return False
        a, b = self.groups
        return (rank in a and peer in b) or (rank in b and peer in a)

    def in_window(self, invocation: int) -> bool:
        return self.start <= invocation < self.stop

    def decides_fire(self, seed: int, invocation: int) -> bool:
        """Pure function of (seed, rule identity, invocation): same plan +
        seed => same schedule, regardless of which process asks."""
        if not self.in_window(invocation):
            return False
        if self.probability >= 1.0:
            return True
        key = f"{seed}:{self.index}:{self.seam}:{self.kind}:{invocation}"
        return random.Random(key).random() < self.probability


@dataclasses.dataclass
class FaultPlan:
    seed: int = 0
    rules: List[FaultRule] = dataclasses.field(default_factory=list)

    def rules_for(self, seam: str, rank: int) -> List[FaultRule]:
        return [r for r in self.rules
                if r.seam == seam and r.matches_rank(rank)]


def _parse_ranks(v: Any) -> Optional[frozenset]:
    if v is None or v == "*":
        return None
    if isinstance(v, bool):
        raise FaultPlanError(f"bad rank spec {v!r}")
    if isinstance(v, int):
        return frozenset({v})
    if isinstance(v, (list, tuple)):
        try:
            return frozenset(int(x) for x in v)
        except (TypeError, ValueError):
            raise FaultPlanError(f"bad rank list {v!r}") from None
    raise FaultPlanError(f"bad rank spec {v!r} (int, list, or '*')")


_RULE_KEYS = {"seam", "kind", "rank", "start", "stop", "count",
              "probability", "delay_ms", "peer", "stall_s", "exit_code",
              "marker", "groups", "min_bytes", "factor"}


def _parse_groups(v: Any, index: int) -> tuple:
    """kv.partition ``groups``: exactly two disjoint, non-empty sides;
    members are ints (worker ranks) or the literal ``"driver"``."""
    if not (isinstance(v, (list, tuple)) and len(v) == 2):
        raise FaultPlanError(
            f"fault #{index}: 'groups' must be a list of exactly two "
            "host groups")
    sides = []
    for side in v:
        if not isinstance(side, (list, tuple)) or not side:
            raise FaultPlanError(
                f"fault #{index}: each partition group must be a "
                "non-empty list")
        members = set()
        for m in side:
            if m == "driver":
                members.add("driver")
            elif isinstance(m, bool) or not isinstance(m, int):
                raise FaultPlanError(
                    f"fault #{index}: bad group member {m!r} (worker "
                    "rank int or 'driver')")
            else:
                members.add(m)
        sides.append(frozenset(members))
    if sides[0] & sides[1]:
        raise FaultPlanError(
            f"fault #{index}: partition groups overlap "
            f"({sorted(map(str, sides[0] & sides[1]))}) — a member "
            "cannot sit on both sides of the cut")
    return (sides[0], sides[1])


def _parse_rule(doc: Dict[str, Any], index: int) -> FaultRule:
    if not isinstance(doc, dict):
        raise FaultPlanError(f"fault #{index}: not an object: {doc!r}")
    unknown = set(doc) - _RULE_KEYS
    if unknown:
        raise FaultPlanError(
            f"fault #{index}: unknown keys {sorted(unknown)}")
    seam = doc.get("seam")
    if seam not in SEAMS:
        raise FaultPlanError(
            f"fault #{index}: unknown seam {seam!r} "
            f"(known: {sorted(SEAMS)})")
    kind = doc.get("kind")
    if kind not in SEAMS[seam]:
        raise FaultPlanError(
            f"fault #{index}: kind {kind!r} not valid for seam {seam!r} "
            f"(valid: {sorted(SEAMS[seam])})")
    try:
        start = int(doc.get("start", 0))
        count = int(doc.get("count", 0))
        stop = doc.get("stop")
        stop = _UNBOUNDED if stop is None else int(stop)
        probability = float(doc.get("probability", 1.0))
        delay_ms = float(doc.get("delay_ms", 0.0))
        stall_s = float(doc.get("stall_s", 0.0))
        exit_code = int(doc.get("exit_code", 1))
        peer = doc.get("peer", -1)
        peer = -1 if peer in ("*", None) else int(peer)
        min_bytes = int(doc.get("min_bytes", 0))
        factor = float(doc.get("factor", 0.0))
    except (TypeError, ValueError) as e:
        raise FaultPlanError(f"fault #{index}: bad field value: {e}") \
            from None
    if start < 0 or stop <= start:
        raise FaultPlanError(
            f"fault #{index}: window [{start}, "
            f"{stop if stop != _UNBOUNDED else 'inf'}) is empty or "
            "negative")
    if count < 0:
        raise FaultPlanError(f"fault #{index}: count must be >= 0")
    if not (0.0 < probability <= 1.0):
        raise FaultPlanError(
            f"fault #{index}: probability must be in (0, 1]")
    if delay_ms < 0 or stall_s < 0:
        raise FaultPlanError(f"fault #{index}: negative delay")
    marker = str(doc.get("marker", ""))
    if marker and seam.startswith("transport."):
        # the C++ injector has no marker support; accepting one would
        # silently re-arm the fault in every restarted process — the
        # exact hazard marker exists to prevent
        raise FaultPlanError(
            f"fault #{index}: 'marker' is not supported on transport "
            "seams (the C++ injector is stateless across restarts); "
            "bound the fault with start/stop/count instead")
    if kind in ("delay", "slow_fsync") and delay_ms <= 0:
        raise FaultPlanError(
            f"fault #{index}: kind {kind!r} needs delay_ms > 0 "
            "(a zero-length delay would count as injected while "
            "exercising nothing)")
    if kind == "stall" and stall_s <= 0:
        raise FaultPlanError(
            f"fault #{index}: kind 'stall' needs stall_s > 0")
    if min_bytes < 0:
        raise FaultPlanError(f"fault #{index}: min_bytes must be >= 0")
    if min_bytes and kind != "bit_flip":
        raise FaultPlanError(
            f"fault #{index}: 'min_bytes' is only valid for transport "
            "bit_flip rules (the payload-size gate that keeps flips off "
            "the small negotiation frames)")
    if kind == "scale":
        if factor <= 0 or factor == 1.0:
            raise FaultPlanError(
                f"fault #{index}: kind 'scale' needs factor > 0 and "
                "!= 1 (a unit spike would count as injected while "
                "corrupting nothing)")
    elif "factor" in doc:
        raise FaultPlanError(
            f"fault #{index}: 'factor' is only valid for the grad "
            "'scale' kind")
    groups = None
    if seam == "kv.partition":
        if "groups" not in doc:
            raise FaultPlanError(
                f"fault #{index}: kv.partition needs 'groups' — the two "
                "sides of the cut")
        groups = _parse_groups(doc["groups"], index)
    elif "groups" in doc:
        raise FaultPlanError(
            f"fault #{index}: 'groups' is only valid for the "
            "kv.partition seam")
    return FaultRule(seam=seam, kind=kind, ranks=_parse_ranks(
        doc.get("rank", "*")), start=start, stop=stop, count=count,
        probability=probability, delay_ms=delay_ms, peer=peer,
        stall_s=stall_s, exit_code=exit_code, min_bytes=min_bytes,
        factor=factor, marker=marker, groups=groups, index=index)


def _ranks_overlap(a: Optional[frozenset], b: Optional[frozenset]) -> bool:
    if a is None or b is None:
        return True
    return bool(a & b)


def _check_overlaps(rules: Sequence[FaultRule]) -> None:
    """Two rules with the same (seam, kind) firing on overlapping ranks
    over overlapping windows are ambiguous (which one's parameters
    apply?) — reject the plan."""
    def effective_ranks(r: FaultRule) -> Optional[frozenset]:
        # partition rules scope by their groups, not by `rank`: two cuts
        # over disjoint member sets are independent schedules
        if r.groups is not None:
            return r.groups[0] | r.groups[1]
        return r.ranks

    for i, a in enumerate(rules):
        for b in rules[i + 1:]:
            if a.seam != b.seam or a.kind != b.kind:
                continue
            if not _ranks_overlap(effective_ranks(a), effective_ranks(b)):
                continue
            if a.seam.startswith("transport.") and a.peer != b.peer \
                    and a.peer != -1 and b.peer != -1:
                continue  # distinct peers: independent schedules
            if a.start < b.stop and b.start < a.stop:
                raise FaultPlanError(
                    f"faults #{a.index} and #{b.index} ({a.seam}/{a.kind})"
                    f" have overlapping windows [{a.start},{a.stop}) and "
                    f"[{b.start},{b.stop}) on overlapping ranks")


def parse_plan(doc: Union[str, Dict[str, Any]],
               seed_override: Optional[int] = None) -> FaultPlan:
    """Parse + validate a plan from a JSON string or an already-decoded
    dict; raises :class:`FaultPlanError` on any schema violation."""
    if isinstance(doc, str):
        try:
            doc = json.loads(doc)
        except ValueError as e:
            raise FaultPlanError(f"fault plan is not valid JSON: {e}") \
                from None
    if not isinstance(doc, dict):
        raise FaultPlanError(f"fault plan must be an object, got "
                             f"{type(doc).__name__}")
    unknown = set(doc) - {"seed", "faults"}
    if unknown:
        raise FaultPlanError(f"unknown plan keys {sorted(unknown)}")
    faults = doc.get("faults", [])
    if not isinstance(faults, list):
        raise FaultPlanError("'faults' must be a list")
    rules = [_parse_rule(r, i) for i, r in enumerate(faults)]
    _check_overlaps(rules)
    try:
        seed = int(doc.get("seed", 0))
    except (TypeError, ValueError):
        raise FaultPlanError("'seed' must be an integer") from None
    if seed_override is not None:
        seed = seed_override
    return FaultPlan(seed=seed, rules=rules)


def load_plan_from_env() -> Optional[FaultPlan]:
    """The plan named by ``HVD_TPU_FAULT_PLAN`` (inline JSON when the
    value starts with ``{``, else a file path), seed overridden by
    ``HVD_TPU_FAULT_SEED``; None when unset."""
    raw = os.environ.get("HVD_TPU_FAULT_PLAN", "").strip()
    if not raw:
        return None
    if not raw.startswith("{"):
        try:
            with open(raw) as f:
                raw = f.read()
        except OSError as e:
            raise FaultPlanError(
                f"HVD_TPU_FAULT_PLAN names an unreadable file: {e}") \
                from None
    seed_env = os.environ.get("HVD_TPU_FAULT_SEED", "").strip()
    seed_override = None
    if seed_env:
        try:
            seed_override = int(seed_env)
        except ValueError:
            raise FaultPlanError(
                f"HVD_TPU_FAULT_SEED is not an integer: {seed_env!r}") \
                from None
    return parse_plan(raw, seed_override=seed_override)


def compile_transport_spec(plan: FaultPlan, rank: int) -> str:
    """Compile this rank's ``transport.*`` rules into the compact spec the
    C++ core parses from ``HVD_TPU_CHAOS_TRANSPORT`` (rules joined by
    ``;``, fields by ``:``).  Probability is resolved here per-rule into
    the deterministic schedule's parameters; the C++ side applies windows
    and counts only (it has no seeded RNG), so probabilistic transport
    rules are rejected at validation."""
    parts = []
    for r in plan.rules_for("transport.send", rank) + \
            plan.rules_for("transport.recv", rank):
        if r.probability < 1.0:
            raise FaultPlanError(
                f"fault #{r.index}: transport seams do not support "
                "probability < 1 (the C++ injector is window/count based)")
        direction = "recv" if r.seam.endswith("recv") else "send"
        window = 0 if r.stop == _UNBOUNDED else r.stop - r.start
        if r.kind == "bit_flip":
            # bit_flip counts FIRES, not window frames: the plan's
            # ``count`` compiles to the C++ ``fires`` budget (at most N
            # frames ever corrupted) while ``start``/``stop`` stay the
            # frame-index window; ``min_bytes`` keeps the flip off the
            # small (timing-indexed) negotiation frames
            parts.append(
                f"dir={direction}:kind=bit_flip:peer={r.peer}:"
                f"after={r.start}:count={window}:ms=0:"
                f"minb={r.min_bytes}:fires={r.count}")
            continue
        stop_count = r.count
        if window:
            stop_count = min(stop_count, window) if stop_count else window
        parts.append(
            f"dir={direction}:kind={r.kind}:peer={r.peer}:"
            f"after={r.start}:count={stop_count}:ms={r.delay_ms:g}")
    return ";".join(parts)
