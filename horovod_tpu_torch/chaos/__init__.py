"""Deterministic fault injection: provoke the failures the stack claims
to survive, on every CI run.

The complement of the flight recorder and the hang autopsy: diagnostics
explain a failure after the fact; the chaos harness CAUSES the failures
— socket stalls, KV blackouts, checkpoint IO errors, rank kills — on a
seeded, reproducible schedule, so the elastic + durable-checkpoint
recovery path is exercised instead of trusted.  Reference analog: none
(the reference's fault coverage is hand-written per-test exits);
1802.05799's pitch that a dying worker is a recoverable event is exactly
what this subsystem regression-tests.

Usage: set ``HVD_TPU_FAULT_PLAN`` (inline JSON or a file path; schema in
:mod:`horovod_tpu_torch.chaos.plan` and docs/CHAOS.md) and run normally.
``hvd.init()`` arms the plan; instrumented call sites fire their seams
through :func:`fire`; ``transport.*`` rules are compiled into the C++
core's env-read injection points.  Every injected fault is stamped into
the flight recorder (``fault_injected`` events) and counted on
``/metrics`` (``hvd_chaos_injected_total{seam=,kind=}``).

With no plan set the seams are dead: :func:`fire` is a module-global
None check and the C++ transport path is a single null-pointer test per
frame — nothing allocates, nothing sleeps, nothing logs.

A copy of ``horovod_tpu/chaos/__init__.py``. The port builds the same
``cpp/`` core, which reads the same ``HVD_TPU_CHAOS_TRANSPORT`` spec, so
the transport seams need nothing of their own here.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Tuple

from horovod_tpu_torch.chaos.plan import (FaultPlan, FaultPlanError, FaultRule,
                                    SEAMS, compile_transport_spec,
                                    load_plan_from_env, parse_plan)

__all__ = ["install", "uninstall", "active", "fire", "step_tick",
           "grad_injection", "grad_rules_armed", "GRAD_CODES",
           "engine", "ChaosEngine", "FaultPlan", "FaultPlanError",
           "FaultRule", "SEAMS", "parse_plan"]

TRANSPORT_ENV = "HVD_TPU_CHAOS_TRANSPORT"


class ChaosEngine:
    """Per-process injector: tracks per-seam invocation counters and
    per-rule fire counts, applies Python-seam faults."""

    def __init__(self, plan: FaultPlan, rank: int) -> None:
        self.plan = plan
        self.rank = rank
        self._lock = threading.Lock()
        self._invocations = {}   # seam -> next auto index
        self._fired = {}         # rule.index -> fires so far
        self.injected_total = 0

    # -- schedule -----------------------------------------------------------
    def _next_index(self, seam: str) -> int:
        with self._lock:
            i = self._invocations.get(seam, 0)
            self._invocations[seam] = i + 1
            return i

    def _should_fire(self, rule: FaultRule, invocation: int) -> bool:
        if not rule.decides_fire(self.plan.seed, invocation):
            return False
        with self._lock:
            fired = self._fired.get(rule.index, 0)
            if rule.count and fired >= rule.count:
                return False
            self._fired[rule.index] = fired + 1
        if rule.marker:
            # at-most-once across restarts: O_EXCL create is the gate, so
            # a replacement process (or a racing thread) cannot re-fire.
            # {rank} expands per firing rank — a correlated multi-rank
            # rule kills every group member once each, rather than the
            # first member's marker disarming the rest of the group.
            marker = rule.marker.replace("{rank}", str(self.rank))
            try:
                fd = os.open(marker,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except FileExistsError:
                return False
            except OSError as e:
                # fire anyway, but SAY the at-most-once guarantee is
                # gone — under an elastic driver an unwritable marker
                # turns a one-shot kill into a kill-every-replacement
                # livelock, and that must read as a config error
                try:
                    from horovod_tpu_torch.common.logging import get_logger
                    get_logger().error(
                        "chaos: marker %r for rule #%d is unwritable "
                        "(%s); the rule is NO LONGER at-most-once "
                        "across restarts", rule.marker, rule.index, e)
                except Exception:
                    pass
        return True

    # -- firing -------------------------------------------------------------
    def fire(self, seam: str, index: Optional[int] = None,
             peer=None) -> List[Tuple[str, str]]:
        """Evaluate ``seam`` at ``index`` (auto-incrementing per-seam
        counter when None).  Applies every matching rule's fault —
        delays sleep in place, error kinds RAISE, kill/exit terminate
        the process, pure-signal kinds (``preemption``/``notice``, the
        ``grad`` corruption kinds) only report.  ``peer`` names the
        request's TARGET for the ``kv.partition`` seam (a worker rank or
        ``"driver"``); rules whose cut the (self rank, peer) pair
        crosses fire bidirectionally.  Returns the (seam, kind) pairs
        applied, for tests and signal-kind consumers."""
        return [(r.seam, r.kind)
                for r in self.fire_rules(seam, index=index, peer=peer)]

    def fire_rules(self, seam: str, index: Optional[int] = None,
                   peer=None) -> List[FaultRule]:
        """:meth:`fire`, but returning the applied RULES — consumers
        that need a rule's parameters (the grad ``scale`` kind's
        ``factor``) read them off the rule instead of a string pair."""
        invocation = self._next_index(seam) if index is None else index
        applied: List[FaultRule] = []
        raise_after: Optional[BaseException] = None
        for rule in self.plan.rules_for(seam, self.rank):
            if rule.groups is not None and \
                    not rule.matches_pair(self.rank, peer):
                continue
            if not self._should_fire(rule, invocation):
                continue
            self._note(rule, invocation)
            applied.append(rule)
            if rule.kind in ("delay", "slow_fsync"):
                time.sleep(rule.delay_ms / 1000.0)
            elif rule.kind == "stall":
                time.sleep(rule.stall_s)
            elif rule.kind == "error":
                raise_after = ConnectionResetError(
                    f"chaos: injected connection reset ({seam} "
                    f"invocation {invocation})")
            elif rule.kind == "blackout":
                raise_after = ConnectionRefusedError(
                    f"chaos: injected blackout ({seam} invocation "
                    f"{invocation})")
            elif rule.kind == "partition":
                raise_after = ConnectionRefusedError(
                    f"chaos: injected partition (rank {self.rank} -> "
                    f"{peer}, invocation {invocation})")
            elif rule.kind in ("notice", "nan", "inf", "scale", "shed"):
                pass  # pure signal: the applied list IS the payload
                # (grad kinds are consumed by train/guard.py;
                # the serving `shed` kind by the replica's /infer
                # handler, which maps it to an explicit 429 — serving
                # `error` takes the raising `error` branch above and
                # surfaces as the handler's 500)
            elif rule.kind == "io_error":
                raise_after = OSError(
                    f"chaos: injected IO error ({seam} invocation "
                    f"{invocation})")
            elif rule.kind == "kill":
                self._flush_flight("kill")
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            elif rule.kind == "exit":
                self._flush_flight("exit")
                os._exit(rule.exit_code)
        if raise_after is not None:
            raise raise_after
        return applied

    # -- bookkeeping --------------------------------------------------------
    def _note(self, rule: FaultRule, invocation: int) -> None:
        with self._lock:  # seams fire from many threads (kv listener,
            self.injected_total += 1  # checkpoint writer, train loop)
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import record_event
            # "fault", not "kind": the ring's own event-kind key wins
            record_event("fault_injected", seam=rule.seam, fault=rule.kind,
                         rule=rule.index, invocation=invocation,
                         rank=self.rank)
        except Exception:
            pass
        try:
            from horovod_tpu_torch.metrics.registry import default_registry
            default_registry().counter(
                "hvd_chaos_injected_total",
                help="faults injected by the chaos harness, per seam/kind",
                labels={"seam": rule.seam, "kind": rule.kind}).inc()
        except Exception:
            pass
        try:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning(
                "chaos: injecting %s/%s (rule #%d, invocation %d)",
                rule.seam, rule.kind, rule.index, invocation)
        except Exception:
            pass

    def _flush_flight(self, why: str) -> None:
        """A kill/exit fault destroys the process before anything can ask
        for evidence — dump the flight ring to the autopsy dir first so
        the soak test (and a real post-mortem) still sees the injection."""
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import (
                crash_dump_path, record_event, recorder)
            record_event("chaos_terminating", fault=why, rank=self.rank)
            recorder().dump_to(crash_dump_path())
        except Exception:
            pass


_engine: Optional[ChaosEngine] = None
_lock = threading.Lock()
_we_set_transport_env = False
_armed_key = None  # (rank, plan env, seed env) the engine was built for


def _env_rank() -> int:
    v = os.environ.get("HVD_TPU_RANK", os.environ.get("HOROVOD_RANK", "0"))
    try:
        return int(v)
    except ValueError:
        return 0


def install(rank: Optional[int] = None) -> Optional[ChaosEngine]:
    """(Re-)arm the fault plan from env for this process.  Called by
    ``hvd.init()`` on every (re-)initialization — an elastic re-mesh can
    renumber this worker, and rank-scoped rules plus the compiled
    transport spec must follow the NEW rank.  No plan in env = everything
    disarmed (and a previously compiled transport spec cleared).

    Must run before the native core boots: the C++ transport reads its
    compiled spec from ``HVD_TPU_CHAOS_TRANSPORT`` at ``Transport::Init``.
    """
    global _engine, _we_set_transport_env, _armed_key
    with _lock:
        raw = os.environ.get("HVD_TPU_FAULT_PLAN", "").strip()
        seed_raw = os.environ.get("HVD_TPU_FAULT_SEED", "").strip()
        if not raw:
            _engine = None
            _armed_key = None
            if _we_set_transport_env:
                os.environ.pop(TRANSPORT_ENV, None)
                _we_set_transport_env = False
            return None
        r = _env_rank() if rank is None else int(rank)
        if _engine is not None and _armed_key == (r, raw, seed_raw):
            # same rank, same plan: keep the armed engine and its
            # invocation counters (hvd.init() and a raw CoreBackend()
            # both install; re-arming here would replay every window)
            return _engine
        plan = load_plan_from_env()  # FaultPlanError propagates: a typo'd
        # plan must fail the job loudly, not run fault-free
        if plan is None or not plan.rules:
            _engine = None
            _armed_key = None
            if _we_set_transport_env:
                os.environ.pop(TRANSPORT_ENV, None)
                _we_set_transport_env = False
            return None
        _engine = ChaosEngine(plan, r)
        _armed_key = (r, raw, seed_raw)
        spec = compile_transport_spec(plan, r)
        if spec:
            os.environ[TRANSPORT_ENV] = spec
            _we_set_transport_env = True
        elif _we_set_transport_env:
            os.environ.pop(TRANSPORT_ENV, None)
            _we_set_transport_env = False
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import record_event
            record_event("chaos_armed", rank=r, seed=plan.seed,
                         rules=len(plan.rules),
                         transport_spec=spec or None)
        except Exception:
            pass
        try:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning(
                "chaos: armed %d fault rule(s), seed=%d, rank=%d%s",
                len(plan.rules), plan.seed, r,
                f", transport spec: {spec}" if spec else "")
        except Exception:
            pass
        return _engine


def uninstall() -> None:
    """Disarm everything (tests)."""
    global _engine, _we_set_transport_env, _armed_key
    with _lock:
        _engine = None
        _armed_key = None
        if _we_set_transport_env:
            os.environ.pop(TRANSPORT_ENV, None)
            _we_set_transport_env = False


def active() -> bool:
    return _engine is not None


def engine() -> Optional[ChaosEngine]:
    return _engine


def fire(seam: str, index: Optional[int] = None,
         peer=None) -> List[Tuple[str, str]]:
    """Fire a seam if a plan is armed; the no-plan fast path is one
    module-global None check (the instrumented call sites stay free when
    chaos is off).  ``peer`` carries the request target for the
    ``kv.partition`` seam."""
    eng = _engine
    if eng is None:
        return ()
    return eng.fire(seam, index=index, peer=peer)


def step_tick(step: int) -> List[Tuple[str, str]]:
    """The ``step`` seam: call once per training step with the step
    number (rank kill/stall schedules key on it).  Wired into
    ``TelemetryCallback.on_step_begin``; custom loops call it directly."""
    eng = _engine
    if eng is None:
        return ()
    return eng.fire("step", index=int(step))


#: grad-seam kind -> the injection code train/guard.py applies
#: (0 = clean; the same codes as the JAX package's)
GRAD_CODES = {"nan": 1, "inf": 2, "scale": 3}


def grad_rules_armed() -> bool:
    """Does the armed plan carry any ``grad`` rules for THIS rank?  The
    train steps consult this: only then does a step evaluate the seam
    and touch its gradients (no extra launch otherwise)."""
    eng = _engine
    return bool(eng is not None
                and eng.plan.rules_for("grad", eng.rank))


def grad_injection(step: int) -> Tuple[int, float]:
    """Evaluate the ``grad`` seam at training step ``step``; returns
    ``(code, factor)`` — the :data:`GRAD_CODES` code of the first
    applied rule (0 when clean) and its ``scale`` factor (0.0 for
    nan/inf).  Counted/flight-recorded like every other injection."""
    eng = _engine
    if eng is None:
        return (0, 0.0)
    for rule in eng.fire_rules("grad", index=int(step)):
        return (GRAD_CODES[rule.kind],
                float(rule.factor) if rule.kind == "scale" else 0.0)
    return (0, 0.0)
