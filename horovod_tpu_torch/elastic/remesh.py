"""Re-mesh phase timeline: elastic recovery as a measured quantity.

ROADMAP item 5 asks for re-mesh time as a first-class metric — recovery
at scale should be seconds, and it should be *known* to be seconds, not
an anecdote.  This module instruments the worker-side recovery pipeline
(:mod:`horovod_tpu_torch.elastic` ``run()`` / ``_apply_world_update`` and the
``hvd.init`` rendezvous split in ``common/basics.py``) into named
phases:

* ``failure_detect`` — from catching the failure to holding a new
  world document (dominated by the driver noticing the dead process
  and publishing; ~0 for a pushed growth doc);
* ``drain`` — rolling state back to the last commit + tearing the old
  core down;
* ``rendezvous`` — the new world's backend negotiation
  (``_create_backend`` inside ``hvd.init``);
* ``rebuild`` — the rest of re-init (process sets, timeline, mesh,
  exporter/fleet re-wiring);
* ``restore`` — re-applying/broadcasting elastic state into the new
  world (``on_reset`` + ``sync``);
* ``first_step`` — until the first completed step (or elastic commit)
  of the new world: the moment training is genuinely back.

Each phase lands three ways: a ``remesh_phase`` flight-recorder span as
it closes (live evidence even if the episode never completes), one
``hvd_remesh_seconds{phase=...}`` histogram observation per episode
(merged fleet-wide — the regression-gateable distribution), and a
summary point in the step time-series store rendered by
``python -m horovod_tpu_torch.metrics history --remesh``.
``hvd_remesh_total`` counts completed episodes.

All entry points are cheap no-ops when no episode is active, and every
emission path is exception-proofed: the timeline must never make a
recovery WORSE.

A copy of ``horovod_tpu/elastic/remesh.py``, under the same metric
names (``hvd_remesh_seconds{phase}``, ``hvd_remesh_total``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

PHASES = ("failure_detect", "drain", "rendezvous", "rebuild", "restore",
          "first_step")

_LOCK = threading.Lock()
_EPISODE: Optional["Episode"] = None


class Episode:
    """One recovery episode: accumulates per-phase seconds, finishes at
    the first completed step of the new world."""

    def __init__(self, trigger: str, old_size: Optional[int] = None,
                 generation: Optional[int] = None) -> None:
        self.trigger = trigger
        self.old_size = old_size
        self.new_size: Optional[int] = None
        self.generation = generation
        # monotonic: an NTP step during recovery (host swaps make clock
        # adjustments likely exactly then) must not poison the
        # regression-gateable durations
        self.started_at = time.perf_counter()
        self.phases: Dict[str, float] = {}
        self._recovered_at: Optional[float] = None
        self.finished = False
        # causal tracing: a planned re-mesh continues the trace its
        # drain-stamped world doc carries (finding → decision → action
        # → drain → THESE phases); a reactive one roots its own
        self.trace = None

    def set_trace(self, ctx) -> None:
        """Adopt a trace context (the survivor's child span of the
        world doc's ``traceparent``); every phase emitted from here on
        is stamped with it.  Explicit stamping, not thread-local
        activation: recovery spans several threads."""
        self.trace = ctx

    def _trace_fields(self) -> Dict[str, str]:
        return self.trace.fields() if self.trace is not None else {}

    def add_phase(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)
        _record_flight("remesh_phase", phase=name,
                       seconds=round(seconds, 4), trigger=self.trigger,
                       **self._trace_fields())

    def mark_recovered(self) -> None:
        """The new world is up and state is restored: the clock on
        ``first_step`` starts now."""
        self._recovered_at = time.perf_counter()

    def finish(self, complete: bool = True) -> None:
        if self.finished:
            return
        self.finished = True
        if complete and self._recovered_at is not None:
            self.add_phase("first_step",
                           time.perf_counter() - self._recovered_at)
        total = time.perf_counter() - self.started_at
        try:
            from horovod_tpu_torch.metrics.registry import default_registry
            reg = default_registry()
            # only COMPLETED episodes feed the histogram: partial
            # phase times from an abandoned recovery (a retry storm)
            # would smear the regression-gateable distribution, and
            # with no matching hvd_remesh_total tick the per-episode
            # contract breaks.  Abandoned evidence still lands in the
            # remesh_abandoned flight event + the time-series point.
            if complete:
                for name, secs in self.phases.items():
                    reg.histogram(
                        "hvd_remesh_seconds",
                        help="elastic re-mesh recovery time per phase",
                        labels={"phase": name}).observe(secs)
                reg.counter(
                    "hvd_remesh_total",
                    help="completed elastic re-mesh recoveries").inc()
        except Exception:
            pass
        if complete:
            # goodput ledger: a completed recovery's total is this
            # window's remesh_recovery charge (abandoned episodes roll
            # into the episode that finally completes)
            try:
                from horovod_tpu_torch.metrics import goodput
                goodput.note_remesh(total)
            except Exception:
                pass
        # a driver takeover that healed inside this episode's window is
        # part of its story: `history --remesh` marks such episodes, and
        # the chaos acceptance for the mid-re-mesh driver kill asserts
        # the timeline shows a TAKEOVER, not a second generation restart
        took = _spanned_takeover(self.started_at)
        _record_flight("remesh_complete" if complete
                       else "remesh_abandoned",
                       trigger=self.trigger, total_s=round(total, 4),
                       old_size=self.old_size, new_size=self.new_size,
                       generation=self.generation,
                       **({"takeover": True} if took else {}),
                       **self._trace_fields(),
                       **{f"{k}_s": round(v, 4)
                          for k, v in self.phases.items()})
        try:
            from horovod_tpu_torch.metrics import timeseries
            timeseries.record_point({
                "remesh": {k: round(v, 4)
                           for k, v in self.phases.items()},
                "remesh_total_s": round(total, 4),
                "trigger": self.trigger,
                "old_size": self.old_size, "new_size": self.new_size,
                "generation": self.generation,
                "complete": complete,
                **({"takeover": True} if took else {}),
                **self._trace_fields()})
        except Exception:
            pass
        try:
            # the episode as proper spans (one parent, one child per
            # phase laid out in pipeline order — starts are
            # approximate, durations measured): what `diagnostics
            # trace <id>` renders as the recovery subtree
            from horovod_tpu_torch import tracing
            if self.trace is not None:
                end_wall = time.time()
                tracing.record_span(
                    "remesh", f"remesh_{self.trigger}", self.trace,
                    start=end_wall - total, dur_s=total,
                    old_size=self.old_size, new_size=self.new_size,
                    generation=self.generation, complete=complete)
                t = end_wall - total
                for name in PHASES:
                    if name in self.phases:
                        dur = self.phases[name]
                        tracing.record_span(
                            "remesh", name,
                            tracing.child(self.trace, "remesh"),
                            start=t, dur_s=dur)
                        t += dur
        except Exception:
            pass
        try:
            from horovod_tpu_torch.common.logging import get_logger
            breakdown = " ".join(f"{k}={v:.3f}s"
                                 for k, v in self.phases.items())
            get_logger().info("re-mesh %s in %.3fs (%s): %s",
                              "recovered" if complete else "abandoned",
                              total, self.trigger, breakdown)
        except Exception:
            pass


def _spanned_takeover(started_at: float) -> bool:
    """True when a driver takeover recovered inside the window that
    started at ``started_at`` (a ``perf_counter`` stamp): the episode's
    recovery rode through a control-plane crash."""
    try:
        from horovod_tpu_torch.elastic import outage
        rec = outage.last_recovery_perf()
        return rec is not None and rec >= started_at
    except Exception:
        return False


def _record_flight(kind: str, **fields) -> None:
    try:
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event(kind, **{k: v for k, v in fields.items()
                              if v is not None})
    except Exception:
        pass


# -- module seams -------------------------------------------------------------
def begin(trigger: str, old_size: Optional[int] = None,
          generation: Optional[int] = None) -> Episode:
    """Open a recovery episode (closing — as abandoned — any episode a
    previous failure left unfinished: back-to-back failures are one
    re-mesh each, not one giant smeared episode)."""
    global _EPISODE
    with _LOCK:
        prev, _EPISODE = _EPISODE, None
    if prev is not None and not prev.finished:
        prev.finish(complete=False)
    ep = Episode(trigger, old_size=old_size, generation=generation)
    with _LOCK:
        _EPISODE = ep
    return ep


def current() -> Optional[Episode]:
    return _EPISODE


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Measure a recovery phase; a plain pass-through when no episode
    is active (the same code paths run for a first init)."""
    ep = _EPISODE
    if ep is None or ep.finished:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ep.add_phase(name, time.perf_counter() - t0)


def mark_recovered(new_size: Optional[int] = None,
                   generation: Optional[int] = None) -> None:
    ep = _EPISODE
    if ep is None or ep.finished:
        return
    if new_size is not None:
        ep.new_size = new_size
    if generation is not None:
        ep.generation = generation
    ep.mark_recovered()
    if new_size is not None and ep.old_size is not None \
            and new_size != ep.old_size:
        # the world genuinely changed shape: surface it as an external
        # finding so the autopilot's topology policy can invalidate the
        # plan cache + re-tune (docs/OBSERVABILITY.md "Autopilot").  A
        # same-size recovery (replacement respawned) keeps the cached
        # plans — they are keyed by the world fingerprint and still
        # describe this topology.
        try:
            from horovod_tpu_torch.metrics.anomaly import report_finding
            report_finding("world_changed", old_size=ep.old_size,
                           new_size=new_size, generation=generation,
                           trigger=ep.trigger)
        except Exception:
            pass


def note_step_end(step: Optional[int] = None) -> None:
    """A training step (or elastic commit) completed: if an episode is
    waiting on its first step, close it.  Called from
    ``StepTimer.end_step`` and ``State.commit`` — whichever the loop
    uses fires first; cheap no-op otherwise."""
    global _EPISODE
    ep = _EPISODE
    if ep is None or ep.finished or ep._recovered_at is None:
        return
    with _LOCK:
        if _EPISODE is ep:
            _EPISODE = None
    ep.finish(complete=True)


def note_same_world_retry() -> None:
    """A transient failure resolved into the SAME world: not a re-mesh
    episode (``hvd_remesh_*`` must mean what it says), but the phases
    already emitted live need a terminal marker — a flight-ring reader
    must not see ``remesh_phase`` spans that simply vanish."""
    global _EPISODE
    with _LOCK:
        ep, _EPISODE = _EPISODE, None
    if ep is None:
        return
    ep.finished = True
    _record_flight("remesh_retry", trigger=ep.trigger,
                   total_s=round(time.perf_counter() - ep.started_at, 4))


def reset() -> None:
    """Tests: drop any open episode without emitting."""
    global _EPISODE
    with _LOCK:
        ep, _EPISODE = _EPISODE, None
    if ep is not None:
        ep.finished = True
