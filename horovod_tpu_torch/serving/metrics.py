"""Serving-plane metrics: per-request latency SLOs on the fleet plane.

A copy of ``horovod_tpu/serving/metrics.py``: every ``hvd_serving_*``
name, label and bucket as the JAX package registers it, the rollout
gauges included (the rollout controller itself arrives later).

Every number the zero-drop guarantee is proven from lives here
(docs/SERVING.md): request admission/completion/shed counters (a shed
is EXPLICIT — counted and answered 429, never a silent drop), hedge and
retry counters, queue/inflight gauges, the latency histogram, and a
windowed percentile tracker that publishes ``hvd_serving_p50/p99``
gauges, records one ``{"serving": ...}`` point per window into the
step time-series store (the JAX package's ``history --serving`` reads
the same points), and reports an ``slo_breach`` anomaly finding
when the windowed p99 stays over ``HVD_TPU_SERVING_SLO_P99_MS`` —
which the autopilot's ``serving-slo-scaleout`` policy turns into a
fleet scale-out.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from horovod_tpu_torch.common.config import env_float, env_int
from horovod_tpu_torch.metrics.registry import default_registry
from horovod_tpu_torch.serving import ledger

#: latency buckets: serving answers in milliseconds, not the step-time
#: seconds the default buckets are shaped for
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _reg():
    return default_registry()


def inc_accepted() -> None:
    _reg().counter("hvd_serving_accepted_total",
                   help="requests admitted past the router's "
                        "admission control").inc()


def inc_completed() -> None:
    _reg().counter("hvd_serving_completed_total",
                   help="accepted requests answered with exactly one "
                        "successful response").inc()


def inc_failed() -> None:
    _reg().counter("hvd_serving_failed_total",
                   help="accepted requests that exhausted every "
                        "retry/hedge before their deadline").inc()


def inc_shed(where: str) -> None:
    """An EXPLICIT load-shed (429): ``where`` names the backpressure
    point — ``admission`` (router inflight budget), ``queue`` (replica
    batch queue full), ``deadline`` (expired before compute),
    ``draining`` (replica refusing new work), ``chaos`` (injected)."""
    _reg().counter("hvd_serving_shed_total",
                   help="requests explicitly load-shed (429), per "
                        "backpressure point",
                   labels={"where": where}).inc()


def inc_hedged() -> None:
    _reg().counter("hvd_serving_hedged_total",
                   help="hedge requests launched at a second replica "
                        "after the hedge timeout").inc()


def inc_retried() -> None:
    _reg().counter("hvd_serving_retried_total",
                   help="requests re-dispatched to a surviving replica "
                        "after a replica error/death").inc()


def inc_swap() -> None:
    _reg().counter("hvd_serving_swaps_total",
                   help="zero-downtime hot weight swaps applied from "
                        "the durable sharded store").inc()


def set_weight_version(step: int) -> None:
    _reg().gauge("hvd_serving_weight_version",
                 help="durable-store step of the weights currently "
                      "serving").set(float(step))


def inc_weight_swap(reason: str) -> None:
    """Every ``(version, params)`` flip lands here once, per cause —
    ``chase`` (the swapper following the store's latest commit),
    ``pin`` (a rollout controller pinning a candidate/incumbent) or
    ``rollback`` (repin to the incumbent during an auto-rollback).  The
    weight version gauge alone cannot show a BACKWARD move after the
    fact; this counter plus the ``weight_swap`` flight event are what
    the autopsy reads the rollback from."""
    _reg().counter("hvd_serving_weight_swaps_total",
                   help="weight-version flips, per cause (chase=follow "
                        "latest commit, pin=rollout pin, "
                        "rollback=repin to incumbent)",
                   labels={"reason": reason}).inc()


# ---------------------------------------------------------------------------
# Canary weight rollout (horovod_tpu/serving/rollout/)
# ---------------------------------------------------------------------------
#: rollout state machine positions, as published on the state gauge
ROLLOUT_STATES = ("idle", "canary", "expanding", "promoted",
                  "rolling_back", "rolled_back")


def set_rollout_state(state: str) -> None:
    _reg().gauge("hvd_serving_rollout_state",
                 help="rollout state machine position (0=idle, "
                      "1=canary, 2=expanding, 3=promoted, "
                      "4=rolling_back, 5=rolled_back)").set(
        float(ROLLOUT_STATES.index(state))
        if state in ROLLOUT_STATES else -1.0)


def set_rollout_canary_pct(pct: float) -> None:
    _reg().gauge("hvd_serving_rollout_canary_pct",
                 help="traffic percentage currently routed to the "
                      "candidate weight version (0 = no active "
                      "split)").set(float(pct))


def inc_rollout_verdict(verdict: str) -> None:
    _reg().counter("hvd_serving_rollout_verdicts_total",
                   help="per-version SLO/quality comparator verdicts, "
                        "per outcome (promote/rollback)",
                   labels={"verdict": verdict}).inc()


def inc_rollout_transition(to: str) -> None:
    _reg().counter("hvd_serving_rollout_transitions_total",
                   help="rollout state-machine transitions, per "
                        "destination state",
                   labels={"to": to}).inc()


def set_queue_depth(depth: int) -> None:
    _reg().gauge("hvd_serving_queue_depth",
                 help="requests waiting in the dynamic batcher "
                      "queue").set(float(depth))


def set_inflight(n: int) -> None:
    _reg().gauge("hvd_serving_inflight",
                 help="requests admitted and not yet answered "
                      "(router view)").set(float(n))


def set_draining(draining: bool) -> None:
    _reg().gauge("hvd_serving_draining",
                 help="1 while this replica is draining (not "
                      "admitting, finishing in-flight)").set(
        1.0 if draining else 0.0)


def batch_size_buckets(top: Optional[int] = None) -> tuple:
    """Power-of-two batch-size buckets whose top covers ``top`` —
    derived from the configured slot count / batch bound when omitted
    (``HVD_TPU_GEN_SLOTS`` slot arrays can exceed the old fixed top of
    128, which dumped every decode batch into +Inf)."""
    t = top if top else max(env_int("GEN_SLOTS", 4),
                            env_int("SERVING_MAX_BATCH", 8))
    edges = [1]
    while edges[-1] < max(128, t):
        edges.append(edges[-1] * 2)
    return tuple(edges)


def observe_batch(size: int, top: Optional[int] = None) -> None:
    """``top`` — the caller's configured maximum batch (slot count for
    the generate engine, ``max_batch_size`` for the dynamic batcher);
    the registry keeps the FIRST creation's buckets, so the first
    caller's configuration shapes the histogram."""
    _reg().counter("hvd_serving_batches_total",
                   help="forward batches executed by the serving "
                        "loop").inc()
    _reg().histogram("hvd_serving_batch_size",
                     help="formed dynamic-batch sizes",
                     buckets=batch_size_buckets(top)
                     ).observe(float(size))


def observe_latency(seconds: float) -> None:
    _reg().histogram("hvd_serving_latency_seconds",
                     help="end-to-end request latency (admission to "
                          "successful response)",
                     buckets=LATENCY_BUCKETS).observe(seconds)


def set_fleet_gauges(live: int, target: int) -> None:
    _reg().gauge("hvd_serving_replicas_live",
                 help="replica processes currently alive and "
                      "ready").set(float(live))
    _reg().gauge("hvd_serving_replicas_target",
                 help="replica fleet target size").set(float(target))


def inc_replica_exit(outcome: str) -> None:
    """``outcome`` ∈ {``drained``, ``failure``}: a DRAINED exit is a
    planned event (preemption/autopilot drain) and never counts as
    failure evidence against the slot."""
    _reg().counter("hvd_serving_replica_exits_total",
                   help="replica process exits, per classification "
                        "(drained=planned, failure=crash/kill)",
                   labels={"outcome": outcome}).inc()


def inc_respawn() -> None:
    _reg().counter("hvd_serving_replica_respawns_total",
                   help="replacement replicas spawned to heal the "
                        "fleet back to target size").inc()


# ---------------------------------------------------------------------------
# Generative decode engine (horovod_tpu/serving/generate/)
# ---------------------------------------------------------------------------
#: TTFT/ITL buckets: inter-token latency bottoms out well under the
#: request-latency buckets' floor on a warm decode step
GEN_LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                       0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def observe_prefill(seconds: float) -> None:
    _reg().counter("hvd_serving_prefill_seconds_total",
                   help="wall seconds spent in prefill chunks (prompt "
                        "ingestion) by the generate engine").inc(
        max(0.0, float(seconds)))
    _reg().counter("hvd_serving_prefill_chunks_total",
                   help="fixed-size prefill chunks executed").inc()


def count_gen_tokens(n: int) -> None:
    """Every emitted token lands here exactly once — decode steps in
    batches, plus the single token the LAST prefill chunk emits (it is
    a real emission; leaving it out under-counts by one per request)."""
    if n > 0:
        _reg().counter("hvd_serving_gen_tokens_total",
                       help="tokens emitted by the generate engine "
                            "across all sequences").inc(float(n))


def observe_decode(seconds: float, batch_tokens: int) -> None:
    _reg().counter("hvd_serving_decode_seconds_total",
                   help="wall seconds spent in batched decode steps by "
                        "the generate engine").inc(
        max(0.0, float(seconds)))
    _reg().counter("hvd_serving_decode_steps_total",
                   help="batched decode steps executed (one jit call "
                        "over the full slot array)").inc()
    count_gen_tokens(batch_tokens)


def set_slot_occupancy(occupied: int, total: int) -> None:
    _reg().gauge("hvd_serving_slot_occupancy",
                 help="fraction of decode slots holding a live "
                      "sequence (occupied / total)").set(
        occupied / total if total else 0.0)


def set_gen_waiting(n: int) -> None:
    _reg().gauge("hvd_serving_gen_waiting",
                 help="generate requests admitted past the queue but "
                      "still waiting for a slot + pages").set(float(n))


def set_kv_pool(in_use: int, total: int, page_bytes: int) -> None:
    _reg().gauge("hvd_serving_kv_pages_in_use",
                 help="KV-cache pages currently owned by live "
                      "sequences").set(float(in_use))
    _reg().gauge("hvd_serving_kv_pages_total",
                 help="KV-cache page pool capacity under the active "
                      "plan").set(float(total))
    _reg().gauge("hvd_serving_kv_page_bytes",
                 help="bytes one KV page holds (K+V, all layers) under "
                      "the active plan").set(float(page_bytes))


def observe_ttft(seconds: float) -> None:
    _reg().histogram("hvd_serving_ttft_seconds",
                     help="time to first token: submit to first "
                          "emitted token",
                     buckets=GEN_LATENCY_BUCKETS).observe(float(seconds))


def observe_itl(seconds: float) -> None:
    _reg().histogram("hvd_serving_itl_seconds",
                     help="inter-token latency between consecutive "
                          "emissions of one sequence",
                     buckets=GEN_LATENCY_BUCKETS).observe(float(seconds))


def inc_gen_finished(reason: str) -> None:
    """``reason`` ∈ {``length`` (hit max_new), ``deadline``,
    ``error``, ``drain``}."""
    _reg().counter("hvd_serving_gen_finished_total",
                   help="generate sequences finished, per reason "
                        "(length=hit max_new, deadline, error, drain)",
                   labels={"reason": reason}).inc()


#: THE one nearest-rank quantile — canonical implementation lives in
#: :mod:`horovod_tpu_torch.serving.ledger` (the SLO plane, the rollout
#: comparator and ``ci/check_bench.py --serving`` all share it, so
#: "p99" means the same thing everywhere)
percentile = ledger.quantile


class LatencyWindow:
    """Windowed latency/percentile tracker (one per router, feeding the
    fleet SLO plane).

    ``observe()`` per completed request — with its stage ledger when
    the request path carried one; every ``HVD_TPU_SERVING_WINDOW_S``
    (default 5s) the closing window publishes ``hvd_serving_p50/p99
    _seconds`` + ``hvd_serving_qps`` + ``hvd_serving_stage_share``
    gauges, records a ``{"serving": {...}}`` time-series point carrying
    the stage breakdown, pushes the window's worst requests into the
    tail-exemplar ring, and — when ``HVD_TPU_SERVING_SLO_P99_MS`` is
    set (> 0) — runs the multi-window burn-rate SLO check
    (:class:`horovod_tpu_torch.serving.ledger.BurnRateSlo`: one ``slo_breach``
    finding per episode, naming the dominant stage).  The closed doc is
    also fed to the anomaly engine's serving detectors (``ttft_drift``,
    ``queue_growth``, ``kv_thrash``)."""

    def __init__(self, window_s: Optional[float] = None,
                 ring: Optional[ledger.ExemplarRing] = None) -> None:
        self.window_s = window_s if window_s is not None \
            else env_float("SERVING_WINDOW_S", 5.0)
        self.slo = ledger.BurnRateSlo()
        self.slo_p99_s = self.slo.slo_p99_s
        self._ring = ring if ring is not None else ledger.default_ring()
        self._lock = threading.Lock()
        self._lat: List[float] = []
        self._shed = 0
        self._bad = 0
        self._books = ledger.WindowBooks()
        self._opened = time.monotonic()

    def observe(self, seconds: float,
                stages: Optional[dict] = None,
                trace: Optional[str] = None,
                req_id: Optional[str] = None,
                version: Optional[int] = None,
                ttft_s: Optional[float] = None) -> None:
        observe_latency(seconds)
        if stages:
            ledger.observe_stage_seconds(
                ledger.close_books(seconds, stages))
        with self._lock:
            self._lat.append(seconds)
            if self.slo.is_bad(seconds):
                self._bad += 1
            self._books.add(seconds, stages, trace=trace,
                            req_id=req_id, version=version,
                            ttft_s=ttft_s)
        self.maybe_roll()

    def note_shed(self) -> None:
        with self._lock:
            self._shed += 1

    def maybe_roll(self, force: bool = False) -> Optional[dict]:
        """Close the window if its time is up (or ``force``); returns
        the window summary when one closed."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._opened < self.window_s:
                return None
            lat, shed, bad = self._lat, self._shed, self._bad
            elapsed = max(now - self._opened, 1e-9)
            self._lat, self._shed, self._bad = [], 0, 0
            stage_doc, exemplars = self._books.close()
            self._opened = now
        lat.sort()
        doc = {
            "window_s": round(elapsed, 3),
            "requests": len(lat),
            "qps": round(len(lat) / elapsed, 3),
            "p50_s": round(percentile(lat, 0.50), 6),
            "p99_s": round(percentile(lat, 0.99), 6),
            "shed": shed,
        }
        if self.slo.enabled:
            doc["slo_bad"] = bad
        doc.update(stage_doc)
        reg = _reg()
        reg.gauge("hvd_serving_qps",
                  help="completed requests per second over the last "
                       "closed window").set(doc["qps"])
        reg.gauge("hvd_serving_p50_seconds",
                  help="windowed median request latency").set(doc["p50_s"])
        reg.gauge("hvd_serving_p99_seconds",
                  help="windowed p99 request latency — the serving SLO "
                       "signal").set(doc["p99_s"])
        # every canonical stage publishes each roll (absent -> 0.0), so
        # an idle window zeroes the shares instead of freezing them
        ledger.publish_stage_shares(doc.get("stage_shares") or {})
        for ex in exemplars:
            self._ring.add(ex)
        try:
            from horovod_tpu_torch.metrics.timeseries import record_point
            record_point({"serving": doc})
        except Exception:
            pass
        self.slo.observe_window(doc["requests"], bad, doc)
        try:
            from horovod_tpu_torch.metrics.anomaly import \
                observe_serving_window
            observe_serving_window(doc)
        except Exception:
            pass
        return doc
