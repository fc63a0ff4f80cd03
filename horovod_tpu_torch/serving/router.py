"""The serving front door: admission control, dispatch, hedging,
retry, and the request log the zero-drop guarantee is audited from.

A copy of ``horovod_tpu/serving/router.py`` (host code): retries, hedging
(never for ``/generate``), the explicit admission shed, the version split,
and the request log with its exactly-once accounting. One difference:
when every endpoint of a request's pool has failed, the port re-reads the
endpoint view before retrying (the JAX router widens only a version-split
arm), so a pool whose only replica died or drained does not spend the
request's attempts on it.

Invariant (docs/SERVING.md): **an accepted request gets exactly one
successful response, or an explicit error — never a silent drop.**

* **Admission** is the only shed point the router owns: past
  ``max_inflight`` concurrently admitted requests, a submit is refused
  with :class:`~horovod_tpu_torch.serving.batcher.SheddedError` (HTTP 429),
  counted (``hvd_serving_shed_total{where="admission"}``) and logged —
  backpressure is explicit.
* **Dispatch** posts the request to a ready replica.  A replica-side
  backpressure answer (429/503) or death (connection reset/refused,
  5xx, timeout) triggers **retry** against the next replica; a replica
  that is merely SLOW past ``hedge_ms`` triggers a **hedge** — the
  request is duplicated to a second replica and the first success
  wins.  Replica-side idempotency (the response cache keyed by request
  id) makes this fan-out safe: a duplicate never recomputes a request
  that already answered.
* The **request log** (JSONL, optional) records one ``accepted`` line
  per admission and exactly one terminal line (``ok`` / ``failed`` /
  with sheds logged at admission) — the chaos acceptance scenarios
  replay it to prove zero drops under replica SIGKILL and drain.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
import urllib.error
import urllib.request
import zlib
from typing import List, Optional, Sequence, Tuple

from horovod_tpu_torch import tracing
from horovod_tpu_torch.common.config import env_float, env_int
from horovod_tpu_torch.serving import ledger
from horovod_tpu_torch.serving import metrics as smetrics
from horovod_tpu_torch.serving.batcher import SheddedError
from horovod_tpu_torch.serving.metrics import LatencyWindow

Endpoint = Tuple[str, int]

DEFAULT_REQLOG_MAX_BYTES = 16 * 1024 * 1024


class RequestFailed(RuntimeError):
    """An accepted request exhausted every retry/hedge (explicit
    terminal error — logged, counted, surfaced; not a drop)."""


class RequestRejected(RuntimeError):
    """A replica answered a DEFINITIVE client error (4xx other than
    backpressure): retrying it anywhere would get the same answer —
    terminal immediately, logged as ``rejected``, never a retry storm
    and never a zero-drop violation."""

    def __init__(self, code: int, doc: dict) -> None:
        super().__init__(f"HTTP {code}: {doc.get('error', doc)}")
        self.code = code
        self.doc = doc


class RequestLog:
    """JSONL accounting with size-based rotation, thread-safe; ``None``
    path = in-memory only (the entries list is still kept, bounded).

    The on-disk file rotates at ``HVD_TPU_SERVING_REQLOG_MAX_BYTES``
    (one previous generation kept as ``<path>.1`` — the OBS-store
    treatment of the time-series writer),
    always at a line boundary, so each generation's lines are a
    self-consistent audit window and :func:`read_request_log` reads
    across the boundary in recording order.  The exactly-once
    ``accounting()`` audit runs over the in-memory entries and is
    untouched by rotation."""

    MAX_MEMORY = 100_000

    def __init__(self, path: Optional[str] = None,
                 max_bytes: Optional[int] = None) -> None:
        self._path = path
        self._lock = threading.Lock()
        self.entries: List[dict] = []
        self.trimmed = 0  # lines dropped from memory by the MAX_MEMORY cap
        self.max_bytes = int(max_bytes) if max_bytes else env_int(
            "SERVING_REQLOG_MAX_BYTES", DEFAULT_REQLOG_MAX_BYTES)
        self._fh = None
        self._written = 0
        self._closed = False
        if path:
            # a bad path fails LOUDLY at construction (an audit log
            # that silently never existed is worse than a crash);
            # mid-life errors degrade to dropped lines below
            self._open()

    def _open(self):
        self._fh = open(self._path, "a", buffering=1)
        self._written = self._fh.tell()
        return self._fh

    def note(self, req_id: str, outcome: str, **fields) -> None:
        doc = {"ts": round(time.time(), 4), "id": req_id,
               "outcome": outcome, **fields}
        with self._lock:
            self.entries.append(doc)
            if len(self.entries) > self.MAX_MEMORY:
                cut = self.MAX_MEMORY // 10
                del self.entries[:cut]
                self.trimmed += cut
            if self._path is not None and not self._closed:
                try:
                    line = json.dumps(doc) + "\n"
                    # lazy reopen heals a transient mid-life failure
                    # (the OBS SeriesWriter's contract); close() is
                    # final — the flag above stops late completions
                    # from resurrecting the handle
                    fh = self._fh or self._open()
                    if self._written > 0 and \
                            self._written + len(line) > self.max_bytes:
                        fh.close()
                        self._fh = None
                        os.replace(self._path, self._path + ".1")
                        fh = self._open()
                    fh.write(line)
                    self._written += len(line)
                except OSError:
                    pass  # accounting stays in memory; never raise

    def seq_now(self) -> int:
        """Monotonic count of lines ever noted — unlike a raw index
        into ``entries``, it survives the in-memory trim, so windowed
        readers (the rollout stage window) can anchor on it without
        over-skipping entries after a trim."""
        with self._lock:
            return self.trimmed + len(self.entries)

    def since(self, seq: int) -> List[dict]:
        """Entries noted at-or-after absolute sequence ``seq`` (a prior
        :meth:`seq_now`), trim-compensated; entries the cap already
        dropped are gone, but nothing that survived is skipped."""
        with self._lock:
            return list(self.entries[max(0, seq - self.trimmed):])

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def accounting(self) -> dict:
        """{outcome: count} plus the exactly-once audit, keyed by the
        per-SUBMISSION sequence number (``seq``): a client may reuse a
        request id — that is what idempotency is FOR — but every
        accepted submission must terminate exactly once.
        ``unanswered`` = accepted with NO terminal entry at all (a
        true accounting hole); explicit ``failed``/``rejected``
        terminals are counted in ``outcomes``, not hidden there."""
        with self._lock:
            entries = list(self.entries)
        by_outcome: dict = {}
        by_version: dict = {}
        accepted: dict = {}
        ok: dict = {}
        terminal: set = set()
        for e in entries:
            by_outcome[e["outcome"]] = by_outcome.get(e["outcome"], 0) + 1
            seq = e.get("seq")
            if seq is None:
                continue
            if e["outcome"] == "accepted":
                accepted[seq] = e["id"]
            elif e["outcome"] == "ok":
                ok[seq] = ok.get(seq, 0) + 1
                terminal.add(seq)
                # per-version success counts: rollout verdicts are
                # auditable from the log alone (docs/SERVING.md
                # "Canary rollout")
                v = e.get("version")
                v = "unversioned" if v is None else v
                by_version[v] = by_version.get(v, 0) + 1
            elif e["outcome"] in ("failed", "rejected"):
                terminal.add(seq)
        return {
            "outcomes": by_outcome,
            "accepted": len(accepted),
            "answered_ok": len(ok),
            "unanswered": sorted(accepted[s] for s in
                                 set(accepted) - terminal),
            "answered_twice": sorted(accepted.get(s, "?") for s, n in
                                     ok.items() if n > 1),
            "by_version": by_version,
        }


def read_request_log(path: str) -> List[dict]:
    """Read a request log back, rotated generation first so lines come
    out in recording order; torn trailing lines (a crash mid-append)
    are skipped.  THE one rotated-JSONL reader — shared with the
    causal-tracing planes so both sides always agree on the format."""
    from horovod_tpu_torch.tracing.reader import read_jsonl
    return read_jsonl(path)


class Router:
    """Dispatches requests across a replica fleet.

    Args:
      endpoints: static list of ``(host, port)`` replica endpoints, or
        a zero-arg callable returning the CURRENT list (the fleet wires
        its live view in, so respawns/scale-outs are picked up per
        request).
      max_inflight: admission budget (429 beyond it).
      hedge_ms: duplicate a silent in-flight request to a second
        replica after this long (0 disables hedging).
      attempt_timeout_s: per-dispatch HTTP timeout.
      max_attempts: total dispatch attempts per request (retries +
        hedges; the deadline caps it too).
      log_path: JSONL request-log path (None = in-memory only).
    """

    def __init__(self, endpoints, max_inflight: Optional[int] = None,
                 hedge_ms: Optional[float] = None,
                 attempt_timeout_s: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 log_path: Optional[str] = None) -> None:
        self._endpoints = endpoints if callable(endpoints) \
            else (lambda: list(endpoints))
        self.max_inflight = max_inflight if max_inflight \
            else env_int("SERVING_MAX_INFLIGHT", 256)
        self.hedge_s = (hedge_ms if hedge_ms is not None
                        else env_float("SERVING_HEDGE_MS", 150.0)) / 1000.0
        self.attempt_timeout_s = attempt_timeout_s \
            if attempt_timeout_s is not None \
            else env_float("SERVING_ATTEMPT_TIMEOUT_S", 5.0)
        self.max_attempts = max_attempts if max_attempts \
            else env_int("SERVING_MAX_ATTEMPTS", 6)
        self.default_deadline_s = default_deadline_s \
            if default_deadline_s is not None \
            else env_float("SERVING_DEADLINE_MS", 30_000.0) / 1000.0
        self.log = RequestLog(log_path)
        self.window = LatencyWindow()
        self._inflight = threading.BoundedSemaphore(self.max_inflight)
        self._inflight_n = 0
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._rr = itertools.count()  # per-request round-robin offset
        # version split (docs/SERVING.md "Canary rollout"): when a
        # rollout is live, requests are deterministically assigned to
        # the canary or incumbent arm by request id, and retries/hedges
        # rotate WITHIN the arm — a canary request never silently
        # escapes to the incumbent (and vice versa) unless its arm is
        # empty, in which case zero-drop outranks split fidelity
        self._split: Optional[dict] = None
        # (host, port) -> last weight version OBSERVED answering there
        # (fed by every 200 dispatch) — hedge/retry log lines attribute
        # outcomes per version from this map
        self._ep_versions: dict = {}
        # windows must close on IDLE too: with rolls driven only by
        # observe(), a fleet whose traffic stopped would freeze the
        # qps/p50/p99 gauges at their last busy values forever
        self._roller_stop = threading.Event()
        threading.Thread(target=self._roll_loop, daemon=True,
                         name="hvd-serving-window-roll").start()

    def _roll_loop(self) -> None:
        while not self._roller_stop.wait(self.window.window_s):
            try:
                self.window.maybe_roll()
            except Exception:
                pass

    # -- version split (canary rollout) -------------------------------------
    def set_version_split(self, pct: int, canary_eps,
                          incumbent_eps,
                          canary_version: Optional[int] = None,
                          incumbent_version: Optional[int] = None
                          ) -> None:
        """Install a version split: ``pct``% of requests go to the
        canary arm, the rest to the incumbent arm.  Each arm is a list
        of endpoints or a zero-arg callable returning the CURRENT list
        (the fleet's ``endpoints_at(version)`` view, so heals and
        repins are picked up per request).  Assignment is by request
        id (crc32 bucket), so an idempotent replay of a request lands
        on the SAME arm — and is answered by the same version — as the
        original."""
        pct = max(0, min(100, int(pct)))
        self._split = {
            "pct": pct,
            "canary": canary_eps if callable(canary_eps)
            else (lambda eps=list(canary_eps): list(eps)),
            "incumbent": incumbent_eps if callable(incumbent_eps)
            else (lambda eps=list(incumbent_eps): list(eps)),
            "canary_version": canary_version,
            "incumbent_version": incumbent_version,
        }
        smetrics.set_rollout_canary_pct(pct)

    def clear_version_split(self) -> None:
        self._split = None
        smetrics.set_rollout_canary_pct(0)

    def version_split(self) -> Optional[dict]:
        s = self._split
        if s is None:
            return None
        return {"pct": s["pct"],
                "canary_version": s["canary_version"],
                "incumbent_version": s["incumbent_version"]}

    def _pick_arm(self, req_id: str) -> Tuple[List[Endpoint],
                                              Optional[str]]:
        """The request's endpoint pool.  No split: the full fleet.
        Split: the arm its id hashes into — empty arms degrade to the
        full fleet (counted) rather than failing the request."""
        split = self._split
        if split is None:
            return list(self._endpoints()), None
        bucket = zlib.crc32(req_id.encode()) % 100
        arm = "canary" if bucket < split["pct"] else "incumbent"
        try:
            eps = list(split[arm]())
        except Exception:
            eps = []
        if not eps:
            smetrics._reg().counter(
                "hvd_serving_rollout_split_fallback_total",
                help="requests whose version-split arm was empty and "
                     "fell back to the full fleet (zero-drop outranks "
                     "split fidelity)",
                labels={"arm": arm}).inc()
            return list(self._endpoints()), f"{arm}-fallback"
        return eps, arm

    def _version_at(self, ep: Endpoint) -> Optional[int]:
        """Best-effort weight-version attribution for an endpoint.
        Under a split, CURRENT arm membership names the version — a
        poisoned candidate that fails every request has never answered
        200, so the observed-version map alone would attribute its
        failures to the version it previously served (or to nothing)
        and the canary error window would never accrue.  Outside a
        split, the last version observed answering there."""
        split = self._split
        if split is not None:
            for arm_name in ("canary", "incumbent"):
                try:
                    if ep in split[arm_name]():
                        return split[f"{arm_name}_version"]
                except Exception:
                    pass
        return self._ep_versions.get(ep)

    # -- dispatch plumbing --------------------------------------------------
    def _post(self, ep: Endpoint, body: bytes, timeout: float,
              ctx=None, path: str = "/infer") -> Tuple[int, dict]:
        url = f"http://{ep[0]}:{ep[1]}{path}"
        headers = {"Content-Type": "application/json"}
        if ctx is not None:
            # the attempt's OWN span travels as the traceparent header;
            # the replica's spans become its children
            headers[tracing.TRACEPARENT] = ctx.traceparent
        req = urllib.request.Request(
            url, data=body, method="POST", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(e.read())
            except Exception:
                doc = {"error": str(e)}
            return e.code, doc

    def _fire(self, ep: Endpoint, body: bytes, deadline: float,
              results: "queue.Queue", ctx=None,
              path: str = "/infer") -> None:
        def run():
            timeout = min(self.attempt_timeout_s,
                          max(deadline - time.monotonic(), 0.05))
            t0 = time.monotonic()
            wall0 = time.time()
            try:
                code, doc = self._post(ep, body, timeout, ctx=ctx,
                                       path=path)
                if code == 200 and isinstance(doc, dict) \
                        and doc.get("version") is not None:
                    self._ep_versions[ep] = int(doc["version"])
                out = (ep, code, doc, None)
                err = None
            except Exception as e:
                out = (ep, None, None, e)
                code, err = None, e
            # every attempt records its span — including the hedge
            # loser whose answer arrives after the request returned:
            # the causal tree must cover BOTH replicas a hedge touched.
            # Recorded before the hand-off (the JAX router records it
            # after): the waiting thread then wakes to an attempt that
            # has no Python work left, so the hand-off adds no span
            # bookkeeping to the request's unattributed residual
            tracing.record_span(
                "serving", "dispatch", ctx, start=wall0,
                dur_s=time.monotonic() - t0,
                target=f"{ep[0]}:{ep[1]}", code=code,
                error=repr(err) if err is not None else None)
            results.put(out + (t0, time.monotonic()))

        threading.Thread(target=run, daemon=True,
                         name="hvd-serving-dispatch").start()

    # -- the public request path --------------------------------------------
    def submit(self, x, req_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace=None) -> dict:
        """Blocking request.  Returns the replica's response doc.
        Raises :class:`SheddedError` at admission (429 — explicit
        backpressure) or :class:`RequestFailed` when an ACCEPTED
        request exhausts retries/hedges inside its deadline (explicit
        terminal error, logged).  ``trace`` is the CALLER's trace
        context (a front end decodes the client's ``traceparent``
        header into it); the request's root span is its child, or a
        fresh trace when the client sent none."""
        payload = {"x": x if isinstance(x, list)
                   else list(map(float, x))}
        return self._submit(payload, "/infer", True, x_req_id=req_id,
                            deadline_s=deadline_s, trace=trace)

    def submit_generate(self, prompt, max_new: int = 16,
                        req_id: Optional[str] = None,
                        deadline_s: Optional[float] = None,
                        trace=None) -> dict:
        """Blocking GENERATE request: same admission/accounting
        contract as :meth:`submit`, dispatched to ``/generate`` with
        hedging DISABLED — a hedge would land the same idempotency key
        on a SECOND replica whose in-flight table has never seen it,
        and two replicas would decode the same stream.  Within one
        replica, duplicates (retries after a timeout) still dedupe on
        the key before decode starts; the terminal ``ok`` log line
        records ``tokens_emitted`` so the exactly-once audit covers the
        multi-token response."""
        payload = {"prompt": [int(t) for t in prompt],
                   "max_new": int(max_new)}
        return self._submit(payload, "/generate", False,
                            x_req_id=req_id, deadline_s=deadline_s,
                            trace=trace)

    def _submit(self, payload: dict, path: str, allow_hedge: bool,
                x_req_id: Optional[str], deadline_s: Optional[float],
                trace) -> dict:
        seq = next(self._seq)
        req_id = x_req_id
        if req_id is None:
            req_id = f"req-{seq}-{time.monotonic_ns()}"
        root = tracing.child(trace, "serving") if trace is not None \
            else tracing.new_trace("serving")
        if not self._inflight.acquire(blocking=False):
            smetrics.inc_shed("admission")
            self.window.note_shed()
            self.log.note(req_id, "shed", seq=seq, where="admission",
                          **tracing.fields(root))
            raise SheddedError("router inflight budget exhausted")
        with self._lock:
            self._inflight_n += 1
            smetrics.set_inflight(self._inflight_n)
        smetrics.inc_accepted()
        self.log.note(req_id, "accepted", seq=seq,
                      **tracing.fields(root))
        t0 = time.monotonic()
        wall0 = time.time()
        try:
            dmeta: dict = {}
            doc = self._dispatch(req_id, payload, deadline_s, root,
                                 path=path, allow_hedge=allow_hedge,
                                 meta=dmeta)
            latency = time.monotonic() - t0
            stages = self._close_books(t0, latency, dmeta, doc)
            doc["stages"] = {k: round(v, 6)
                             for k, v in stages.items()}
            tracing.record_span("serving", "request", root, start=wall0,
                                dur_s=latency,
                                replica=doc.get("replica"),
                                version=doc.get("version"),
                                **{f"stage_{k}": round(v, 6)
                                   for k, v in stages.items()
                                   if v > 0})
            smetrics.inc_completed()
            if doc.get("version") is not None:
                # the router-side registry mirrors the version it just
                # OBSERVED serving — so a front-process /metrics scrape
                # (metrics top "weights vN") reports live truth without
                # reaching into replica registries
                smetrics.set_weight_version(int(doc["version"]))
            ttft = doc.get("ttft_s")
            self.window.observe(
                latency, stages=stages,
                trace=getattr(root, "trace_id", None),
                req_id=req_id, version=doc.get("version"),
                ttft_s=float(ttft) if ttft is not None else None)
            extra = {}
            if doc.get("tokens_emitted") is not None:
                # multi-token responses: the audit line carries how
                # many tokens this exactly-one success delivered
                extra["tokens_emitted"] = int(doc["tokens_emitted"])
            self.log.note(req_id, "ok", seq=seq,
                          latency_s=round(latency, 6),
                          replica=doc.get("replica"),
                          version=doc.get("version"),
                          stages=doc["stages"], **extra,
                          **tracing.fields(root))
            return doc
        except RequestRejected as e:
            # the replica ANSWERED — with a client error.  Not a drop,
            # not a fleet failure: its own outcome + counter
            smetrics._reg().counter(
                "hvd_serving_rejected_total",
                help="accepted requests answered a definitive client "
                     "error (4xx) by a replica — terminal, never "
                     "retried").inc()
            self.log.note(req_id, "rejected", seq=seq, code=e.code,
                          error=str(e), **tracing.fields(root))
            raise
        except Exception as e:
            smetrics.inc_failed()
            self.log.note(req_id, "failed", seq=seq, error=repr(e),
                          **tracing.fields(root))
            raise
        finally:
            self._inflight.release()
            with self._lock:
                self._inflight_n -= 1
                smetrics.set_inflight(self._inflight_n)

    def _close_books(self, t0: float, latency: float, dmeta: dict,
                     doc: dict) -> dict:
        """Decompose an accepted request's wall clock into ledger
        stages (docs/OBSERVABILITY.md "Serving request ledger"):
        router-side ``admission``/``hedge_wait``/``dispatch`` from the
        attempt timing ``_dispatch`` reported, merged with the
        replica/engine stages the response doc carried.  Whatever
        neither side measured stays ``unattributed`` — the books close
        on the request's true end-to-end latency, never on a guess."""
        stages = {k: max(float(v), 0.0)
                  for k, v in (doc.get("stages") or {}).items()
                  if isinstance(v, (int, float))}
        replica_s = sum(stages.values())
        start = dmeta.get("start", t0)
        win_launch = dmeta.get("win_launch")
        if win_launch is not None:
            first = dmeta.get("first_launch", start)
            recv = dmeta.get("win_recv", win_launch)
            stages["admission"] = max(start - t0, 0.0)
            hedge = max(win_launch - first, 0.0)
            if hedge > 0:
                # the winner was a hedge/retry: its launch offset from
                # the FIRST attempt is time spent waiting out a slow or
                # dead primary
                stages["hedge_wait"] = hedge
            # dispatch = pre-launch prep (arm pick, body build) + the
            # winning attempt's network/serialization overhead around
            # the time the replica accounted for itself
            stages["dispatch"] = max(first - start, 0.0) + max(
                recv - win_launch - replica_s, 0.0)
        return ledger.close_books(latency, stages)

    def _dispatch(self, req_id: str, payload: dict, deadline_s,
                  root=None, path: str = "/infer",
                  allow_hedge: bool = True,
                  meta: Optional[dict] = None) -> dict:
        # ``meta`` (out-param): attempt timing for the request ledger —
        # dispatch entry, first-attempt launch, and the WINNING
        # attempt's launch/receive marks (hedge_wait = winner launch −
        # first launch; dispatch = prep + network around the winner's
        # replica time)
        t_dispatch = time.monotonic()
        if meta is not None:
            meta["start"] = t_dispatch
        deadline = time.monotonic() + (
            deadline_s if deadline_s is not None
            else self.default_deadline_s)
        body = json.dumps({
            "id": req_id, **payload,
            "deadline_ms": max((deadline - time.monotonic()) * 1000.0,
                               1.0),
        }).encode()
        eps, arm = self._pick_arm(req_id)
        if not eps:
            raise RequestFailed("no replica endpoints")
        # spread primaries round-robin across the pool (the whole
        # fleet, or the request's version-split arm); retries/hedges
        # continue the rotation so they land on a DIFFERENT replica —
        # and, under a split, stay WITHIN the arm
        start = next(self._rr) % len(eps)
        rotation = itertools.cycle(
            list(range(start, len(eps))) + list(range(start)))
        arm_size = len(eps)
        widened = False

        def widen():
            # a DEAD arm must not fail the request: the empty-arm rule
            # (zero-drop outranks split fidelity) applied mid-flight —
            # once every arm replica has refused/died, the retry pool
            # becomes the REST of the fleet, counted as a fallback
            nonlocal eps, rotation, widened
            widened = True
            rest = [e for e in self._endpoints() if e not in eps]
            if not rest:
                return
            eps = rest
            rotation = itertools.cycle(range(len(eps)))
            smetrics._reg().counter(
                "hvd_serving_rollout_split_fallback_total",
                help="requests whose version-split arm was empty and "
                     "fell back to the full fleet (zero-drop outranks "
                     "split fidelity)",
                labels={"arm": arm}).inc()
        pool_tried: set = set()   # endpoints of the current pool tried

        def refresh():
            # every endpoint of this request's pool has failed: re-read
            # the live view (a fleet drops dead and draining replicas from
            # it within a poll). The JAX router retries over the pool it
            # began with, so a pool whose only member died or drained
            # burns its attempts there; zero-drop outranks that.
            nonlocal eps, rotation
            fresh = list(self._endpoints())
            if fresh:
                eps = fresh
                rotation = itertools.cycle(range(len(eps)))
            pool_tried.clear()
        results: "queue.Queue" = queue.Queue()
        attempts = 0
        outstanding = 0
        tried = []
        spans = []  # one per attempt, aligned with `tried`
        launched = []  # launch monotonic marks, aligned with `tried`

        def launch():
            nonlocal attempts, outstanding
            if attempts >= self.max_attempts:
                return False
            ep = eps[next(rotation)]
            attempts += 1
            outstanding += 1
            tried.append(ep)
            pool_tried.add(ep)
            # every attempt — primary, hedge, retry — is a child of the
            # request's root span: the duplicates share the trace id
            # and are SIBLINGS of each other, so the causal tree shows
            # one request fanning out across replicas
            ctx = tracing.child(root, "serving")
            spans.append(ctx)
            launched.append(time.monotonic())
            self._fire(ep, body, deadline, results, ctx=ctx, path=path)
            return True

        launch()
        hedged = False
        last_error: Optional[str] = None
        while time.monotonic() < deadline:
            # wait for an answer; hedge once if the fleet has a spare
            # replica and the primary has gone silent past hedge_s —
            # never for /generate (allow_hedge=False): a hedged decode
            # stream on a second replica cannot dedupe on the key
            can_hedge = (allow_hedge and self.hedge_s > 0 and not hedged
                         and len(eps) > 1
                         and attempts < self.max_attempts)
            timeout = min(self.hedge_s if can_hedge else 0.25,
                          max(deadline - time.monotonic(), 0.01))
            try:
                ep, code, doc, err, a_t0, a_recv = \
                    results.get(timeout=timeout)
            except queue.Empty:
                if can_hedge:
                    hedged = True
                    if launch():  # appends the hedge TARGET to tried
                        smetrics.inc_hedged()
                        self.log.note(
                            req_id, "hedged", to=str(tried[-1]),
                            version=self._version_at(tried[-1]),
                            arm=arm, **tracing.fields(spans[-1]))
                elif outstanding == 0:
                    # everything launched has answered badly and the
                    # attempt budget may still allow a retry
                    if not launch():
                        break
                continue
            outstanding -= 1
            if code == 200 and isinstance(doc, dict):
                if meta is not None:
                    meta.update(
                        first_launch=launched[0] if launched
                        else t_dispatch,
                        win_launch=a_t0, win_recv=a_recv,
                        attempts=attempts, hedged=hedged)
                return doc
            if code is not None and 400 <= code < 500 \
                    and code not in (408, 429):
                # a definitive client error (bad payload, bad width):
                # every replica would answer the same — terminal, not
                # a reason to burn the attempt budget fleet-wide
                raise RequestRejected(code, doc if isinstance(doc, dict)
                                      else {"error": str(doc)})
            last_error = (f"{ep[0]}:{ep[1]} -> "
                          + (repr(err) if err is not None
                             else f"HTTP {code}: {doc}"))
            # 429/503 = replica backpressure/drain; 5xx/conn-error =
            # replica sick or dead: in every case the survivor is the
            # answer — retry there (counted only when a retry actually
            # LAUNCHES: an exhausted attempt budget is not a retry)
            if arm is not None and not widened \
                    and len(set(tried)) >= arm_size:
                widen()
            elif arm is None and pool_tried >= set(eps):
                refresh()
            if launch():
                smetrics.inc_retried()
                self.log.note(
                    req_id, "retried", after=last_error,
                    after_version=self._version_at(ep),
                    to=str(tried[-1]),
                    version=self._version_at(tried[-1]),
                    arm=arm, **tracing.fields(spans[-1]))
            elif outstanding == 0:
                break
            # tiny backoff so a fully-shedding fleet is not hammered
            time.sleep(0.01)
        raise RequestFailed(
            f"request {req_id}: no successful response within "
            f"deadline/attempts ({attempts} attempts; last: "
            f"{last_error})")

    # -- introspection ------------------------------------------------------
    def accounting(self) -> dict:
        return self.log.accounting()

    def close(self) -> None:
        self._roller_stop.set()
        self.window.maybe_roll(force=True)
        self.log.close()


def ready_endpoints(candidates: Sequence[Endpoint],
                    timeout: float = 1.0) -> List[Endpoint]:
    """Filter ``candidates`` by their ``/readyz`` probe — the fleet's
    router view (a draining or still-restoring replica answers 503 and
    drops out of rotation here, BEFORE requests discover it)."""
    out = []
    for host, port in candidates:
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{port}/readyz", timeout=timeout) as r:
                if r.status == 200:
                    out.append((host, port))
        except Exception:
            pass
    return out
