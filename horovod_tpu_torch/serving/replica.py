"""One serving replica: HTTP front, dynamic batcher, forward loop, hot
weight swap, and drain-to-DRAINED semantics.

Mirrors ``horovod_tpu/serving/replica.py``. A replica is one worker
process (spawned and healed by
:class:`horovod_tpu_torch.serving.fleet.ReplicaFleet`, or embedded
in-process for tests) that:

* answers ``POST /infer`` by admitting the request into the bounded
  :class:`~horovod_tpu_torch.serving.batcher.DynamicBatcher` and blocking the
  handler until the serving loop fulfills it (the handler threads are
  the continuation — the hardened :class:`ThreadedHTTPServer`'s bounded
  pool is the concurrency limit);
* runs ONE serving loop thread pulling formed batches, padding them to
  the fixed ``max_batch_size`` (one shape, whatever the batch), and
  executing ``apply_fn`` on the replica's device;
* in ``mode="generate"`` also answers ``POST /generate`` through the
  continuous-batching :class:`~horovod_tpu_torch.serving.generate.
  GenerateEngine` (one token stream per request id);
* **hot weight swap**: a swapper thread polls the durable sharded store
  (:class:`horovod_tpu_torch.checkpoint.ShardedCheckpointer`, which reads
  commits of either package) for commits newer than the serving version,
  restores them at world 1 while the old weights keep serving, then flips
  the ``(version, params)`` pair atomically between batches.  A corrupt
  newest commit falls back to the next-older one (store semantics) and
  the version names the step actually restored.  In generate mode the
  engine is handed the restored weights
  (:meth:`GenerateEngine.load_params`, copied into the static weights its
  CUDA graphs read) once its live sequences have finished with the old
  ones, and every ``/generate`` response names the version its tokens
  were decoded with: the JAX replica flips only its ``/infer`` params and
  version, so its ``/generate`` keeps decoding with the weights the
  engine was built with (ROADMAP queue 3 item 10);
* **drains** on SIGTERM (in ``main()``) or ``POST /drain`` (the JAX
  replica also drains on a chaos/maintenance ``preemption`` notice; that
  seam is open in the port, :mod:`horovod_tpu_torch.serving._seams`):
  admission stops instantly
  (``/readyz`` → 503 so routers stop sending; new submits get
  :class:`DrainingError`), every in-flight request is answered, then
  the replica reports DRAINED — and, under ``main()``, exits 0, which
  the fleet classifies as a planned exit (never failure evidence);
* is **idempotent** per request id: a bounded response cache plus an
  in-flight table mean a hedged/retried duplicate of a request that
  already ran (or is running) returns the SAME response instead of
  recomputing — the router may fan a request out freely.

``/readyz`` readiness = model loaded AND queue depth under budget AND
not draining; ``/healthz`` liveness = process up + serving loop alive.

Every replica runs on one device: ``device=None`` is this process's card
(raising when there is none); pass ``device="cpu"`` to serve on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Optional

import numpy as np
import torch

from horovod_tpu_torch import tracing
from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.config import env_float, env_int
from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.diagnostics.flight_recorder import record_event
from horovod_tpu_torch.runner.http_kv import ThreadedHTTPServer
from horovod_tpu_torch.serving import metrics as smetrics
from horovod_tpu_torch.serving._seams import chaos_fire
from horovod_tpu_torch.serving.batcher import (DeadlineError, DrainingError,
                                               DynamicBatcher, SheddedError)


def _flight(kind: str, **fields) -> None:
    record_event(kind, **fields)


# -- demo model ---------------------------------------------------------------
def demo_params(dim: int = 16, scale: float = 1.0) -> dict:
    """Deterministic tiny affine model — the serving analog of the
    bench's synthetic models.  ``scale`` distinguishes weight VERSIONS
    observably: ``y = scale * mean(x) + bias`` per output lane."""
    return {
        "w": np.full((dim, dim), scale / dim, dtype=np.float32),
        "b": np.zeros((dim,), dtype=np.float32),
    }


def demo_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The demo model's forward: ``x @ w + b`` (tensors on one device)."""
    return x @ params["w"] + params["b"]


# -- the replica --------------------------------------------------------------
class ReplicaServer:
    """One replica: HTTP server + batcher + serving loop + swapper.

    Args:
      apply_fn: ``(params, X[batch, ...]) -> Y[batch, ...]`` over tensors
        on the replica's device.  Default: the demo affine model.
      params: initial weights pytree (ignored when ``store_dir``
        already holds a commit — the store is the source of truth).
      store_dir: durable sharded store to restore from / watch for hot
        swaps (None = static weights).
      dim: demo-model width (used when no params and no store commit).
      port: HTTP port (0 = ephemeral).
      replica_id: name stamped into responses/flight events.
      mode: ``"infer"`` or ``"generate"`` (adds ``POST /generate``).
      gen_model: generate mode's ``(params, cfg)``; None is
        :func:`~horovod_tpu_torch.serving.generate.demo_gen_setup`.
        A store commit, when there is one, replaces the weights.
      device: where the model runs; None is this process's card (raises
        without one), ``"cpu"`` the CPU.
    """

    def __init__(self, apply_fn: Optional[Callable] = None,
                 params: Any = None, store_dir: Optional[str] = None,
                 dim: int = 16, port: int = 0, replica_id: str = "r0",
                 batcher: Optional[DynamicBatcher] = None,
                 swap_poll_s: Optional[float] = None,
                 mode: str = "infer", gen_model: Any = None,
                 pin_version: Optional[int] = None, device=None,
                 gen_kwargs: Optional[dict] = None) -> None:
        self.device = resolve_device(device)
        self.replica_id = replica_id
        self.dim = dim
        # version pinning (docs/SERVING.md "Canary rollout"): while
        # pinned, the swapper serves EXACTLY this durable-store step —
        # it never chases a newer commit (that is how a canary holds
        # the candidate while the rest of the fleet holds the
        # incumbent, and how a rollback repins without a restart).
        # ``pin_version`` at construction restores the pinned step
        # directly, so a healed replacement never transits through
        # whatever happens to be latest.
        self._pin: Optional[int] = None if pin_version is None \
            else int(pin_version)
        # generate mode: a continuous-batching decode engine rides
        # alongside the request-level path (POST /generate; the /infer
        # plumbing stays untouched).  ``gen_model`` is a (params, cfg)
        # pair; None = the deterministic demo transformer.
        # ``gen_kwargs`` pass through to the engine (slots, page bytes,
        # prefill chunk)
        self.mode = mode
        self.engine = None
        if mode == "generate":
            from horovod_tpu_torch.serving.generate import (GenerateEngine,
                                                            demo_gen_setup)
            g_params, g_cfg = gen_model if gen_model is not None \
                else demo_gen_setup(device=self.device)
            self.engine = GenerateEngine(g_params, g_cfg, device=self.device,
                                         **(gen_kwargs or {}))
        self._apply_fn = apply_fn or demo_apply
        self._store_dir = store_dir
        self._swap_poll_s = swap_poll_s if swap_poll_s is not None \
            else env_float("SERVING_SWAP_POLL_S", 1.0)
        self.batcher = batcher or DynamicBatcher()
        self._ready_queue_max = env_int(
            "SERVING_READY_QUEUE", max(1, int(self.batcher.max_queue * 0.9)))
        self._params_lock = threading.Lock()
        self._params = params
        self._version = 0
        self._model_loaded = False
        self._stop = threading.Event()
        self._drained_event = threading.Event()
        self._drain_source: Optional[str] = None
        self._loop_alive = False
        # idempotency: answered requests (bounded LRU) + in-flight table
        self._resp_cache: OrderedDict = OrderedDict()
        self._resp_cache_max = env_int("SERVING_IDEMPOTENCY_CACHE", 4096)
        self._pending: dict = {}
        self._pending_lock = threading.Lock()
        self._threads = []
        # handler pool sized FROM the admission budget: every queued +
        # in-batch request holds a handler thread awaiting its result,
        # and the pool must exceed that so (a) the batcher's explicit
        # queue shed is reachable over HTTP (a pool smaller than the
        # queue 503s before the 429 path can answer) and (b) readiness
        # probes / metrics scrapes are not starved by a full queue.
        # An EXPLICIT HVD_TPU_HTTP_MAX_HANDLERS wins verbatim — incl.
        # the documented 0 = unbounded — over the derived size.
        env_pool = env_int("HTTP_MAX_HANDLERS", -1)
        pool = env_pool if env_pool >= 0 else (
            self.batcher.max_queue + 2 * self.batcher.max_batch_size
            + 16)
        self._httpd = ThreadedHTTPServer(("0.0.0.0", port),
                                         _ReplicaHandler,
                                         max_handlers=pool)
        self._httpd.replica = self

    # -- lifecycle ----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ReplicaServer":
        self._load_initial_weights()
        for name, target in (
                ("serve-loop", self._serve_loop),
                ("swapper", self._swap_loop),
                ("preempt-watch", self._preemption_loop)):
            t = threading.Thread(target=target,
                                 name=f"hvd-serving-{name}", daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="hvd-serving-http", daemon=True)
        t.start()
        self._threads.append(t)
        if self.engine is not None:
            self.engine.start()
        _flight("serving_replica_start", replica=self.replica_id,
                port=self.port, version=self._version)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.engine is not None:
            self.engine.stop()
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass

    # -- weights ------------------------------------------------------------
    def _store(self):
        from horovod_tpu_torch.checkpoint import ShardedCheckpointer
        # world_size=1: the serving mesh is THIS replica; restore
        # reshards whatever world wrote the commit onto it
        return ShardedCheckpointer(self._store_dir, rank=0, world_size=1)

    @staticmethod
    def _extract_params(doc: Any) -> Any:
        """A durable commit is usually an elastic-state dict; serve its
        ``params`` leaf when present, the whole doc otherwise."""
        if isinstance(doc, dict) and "params" in doc:
            return doc["params"]
        return doc

    def _load_initial_weights(self) -> None:
        if self._store_dir:
            try:
                store = self._store()
                if self._pin is not None:
                    # a pinned spawn (fleet heal during a rollout)
                    # restores THE pinned step: the replacement joins
                    # the fleet at its slot's assigned version, never
                    # at whatever commit happens to be newest
                    doc = store.restore(self._pin)
                    self._set_params(self._extract_params(doc),
                                     version=self._pin, swap=False)
                else:
                    # return_step: on a corrupt-newest fallback the
                    # state is OLDER than latest_step(), and the
                    # serving version must name the weights actually
                    # loaded
                    step, doc = store.restore_latest(return_step=True)
                    if step is not None:
                        self._set_params(self._extract_params(doc),
                                         version=int(step), swap=False)
            except Exception:
                get_logger().warning(
                    "serving: initial restore from %s failed; starting "
                    "with built-in weights", self._store_dir,
                    exc_info=True)
        if self._params is None:
            self._params = self._on_device(demo_params(self.dim))
        self._model_loaded = True
        smetrics.set_weight_version(self._version)

    def _on_device(self, params: Any) -> Any:
        """``params`` (nested dicts of numpy arrays or tensors) with every
        array leaf a tensor on the replica's device."""
        if isinstance(params, dict):
            return {k: self._on_device(v) for k, v in params.items()}
        if isinstance(params, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(params).to(self.device)
        return params

    def _set_params(self, params: Any, version: int,
                    swap: bool = True, reason: str = "chase") -> None:
        # generate mode: the engine takes the new weights once its live
        # sequences have finished with the old ones (admission holds
        # meanwhile, charged to the waiting requests' ``swap_pause``
        # stage; the infer path charges its params-lock wait the same
        # way in _run_batch), and each response names the version its
        # tokens were decoded with
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.load_params(params, version)
        device = params if engine is not None else self._on_device(params)
        with self._params_lock:
            from_version = self._version
            self._params = device
            self._version = version
        smetrics.set_weight_version(version)
        if swap:
            smetrics.inc_swap()
            smetrics.inc_weight_swap(reason)
            # the gauge alone cannot show a BACKWARD move after the
            # fact — the flight event names both endpoints and the
            # cause, so the autopsy shows the rollback (a backward flip
            # is legitimate exactly when a pin/rollback asked for it,
            # and must never happen silently)
            _flight("weight_swap", replica=self.replica_id,
                    from_version=from_version, to_version=version,
                    reason=reason)
            _flight("serving_swap", replica=self.replica_id,
                    version=version)
            if version < from_version:
                get_logger().warning(
                    "serving: weight version moved BACKWARD %d -> %d "
                    "(replica %s, reason=%s) — expected only during a "
                    "rollout rollback", from_version, version,
                    self.replica_id, reason)
            else:
                get_logger().info(
                    "serving: hot-swapped to weight version %d "
                    "(replica %s, reason=%s)", version,
                    self.replica_id, reason)

    # -- version pinning ----------------------------------------------------
    def pin(self, version: int, reason: str = "pin") -> dict:
        """Pin this replica to durable-store step ``version``: restore
        it now (the same atomic between-batch flip as a hot swap — no
        request is dropped) and stop the swapper from chasing newer
        commits until :meth:`unpin`.  ``reason`` ∈ {``pin``,
        ``rollback``} stamps the ``weight_swap`` audit event."""
        version = int(version)
        if self._store_dir and version != self._version:
            # restore BEFORE committing the pin: a nonexistent/corrupt
            # step raises out of the /pin route (500) with the replica
            # UNPINNED and still serving its old weights — never
            # pinned to an unloadable version that _swap_loop would
            # retry forever while refusing to chase commits
            doc = self._store().restore(version)
            self._set_params(self._extract_params(doc),
                             version=version, reason=reason)
        self._pin = version
        _flight("serving_pin", replica=self.replica_id,
                version=version, reason=reason)
        return {"replica": self.replica_id, "pinned": self._pin,
                "version": self._version}

    def unpin(self) -> dict:
        """Clear the pin; the swapper resumes chasing the store's
        latest commit on its next poll."""
        self._pin = None
        _flight("serving_unpin", replica=self.replica_id,
                version=self._version)
        return {"replica": self.replica_id, "pinned": None,
                "version": self._version}

    @property
    def pinned(self) -> Optional[int]:
        return self._pin

    def _swap_loop(self) -> None:
        if not self._store_dir:
            return
        bad_newest = None  # a newest step whose restore fell back
        while not self._stop.wait(self._swap_poll_s):
            try:
                pin = self._pin
                if pin is not None:
                    # pinned: converge onto the pinned step if a failed
                    # pinned-SPAWN initial restore left us elsewhere
                    # (pin() itself only commits after its restore
                    # succeeds), then HOLD — a pinned replica never
                    # chases the latest commit
                    if self._version != pin:
                        doc = self._store().restore(pin)
                        self._set_params(self._extract_params(doc),
                                         version=pin, reason="pin")
                    continue
                store = self._store()
                step = store.latest_step()
                if step is None or step <= self._version \
                        or step == bad_newest:
                    continue
                # restore while the OLD weights keep serving; flip is
                # the lock-guarded pointer swap above — between batches.
                # return_step: a corrupt newest FALLS BACK to an older
                # commit (store semantics) — the version must name the
                # weights actually restored, and a fallback onto what
                # we already serve is NOT a swap (remember the bad
                # newest so each poll doesn't re-pay the failed
                # restore; a NEWER commit landing later clears it)
                restored, doc = store.restore_latest(return_step=True)
                if restored is not None and restored > self._version:
                    self._set_params(self._extract_params(doc),
                                     version=int(restored))
                    bad_newest = None
                else:
                    bad_newest = step
            except Exception:
                get_logger().warning(
                    "serving: weight-swap poll failed; still serving "
                    "version %d", self._version, exc_info=True)

    # -- drain --------------------------------------------------------------
    def drain(self, source: str = "admin") -> None:
        """Stop admitting, finish in-flight, then report DRAINED.  The
        actual exit is the embedder's call (``main()`` exits 0)."""
        if self.batcher.draining:
            return
        self._drain_source = source
        _flight("serving_drain_begin", replica=self.replica_id,
                source=source)
        get_logger().warning("serving: replica %s draining (%s)",
                             self.replica_id, source)
        self.batcher.drain()
        if self.engine is not None:
            self.engine.drain()

        def _finish():
            timeout_s = env_float("SERVING_DRAIN_TIMEOUT_S", 30.0)
            ok = self.batcher.wait_drained(timeout_s=timeout_s)
            if self.engine is not None:
                # drained = every admitted SEQUENCE answered, not just
                # the admission queue emptied (the engine hands off to
                # the slot scheduler long before tokens finish)
                ok = self.engine.wait_drained(timeout_s=timeout_s) and ok
            _flight("serving_drained", replica=self.replica_id,
                    source=source, clean=ok)
            self._drained_event.set()

        threading.Thread(target=_finish, name="hvd-serving-drain",
                         daemon=True).start()

    @property
    def draining(self) -> bool:
        return self.batcher.draining

    def drained(self) -> bool:
        return self._drained_event.is_set()

    def wait_drained(self, timeout_s: float = 60.0) -> bool:
        return self._drained_event.wait(timeout_s)

    def _preemption_loop(self) -> None:
        """Poll the ``preemption`` seam (a maintenance-event notice) and
        drain on a notice. The seam is open in the port
        (``horovod_tpu/serving/replica.py:427``; chaos is ROADMAP queue 1
        item 7), so no notice arrives yet."""
        poll_s = env_float("SERVING_PREEMPT_POLL_S", 0.2)
        while not self._stop.wait(poll_s):
            if self.batcher.draining:
                return
            applied = chaos_fire("preemption")
            if any(kind == "notice" for _seam, kind in applied):
                self.drain(source="preemption")
                return

    # -- readiness / health -------------------------------------------------
    def ready_doc(self) -> dict:
        depth = self.batcher.queue_depth()
        ready = (self._model_loaded and not self.batcher.draining
                 and depth <= self._ready_queue_max)
        return {"ready": ready, "replica": self.replica_id,
                "model_loaded": self._model_loaded,
                "draining": self.batcher.draining,
                "queue_depth": depth,
                "queue_budget": self._ready_queue_max,
                "version": self._version,
                "pinned": self._pin}

    def health_doc(self) -> dict:
        return {"status": "ok" if self._loop_alive else "starting",
                "replica": self.replica_id,
                "draining": self.batcher.draining,
                "drained": self.drained(),
                "version": self._version}

    # -- request path -------------------------------------------------------
    def handle_infer(self, doc: dict, trace=None) -> tuple:
        """(HTTP code, response doc).  Runs on a handler thread.
        ``trace`` is the dispatching router's attempt span (decoded
        from the ``traceparent`` header): this replica's ``serve`` span
        — covering batcher queue wait and the padded forward — becomes
        its child, so a hedged request's tree covers BOTH replicas."""
        req_id = str(doc.get("id") or f"anon-{time.monotonic_ns()}")
        serve_ctx = tracing.child(trace, "serving")
        t_handle = time.monotonic()
        wall_handle = time.time()
        # chaos seam ``serving.request`` (horovod_tpu/serving/replica.py
        # :466: `error` -> 500, `shed` -> explicit 429, `delay` sleeps);
        # open in the port, nothing is injected
        kinds = {kind for _seam, kind in chaos_fire("serving.request")}
        if "shed" in kinds:
            smetrics.inc_shed("chaos")
            return 429, {"id": req_id, "error": "chaos: injected shed"}
        # idempotency: an already-answered id returns the SAME response
        cached = self._cached_response(req_id)
        if cached is not None:
            tracing.record_span(
                "serving", "serve", serve_ctx, start=wall_handle,
                dur_s=time.monotonic() - t_handle,
                replica=self.replica_id, cached=True)
            return 200, cached
        try:
            x = np.asarray(doc.get("x"), dtype=np.float32)
        except (TypeError, ValueError):
            return 400, {"id": req_id, "error": "bad 'x' payload"}
        if x.shape != (self.dim,):
            # reject at admission: a wrong-width payload co-batched
            # with healthy requests would fail the WHOLE batch
            return 400, {"id": req_id,
                         "error": f"bad 'x' shape {x.shape}; this "
                                  f"replica serves width {self.dim}"}
        deadline_ms = doc.get("deadline_ms")
        deadline_s = float(deadline_ms) / 1000.0 \
            if deadline_ms is not None else None
        # in-flight dedup: a hedged duplicate joins the live request
        with self._pending_lock:
            pending = self._pending.get(req_id)
            fresh = pending is None
            if fresh:
                try:
                    pending = self.batcher.submit(req_id, x,
                                                  deadline_s=deadline_s)
                except DrainingError:
                    smetrics.inc_shed("draining")
                    return 503, {"id": req_id, "error": "draining"}
                except SheddedError as e:
                    return 429, {"id": req_id, "error": str(e)}
                self._pending[req_id] = pending
        try:
            wait_s = (pending.deadline - time.monotonic()) + 1.0
            y, version = pending.wait(timeout=max(wait_s, 0.1))
            resp = {"id": req_id, "y": np.asarray(y).tolist(),
                    "version": version, "replica": self.replica_id}
            if serve_ctx is not None:
                # the response names its trace so clients/benches can
                # join it against the span store without headers
                resp["trace"] = serve_ctx.trace_id
                resp["span"] = serve_ctx.span_id
            # the request's path THROUGH this replica: queue wait
            # (enqueue → batch formation) and the padded forward, as
            # child spans of the serve span — the per-hop latency
            # attribution the `diagnostics trace` tree prints
            queue_s = max(pending.formed_at - pending.enqueued_at, 0.0) \
                if pending.formed_at else 0.0
            # the replica slice of the request ledger
            # (docs/OBSERVABILITY.md "Serving request ledger"): the
            # four stages sum EXACTLY to this handler's wall time, so
            # the router can close the books — batch_wait is formation
            # → forward launch minus the named swap pause, response is
            # everything else (pre-queue admission, wakeup, assembly)
            total_s = time.monotonic() - t_handle
            swap_s = max(pending.swap_pause_s, 0.0)
            batch_wait_s = max(
                pending.started_at - pending.formed_at - swap_s, 0.0) \
                if pending.started_at and pending.formed_at else 0.0
            stages = {
                "queue": queue_s,
                "batch_wait": batch_wait_s,
                "forward": max(pending.forward_s, 0.0),
                "response": max(total_s - queue_s - batch_wait_s
                                - swap_s - pending.forward_s, 0.0),
            }
            if swap_s > 0:
                stages["swap_pause"] = swap_s
            resp["stages"] = {k: round(v, 6)
                              for k, v in stages.items()}
            tracing.record_span(
                "serving", "batcher_queue",
                tracing.child(serve_ctx, "serving"),
                start=wall_handle, dur_s=queue_s,
                replica=self.replica_id)
            tracing.record_span(
                "serving", "padded_forward",
                tracing.child(serve_ctx, "serving"),
                start=wall_handle + queue_s, dur_s=pending.forward_s,
                replica=self.replica_id, version=version)
            tracing.record_span(
                "serving", "serve", serve_ctx, start=wall_handle,
                dur_s=total_s,
                replica=self.replica_id, version=version,
                queue_s=round(queue_s, 6),
                forward_s=round(pending.forward_s, 6),
                **{f"stage_{k}": round(v, 6)
                   for k, v in stages.items() if v > 0})
            if fresh:
                # cache BEFORE the finally pops the in-flight entry: a
                # duplicate arriving in between must hit one of the two
                # (pop-then-cache would open a window where it
                # recomputes — possibly against freshly-swapped weights
                # — and returns a DIFFERENT answer)
                self._cache_response(req_id, resp)
            return 200, resp
        except DeadlineError as e:
            return 504, {"id": req_id, "error": str(e)}
        except Exception as e:
            return 500, {"id": req_id, "error": repr(e)}
        finally:
            if fresh:
                with self._pending_lock:
                    self._pending.pop(req_id, None)

    def handle_generate(self, doc: dict, trace=None) -> tuple:
        """(HTTP code, response doc) for ``POST /generate``: admit the
        prompt into the continuous-batching engine and block until the
        sequence finishes (tokens ride back in one response; streaming
        consumers use the engine API directly).

        Idempotency is the hedge-dedupe contract for MULTI-TOKEN
        responses: a duplicate of an id that is still decoding joins
        the live request BEFORE any second decode could start (the
        ``_pending`` table is checked under the same lock the fresh
        submit fills it), and a duplicate of a finished id replays the
        cached response — one id never decodes twice on this replica.
        Cross-replica duplication is closed on the router side: it
        never hedges /generate dispatches."""
        if self.engine is None:
            return 404, {"error": "this replica does not serve "
                                  "generate (mode=infer)"}
        req_id = str(doc.get("id") or f"anon-{time.monotonic_ns()}")
        serve_ctx = tracing.child(trace, "serving")
        t_handle = time.monotonic()
        wall_handle = time.time()
        # chaos seam ``serving.request`` (horovod_tpu/serving/replica.py
        # :606); open in the port, nothing is injected
        if "shed" in {kind for _seam, kind in chaos_fire("serving.request")}:
            smetrics.inc_shed("chaos")
            return 429, {"id": req_id, "error": "chaos: injected shed"}
        cached = self._cached_response(req_id)
        if cached is not None:
            tracing.record_span(
                "serving", "serve", serve_ctx, start=wall_handle,
                dur_s=time.monotonic() - t_handle,
                replica=self.replica_id, mode="generate", cached=True)
            return 200, cached
        try:
            prompt = np.asarray(doc.get("prompt"),
                                dtype=np.int32).reshape(-1)
        except (TypeError, ValueError):
            return 400, {"id": req_id, "error": "bad 'prompt' payload"}
        try:
            max_new = int(doc.get("max_new") or 16)
        except (TypeError, ValueError):
            return 400, {"id": req_id, "error": "bad 'max_new'"}
        deadline_ms = doc.get("deadline_ms")
        deadline_s = float(deadline_ms) / 1000.0 \
            if deadline_ms is not None else None
        with self._pending_lock:
            pending = self._pending.get(req_id)
            fresh = pending is None
            if fresh:
                try:
                    req = self.engine.submit(req_id, prompt, max_new,
                                             deadline_s=deadline_s,
                                             trace=serve_ctx)
                except DrainingError:
                    smetrics.inc_shed("draining")
                    return 503, {"id": req_id, "error": "draining"}
                except SheddedError as e:
                    return 429, {"id": req_id, "error": str(e)}
                except ValueError as e:
                    # definitive client error (too long, bad max_new):
                    # the router must NOT retry it fleet-wide
                    return 400, {"id": req_id, "error": str(e)}
                pending = req.pending
                self._pending[req_id] = pending
        try:
            wait_s = (pending.deadline - time.monotonic()) + 1.0
            result = pending.wait(timeout=max(wait_s, 0.1))
            resp = {"id": req_id, **result,
                    "version": result["weight_version"],
                    "replica": self.replica_id}
            if serve_ctx is not None:
                resp["trace"] = serve_ctx.trace_id
                resp["span"] = serve_ctx.span_id
            # merge the engine's ledger slice with the handler's:
            # ``response`` is the handler wall-clock OUTSIDE the
            # engine's submit→finish interval; the engine's own host
            # bookkeeping between ticks stays in the router's
            # unattributed residual — never relabeled
            total_s = time.monotonic() - t_handle
            stages = {k: float(v)
                      for k, v in (result.get("stages") or {}).items()}
            stages["response"] = max(
                total_s - float(result.get("total_s") or 0.0), 0.0)
            resp["stages"] = {k: round(v, 6)
                              for k, v in stages.items()}
            tracing.record_span(
                "serving", "serve", serve_ctx, start=wall_handle,
                dur_s=total_s,
                replica=self.replica_id, mode="generate",
                tokens_emitted=result.get("tokens_emitted"),
                finish_reason=result.get("finish_reason"),
                **{f"stage_{k}": round(v, 6)
                   for k, v in stages.items() if v > 0})
            if fresh:
                # cache BEFORE the finally pops the in-flight entry
                # (same window as handle_infer: a duplicate arriving in
                # between must hit one of the two, never re-decode)
                self._cache_response(req_id, resp)
            return 200, resp
        except DeadlineError as e:
            return 504, {"id": req_id, "error": str(e)}
        except Exception as e:
            return 500, {"id": req_id, "error": repr(e)}
        finally:
            if fresh:
                with self._pending_lock:
                    self._pending.pop(req_id, None)

    def _cached_response(self, req_id: str) -> Optional[dict]:
        with self._pending_lock:
            resp = self._resp_cache.get(req_id)
            if resp is not None:
                self._resp_cache.move_to_end(req_id)
                smetrics._reg().counter(
                    "hvd_serving_duplicate_hits_total",
                    help="hedged/retried duplicates answered from the "
                         "idempotent response cache").inc()
            return resp

    def _cache_response(self, req_id: str, resp: dict) -> None:
        with self._pending_lock:
            self._resp_cache[req_id] = resp
            while len(self._resp_cache) > self._resp_cache_max:
                self._resp_cache.popitem(last=False)

    # -- the serving loop ---------------------------------------------------
    def _serve_loop(self) -> None:
        self._loop_alive = True
        while not self._stop.is_set():
            if self.batcher.draining and self.batcher.drained():
                # stay alive to answer /healthz while the embedder
                # decides to exit; nothing left to serve
                time.sleep(0.05)
                continue
            batch = self.batcher.next_batch(timeout_s=0.2)
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:
                for req in batch:
                    req.set_error(e)
            finally:
                self.batcher.batch_done()

    def _run_batch(self, batch) -> None:
        # params-lock acquire time IS the weight-swap pause this batch
        # sat out (the hot swap holds the lock only for the pointer
        # flip) — named in the request ledger instead of hiding in
        # batch_wait
        t_lock = time.monotonic()
        with self._params_lock:
            params, version = self._params, self._version
        swap_pause_s = time.monotonic() - t_lock
        n = len(batch)
        xs = [np.atleast_1d(r.payload) for r in batch]
        width = xs[0].shape[-1]
        # pad to the FIXED max batch: one forward shape per width
        padded = np.zeros((self.batcher.max_batch_size, width),
                          dtype=np.float32)
        for i, x in enumerate(xs):
            padded[i, :] = x
        t0 = time.monotonic()
        for req in batch:
            req.started_at = t0
            req.swap_pause_s = swap_pause_s
        with torch.no_grad():
            out = self._apply_fn(
                params, torch.from_numpy(padded).to(self.device)
            ).cpu().numpy()
        forward_s = time.monotonic() - t0
        smetrics.observe_batch(n, top=self.batcher.max_batch_size)
        smetrics._reg().histogram(
            "hvd_serving_forward_seconds",
            help="compiled forward-pass wall time per batch",
            buckets=smetrics.LATENCY_BUCKETS).observe(forward_s)
        for i, req in enumerate(batch):
            # the version rides the result: a response must name the
            # weights that COMPUTED it, not whatever is live by the
            # time the handler unblocks (a swap can land in between)
            req.forward_s = forward_s
            req.set_result((out[i], version))


# -- HTTP front ---------------------------------------------------------------
class _ReplicaHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # silence access lines
        pass

    def _send(self, code: int, doc: dict,
              ctype: str = "application/json") -> None:
        try:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass  # client vanished; accounting happened upstream

    def do_GET(self):
        replica: ReplicaServer = self.server.replica
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/readyz":
            doc = replica.ready_doc()
            self._send(200 if doc["ready"] else 503, doc)
        elif path == "/healthz":
            doc = replica.health_doc()
            self._send(200 if doc["status"] == "ok" else 503, doc)
        elif path == "/metrics":
            from horovod_tpu_torch.metrics.registry import (
                default_registry, render_prometheus)
            body = render_prometheus(default_registry().snapshot())
            try:
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except OSError:
                pass
        elif path == "/status":
            self._send(200, {"ready": replica.ready_doc(),
                             "health": replica.health_doc()})
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        replica: ReplicaServer = self.server.replica
        path = self.path.split("?", 1)[0].rstrip("/")
        if path in ("/infer", "/generate"):
            try:
                length = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(length))
            except (ValueError, OSError):
                self._send(400, {"error": "bad request body"})
                return
            trace = tracing.decode(self.headers.get(tracing.TRACEPARENT))
            handler = replica.handle_generate if path == "/generate" \
                else replica.handle_infer
            code, resp = handler(doc, trace=trace)
            self._send(code, resp)
        elif path == "/drain":
            replica.drain(source="admin")
            self._send(200, {"draining": True,
                             "replica": replica.replica_id})
        elif path == "/pin":
            # {"version": N, "reason": "pin"|"rollback"} pins; a null/
            # absent version unpins.  The rollout controller's control
            # seam — same flip as a hot swap, never a dropped request.
            try:
                length = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(length)) if length \
                    else {}
            except (ValueError, OSError):
                self._send(400, {"error": "bad request body"})
                return
            version = doc.get("version")
            reason = str(doc.get("reason") or "pin")
            try:
                if version is None:
                    self._send(200, replica.unpin())
                else:
                    self._send(200, replica.pin(int(version),
                                                reason=reason))
            except Exception as e:
                self._send(500, {"error": repr(e),
                                 "replica": replica.replica_id})
        else:
            self._send(404, {"error": "not found"})


# -- subprocess entry ---------------------------------------------------------
def _write_port(path: str, port: int) -> None:
    """Publish the bound port atomically: the fleet reads the file as
    soon as it exists, so it must never see half a document."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"port": int(port), "pid": os.getpid()}, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    """``python -m horovod_tpu_torch.serving.replica`` — one
    fleet-managed replica process.  Prints ``SERVING port=<p>
    version=<v>`` once ready (and writes ``{"port": p}`` to
    ``--port-file``: the fleet starts replicas on port 0 and reads the
    port each one bound); exits 0 after a drain completes (the fleet
    classifies exit code 0 as DRAINED — planned, never failure
    evidence)."""
    p = argparse.ArgumentParser(prog="horovod_tpu_torch.serving.replica")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default=None,
                   help="write the bound port here as JSON once serving")
    p.add_argument("--store-dir", default=None)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--replica-id", default="r0")
    p.add_argument("--mode", choices=("infer", "generate"),
                   default="infer",
                   help="generate adds the continuous-batching decode "
                        "engine (POST /generate; the demo transformer "
                        "unless --flagship)")
    p.add_argument("--flagship", action="store_true",
                   help="generate mode serves the flagship (V 32000, M "
                        "512, 8x64 heads, L 4, F 2048, max_seq 256, fp32; "
                        "seed-0 weights until --store-dir holds a commit)")
    p.add_argument("--slots", type=int, default=None,
                   help="decode slots (default HVD_TPU_GEN_SLOTS)")
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cpu, cuda or cuda:N (default: this process's "
                        "card; without one the replica refuses to start)")
    p.add_argument("--pin-version", type=int, default=None,
                   help="restore and HOLD this durable-store step "
                        "instead of chasing the latest commit")
    args = p.parse_args(argv)

    # an uncaught exception leaves a flight dump in the autopsy
    # directory (JAX serving/replica.py:900-902); the JAX replica also
    # arms its chaos plan here (``chaos.install()``), which arrives with
    # the port's control plane (ROADMAP queue 1 item 7)
    from horovod_tpu_torch.diagnostics.flight_recorder import \
        install_crash_hooks
    install_crash_hooks()
    gen_model = None
    if args.flagship:
        from horovod_tpu_torch.serving.generate import flagship_gen_setup
        gen_model = flagship_gen_setup(device=args.device)
    replica = ReplicaServer(store_dir=args.store_dir, dim=args.dim,
                            port=args.port,
                            replica_id=args.replica_id,
                            mode=args.mode, gen_model=gen_model,
                            pin_version=args.pin_version,
                            device=args.device,
                            gen_kwargs={"n_slots": args.slots,
                                        "prefill_chunk": args.prefill_chunk}
                            ).start()

    import signal

    def _sigterm(_sig, _frm):
        threading.Thread(target=replica.drain,
                         kwargs={"source": "sigterm"},
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    if args.port_file:
        _write_port(args.port_file, replica.port)
    print(f"SERVING port={replica.port} version={replica._version}",
          flush=True)
    while not replica.wait_drained(timeout_s=1.0):
        pass
    print(f"DRAINED replica={args.replica_id} "
          f"source={replica._drain_source}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
