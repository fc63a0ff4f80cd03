"""Continuous dynamic batcher: the admission edge of a serving replica.

A copy of ``horovod_tpu/serving/batcher.py`` (host code, no device work).

Requests are admitted into a BOUNDED queue (backpressure is explicit:
an admission past the bound raises :class:`SheddedError`, which the
HTTP layer answers as 429 — never a silent drop), then formed into
batches by the serving loop: a batch closes when it reaches
``max_batch_size`` or the OLDEST member has waited ``max_wait_s``
(latency-bounded batching: an idle replica answers a lone request at
~zero batching delay, a busy one amortizes the forward pass).

Every request carries an absolute deadline; a request whose deadline
expires while still queued is failed at batch-formation time with
:class:`DeadlineError` (again explicit — counted as
``hvd_serving_shed_total{where="deadline"}``) instead of wasting the
accelerator on an answer nobody is waiting for.

Draining (docs/SERVING.md "Drain semantics"): :meth:`drain` atomically
stops admission (new submits raise :class:`DrainingError` → 503, so
routers stop sending) while everything already admitted is still
served; :meth:`drained` turns true once the queue is empty AND no batch
is in flight — the point at which a doomed replica may exit DRAINED.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional

from horovod_tpu_torch.common.config import env_float, env_int
from horovod_tpu_torch.serving import metrics as smetrics


class SheddedError(RuntimeError):
    """Admission refused: the bounded queue is at budget (429)."""


class DrainingError(RuntimeError):
    """Admission refused: this replica is draining (503)."""


class DeadlineError(RuntimeError):
    """The request's deadline expired before compute."""


class PendingRequest:
    """One admitted request: the handler thread blocks on
    :meth:`wait`; the serving loop fulfills it with :meth:`set_result`
    / :meth:`set_error`."""

    __slots__ = ("id", "payload", "deadline", "enqueued_at",
                 "formed_at", "started_at", "forward_s",
                 "swap_pause_s", "_event", "_result", "_error")

    def __init__(self, req_id: str, payload: Any,
                 deadline: float) -> None:
        self.id = req_id
        self.payload = payload
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        # request-ledger attribution (docs/OBSERVABILITY.md "Serving
        # request ledger"): when the batch formed (queue wait ends),
        # when its forward launched (batch_wait ends — padding + params
        # lock), how long the padded forward took, and any weight-swap
        # pause the batch sat out — stamped by next_batch / the serving
        # loop
        self.formed_at: float = 0.0
        self.started_at: float = 0.0
        self.forward_s: float = 0.0
        self.swap_pause_s: float = 0.0
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def set_result(self, result: Any) -> None:
        self._result = result
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise DeadlineError(f"request {self.id}: no result within "
                                f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class DynamicBatcher:
    """Bounded-queue continuous batcher (knobs: docs/KNOBS.md —
    ``HVD_TPU_SERVING_MAX_BATCH``, ``_MAX_WAIT_MS``, ``_QUEUE``,
    ``_DEADLINE_MS``)."""

    def __init__(self, max_batch_size: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None) -> None:
        self.max_batch_size = max_batch_size if max_batch_size \
            else env_int("SERVING_MAX_BATCH", 8)
        self.max_wait_s = max_wait_s if max_wait_s is not None \
            else env_float("SERVING_MAX_WAIT_MS", 5.0) / 1000.0
        self.max_queue = max_queue if max_queue \
            else env_int("SERVING_QUEUE", 64)
        self.default_deadline_s = default_deadline_s \
            if default_deadline_s is not None \
            else env_float("SERVING_DEADLINE_MS", 30_000.0) / 1000.0
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._draining = False
        self._inflight_batches = 0

    # -- admission ----------------------------------------------------------
    def submit(self, req_id: str, payload: Any,
               deadline_s: Optional[float] = None) -> PendingRequest:
        deadline = time.monotonic() + (
            deadline_s if deadline_s is not None
            else self.default_deadline_s)
        req = PendingRequest(req_id, payload, deadline)
        with self._not_empty:
            if self._draining:
                raise DrainingError("replica is draining")
            if len(self._q) >= self.max_queue:
                smetrics.inc_shed("queue")
                raise SheddedError(
                    f"batch queue at budget ({self.max_queue})")
            self._q.append(req)
            smetrics.set_queue_depth(len(self._q))
            self._not_empty.notify()
        return req

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    # -- batch formation ----------------------------------------------------
    def next_batch(self, timeout_s: float = 0.5) \
            -> Optional[List[PendingRequest]]:
        """The serving loop's pull: block up to ``timeout_s`` for a
        first request, then hold the batch open until it is full or the
        oldest member has waited ``max_wait_s``.  Expired-deadline
        requests are failed here and never returned.  ``None`` on
        timeout (lets the loop poll drain/swap state)."""
        deadline = time.monotonic() + timeout_s
        with self._not_empty:
            while not self._q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            # batch window: open from the OLDEST member's enqueue
            window_end = self._q[0].enqueued_at + self.max_wait_s
            while len(self._q) < self.max_batch_size:
                remaining = window_end - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            batch: List[PendingRequest] = []
            now = time.monotonic()
            while self._q and len(batch) < self.max_batch_size:
                req = self._q.popleft()
                if req.deadline <= now:
                    smetrics.inc_shed("deadline")
                    req.set_error(DeadlineError(
                        f"request {req.id}: deadline expired after "
                        f"{now - req.enqueued_at:.3f}s in queue"))
                    continue
                req.formed_at = now
                batch.append(req)
            smetrics.set_queue_depth(len(self._q))
            if not batch:
                return None
            self._inflight_batches += 1
            return batch

    def batch_done(self) -> None:
        """The serving loop finished (fulfilled) a batch it took."""
        with self._not_empty:
            self._inflight_batches = max(0, self._inflight_batches - 1)
            self._not_empty.notify_all()

    # -- drain --------------------------------------------------------------
    def drain(self) -> None:
        with self._not_empty:
            self._draining = True
            self._not_empty.notify_all()
        smetrics.set_draining(True)

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        """True once draining AND nothing admitted remains unanswered."""
        with self._lock:
            return self._draining and not self._q \
                and self._inflight_batches == 0

    def wait_drained(self, timeout_s: float = 30.0) -> bool:
        end = time.monotonic() + timeout_s
        with self._not_empty:
            while not (self._draining and not self._q
                       and self._inflight_batches == 0):
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._not_empty.wait(min(remaining, 0.1))
            return True
