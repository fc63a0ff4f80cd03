"""The hardened HTTP server of the port's HTTP planes.

Only :class:`ThreadedHTTPServer` is ported so far, a copy of
``horovod_tpu/runner/http_kv.py:81``: the bounded handler pool (overflow
answered 503 inline and counted as ``hvd_http_busy_rejected_total``),
per-request socket timeouts and explicit SO_REUSEADDR. The KV store and
rendezvous server around it arrive with the runner (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Optional

from horovod_tpu_torch.common.safe_metrics import safe_inc as _metric


class ThreadedHTTPServer(ThreadingHTTPServer):
    """Shared server base for the port's tiny HTTP planes (the serving
    replica and front ends of :mod:`horovod_tpu_torch.serving`; the KV
    store and the metrics exporter when they are ported): threaded,
    daemonized, with a deep accept backlog — many agents poll
    concurrently and the socketserver default backlog of 5 resets
    connections under bursts on slow machines.

    Hardened for the serving plane, benefiting every endpoint that rides
    it (``/metrics`` scrapes, ``/readyz`` probes):

    * **bounded concurrent-handler pool** — at most
      ``HVD_TPU_HTTP_MAX_HANDLERS`` (default 64) requests are handled
      at once; beyond that the connection gets an immediate minimal
      ``503`` + close instead of an unbounded thread pile-up (counted
      as ``hvd_http_busy_rejected_total``).  The plain ThreadingMixIn
      spawns one thread per accepted connection with no cap — a
      misbehaving poller could grow threads until the process died.
    * **per-request read/write timeouts** — every accepted socket gets
      ``HVD_TPU_HTTP_TIMEOUT_S`` (default 30) as its socket timeout, so
      one wedged or glacial client times out and frees its handler slot
      instead of pinning a thread (and, with the pool bound, eventually
      the whole plane) forever.

    Both knobs can be overridden per server via the ``max_handlers`` /
    ``handler_timeout_s`` constructor arguments (0 disables)."""

    request_queue_size = 128
    # SO_REUSEADDR, stated explicitly rather than inherited: a server that
    # rebinds a port it (or a crashed predecessor) held must not wait out
    # the old connections' TIME_WAIT (in the JAX package: the takeover
    # driver rebinding the crashed driver's KV port).
    allow_reuse_address = 1

    def __init__(self, server_address, RequestHandlerClass,
                 max_handlers: Optional[int] = None,
                 handler_timeout_s: Optional[float] = None) -> None:
        super().__init__(server_address, RequestHandlerClass)
        from horovod_tpu_torch.common.config import env_float, env_int
        if max_handlers is None:
            max_handlers = env_int("HTTP_MAX_HANDLERS", 64)
        if handler_timeout_s is None:
            handler_timeout_s = env_float("HTTP_TIMEOUT_S", 30.0)
        self.handler_timeout_s = handler_timeout_s
        self._handler_slots = (
            threading.BoundedSemaphore(max_handlers)
            if max_handlers and max_handlers > 0 else None)

    def process_request(self, request, client_address):
        if self.handler_timeout_s and self.handler_timeout_s > 0:
            try:
                # read/write deadline for the whole exchange: a client
                # that stops sending (or reading) raises socket.timeout
                # in the handler, which closes the connection
                request.settimeout(self.handler_timeout_s)
            except OSError:
                pass
        if self._handler_slots is not None and \
                not self._handler_slots.acquire(blocking=False):
            self._reject_busy(request)
            return
        try:
            super().process_request(request, client_address)
        except Exception:
            if self._handler_slots is not None:
                self._handler_slots.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            if self._handler_slots is not None:
                self._handler_slots.release()

    def _reject_busy(self, request) -> None:
        """Every handler slot is busy: answer a minimal 503 inline (on
        the accept thread — no new thread, no handler parse) and close.
        Explicit backpressure, never a silent drop: the client sees a
        retryable status, the operator sees the counter."""
        _metric("hvd_http_busy_rejected_total",
                "connections rejected 503 because every handler slot "
                "of a ThreadedHTTPServer was busy")
        try:
            request.sendall(
                b"HTTP/1.1 503 Service Unavailable\r\n"
                b"Retry-After: 1\r\nContent-Length: 5\r\n"
                b"Connection: close\r\n\r\nbusy\n")
        except OSError:
            pass
        try:
            self.shutdown_request(request)
        except OSError:
            pass

    def handle_error(self, request, client_address):
        # a wedged client timing out (or vanishing mid-write) is the
        # EXPECTED outcome of the per-request deadline policy, not a
        # server bug — don't spray tracebacks on stderr for it
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (TimeoutError, ConnectionError, OSError)):
            return
        super().handle_error(request, client_address)
