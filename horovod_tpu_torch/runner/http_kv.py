"""HTTP key-value store + rendezvous server and client.

A copy of ``horovod_tpu/runner/http_kv.py`` (reference:
``horovod/runner/http/http_server.py:35-175``, ``KVStoreHandler`` GET/PUT
by scope/key, and ``http/http_client.py``): the elastic driver's KV
(world documents, listener registrations, drain notices, completion
receipts), the workers' notification listeners, ``kv_get``/``kv_put``
with the shared retry policy, and :class:`ThreadedHTTPServer`, the
hardened server every HTTP plane of the port rides (the serving replica
and front ends, the metrics exporter, the KV). The client fires the chaos
seams ``kv.request`` and ``kv.partition`` on every attempt, as the JAX
client does, so an injected blackout is ridden out by the same retries.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.error import HTTPError
from urllib.request import Request, urlopen

from horovod_tpu_torch.common.retry import retry_call
from horovod_tpu_torch.common.safe_metrics import safe_inc as _metric


class _KVHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # silence
        pass

    def _split(self) -> Tuple[str, str]:
        parts = self.path.strip("/").split("/", 1)
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return scope, key

    def do_GET(self):
        scope, key = self._split()
        self.server.note_request("GET", scope)
        with self.server.kv_lock:
            val = self.server.kv.get(scope, {}).get(key)
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_PUT(self):
        scope, key = self._split()
        self.server.note_request("PUT", scope)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        # write observer BEFORE the store and the 200: the elastic
        # driver journals worker registrations through this hook, and
        # WAL ordering requires the append to be durable before the
        # writer is told its registration took (a post-ack crash must
        # not lose acknowledged control-plane state).  Outside kv_lock:
        # the hook may fsync and must not stall concurrent KV traffic.
        hook = getattr(self.server, "on_put", None)
        if hook is not None:
            try:
                hook(scope, key, body)
            except Exception:
                pass  # observation must never fail the write itself
        with self.server.kv_lock:
            self.server.kv.setdefault(scope, {})[key] = body
        self.send_response(200)
        self.end_headers()

    def do_DELETE(self):
        scope, _ = self._split()
        self.server.note_request("DELETE", scope)
        with self.server.kv_lock:
            self.server.kv.pop(scope, None)
        self.send_response(200)
        self.end_headers()


class ThreadedHTTPServer(ThreadingHTTPServer):
    """Shared server base for the port's tiny HTTP planes (the KV store
    here, the serving replica and front ends of
    :mod:`horovod_tpu_torch.serving`, the metrics exporter): threaded,
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
    # SO_REUSEADDR, stated explicitly rather than inherited: a takeover
    # driver must rebind the crashed driver's advertised KV port on the
    # same host while the old socket's connections sit in TIME_WAIT.
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


class _KVServer(ThreadedHTTPServer):
    """Request accounting lives on the server object (one per
    KVStoreServer): the KV-relay fan-in proof (docs/ELASTIC.md "Relayed
    control-plane KV") needs each NODE's request load to be measurable —
    rank 0's root must be shown handling O(arity) worker traffic while
    the relay nodes carry the rest."""

    def note_request(self, method: str, scope: str) -> None:
        key = (method, scope)
        with self.req_lock:
            self.req_counts[key] = self.req_counts.get(key, 0) + 1
        _metric("hvd_kv_server_requests_total",
                "requests handled by this process's KV servers, "
                "per method/scope", method=method, scope=scope)


class KVStoreServer:
    """Threaded KV server (reference: ``RendezvousServer.start``,
    ``http_server.py:152``)."""

    def __init__(self, port: int = 0) -> None:
        self._httpd = self._make_server(port)
        self._httpd.kv = {}
        self._httpd.kv_lock = threading.Lock()
        self._httpd.req_counts = {}
        self._httpd.req_lock = threading.Lock()
        self._httpd.on_put = None
        self._thread: Optional[threading.Thread] = None

    @property
    def on_put(self):
        """Optional ``(scope, key, value)`` observer invoked on every
        HTTP PUT before the value is stored and acknowledged (the
        driver's journal WAL hook).  Exceptions are swallowed; the
        write always proceeds."""
        return getattr(self._httpd, "on_put", None)

    @on_put.setter
    def on_put(self, cb) -> None:
        self._httpd.on_put = cb

    def _make_server(self, port: int):
        return _KVServer(("0.0.0.0", port), _KVHandler)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self, port: Optional[int] = None) -> int:
        """Start serving.  ``port`` rebinds the server onto that specific
        port first (takeover: a fresh driver process must come up on the
        port the fleet's ``HVD_ELASTIC_KV`` already advertises).  The
        in-memory KV contents survive the rebind — the takeover path
        re-publishes into the same server object it just rebound."""
        if port is not None and port != self.port:
            self._rebind(port)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def _rebind(self, port: int) -> None:
        """Replace the bound socket with one on ``port``, keeping the KV
        dict, locks and request counts.  Retries the bind briefly: the
        dead driver's kernel socket can linger a beat past its process
        (SO_REUSEADDR clears TIME_WAIT but not a still-open listener in
        a not-yet-reaped process)."""
        import time as _time
        old = self._httpd
        try:
            old.server_close()
        except OSError:
            pass
        deadline = _time.monotonic() + 10.0
        while True:
            try:
                httpd = self._make_server(port)
                break
            except OSError:
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.25)
        # transplant state: the KV dict IS the control-plane content
        httpd.kv = old.kv
        httpd.kv_lock = old.kv_lock
        httpd.req_counts = old.req_counts
        httpd.req_lock = old.req_lock
        httpd.on_put = getattr(old, "on_put", None)
        self._httpd = httpd

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # a wedged handler (slow client, injected fault) is
                # outliving shutdown — the daemon thread won't block exit,
                # but leaking it silently hides the wedge from operators
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning(
                    "KVStoreServer.stop(): server thread still alive "
                    "after 5s join; leaking a daemon thread (port %s)",
                    self.port)

    # direct access for in-process use
    def put(self, scope: str, key: str, value: bytes) -> None:
        with self._httpd.kv_lock:
            self._httpd.kv.setdefault(scope, {})[key] = value

    def get(self, scope: str, key: str) -> Optional[bytes]:
        with self._httpd.kv_lock:
            return self._httpd.kv.get(scope, {}).get(key)

    def scope(self, scope: str) -> Dict[str, bytes]:
        with self._httpd.kv_lock:
            return dict(self._httpd.kv.get(scope, {}))

    def clear(self, scope: str) -> None:
        with self._httpd.kv_lock:
            self._httpd.kv.pop(scope, None)

    def request_counts(self) -> Dict[Tuple[str, str], int]:
        """Requests this server has handled, keyed by (method, scope) —
        the per-node load evidence behind the KV-relay fan-in proof."""
        with self._httpd.req_lock:
            return dict(self._httpd.req_counts)

    def requests_for(self, scope: str, method: Optional[str] = None) -> int:
        with self._httpd.req_lock:
            return sum(n for (m, s), n in self._httpd.req_counts.items()
                       if s == scope and (method is None or m == method))


class HTTPBusyError(OSError):
    """A 429/503 backpressure answer converted to a RETRYABLE error:
    the hardened handler pool's inline 503 busy-reject advertises
    ``Retry-After`` and means "again in a moment", not "never" — but
    ``HTTPError`` sits in the retry shield's ``give_up_on``, so
    without the conversion the first busy burst would terminally fail
    a KV call that a 50ms backoff would have saved.  Subclasses
    ``OSError`` so the relay client's broad fallback handling still
    sees it as a transient transport problem."""


def _with_retries(do, attempts: int = 4,
                  deadline_s: Optional[float] = None,
                  site: str = "http_kv",
                  count_exhausted: bool = True):
    """Transient-error shield: a busy single-core box can overflow the
    server's listen backlog under polling bursts, resetting connections
    mid-handshake; retry with jittered backoff instead of failing a
    worker.  ``deadline_s`` caps TOTAL wall time (attempts + sleeps) so
    the call's cost stays tied to the caller's intent instead of
    ``attempts × per-attempt timeout``; ``site`` labels the per-call-site
    retry metrics (``hvd_retry_*_total{site=...}``).  HTTP 429/503 —
    explicit backpressure, incl. the bounded handler pool's busy
    reject — retries like a connection reset; other HTTP statuses
    (404, 4xx) stay terminal."""
    import http.client

    def do_busy_aware():
        try:
            return do()
        except HTTPError as e:
            if e.code in (429, 503):
                raise HTTPBusyError(
                    f"HTTP {e.code} (backpressure) from {e.url}") from e
            raise

    return retry_call(
        do_busy_aware, site=site,
        retry_on=(ConnectionError, http.client.RemoteDisconnected,
                  TimeoutError, OSError),
        give_up_on=(HTTPError,),
        attempts=attempts, base_delay_s=0.05, backoff=2.0,
        max_delay_s=2.0, jitter=0.25, deadline_s=deadline_s,
        count_exhausted=count_exhausted)


def _trace_headers() -> Dict[str, str]:
    """The thread's active trace context as a ``traceparent`` header
    (docs/OBSERVABILITY.md "Causal tracing"): a KV hop made inside an
    ``activate()`` block carries its span, so relay forwards and the
    receiving server can continue the causal chain.  Empty when
    untraced — zero wire cost."""
    try:
        from horovod_tpu_torch import tracing
        ctx = tracing.current()
        if ctx is not None:
            return {tracing.TRACEPARENT: ctx.traceparent}
    except Exception:
        pass
    return {}


def kv_put(addr: str, port: int, scope: str, key: str, value: bytes,
           timeout: float = 30.0, site: str = "http_kv.put",
           peer=None, attempts: int = 4,
           count_exhausted: bool = True) -> None:
    """``peer`` names the request's TARGET for the chaos ``kv.partition``
    seam (a worker rank for relay hops, ``"driver"`` for the root KV);
    None = target unknown, partition rules cannot match.  ``attempts=1``
    makes the call fail fast — the relay client uses it for parent hops,
    where the root fallback IS the retry."""
    req = Request(f"http://{addr}:{port}/{scope}/{key}", data=value,
                  method="PUT", headers=_trace_headers())

    def do():
        # chaos seams (horovod_tpu/runner/http_kv.py:399-401)
        from horovod_tpu_torch import chaos
        chaos.fire("kv.request")
        chaos.fire("kv.partition", peer=peer)
        return urlopen(req, timeout=timeout).read()

    _with_retries(do, attempts=attempts, deadline_s=2.0 * timeout,
                  site=site, count_exhausted=count_exhausted)


def kv_get(addr: str, port: int, scope: str, key: str,
           timeout: float = 30.0, site: str = "http_kv.get",
           peer=None, attempts: int = 4,
           count_exhausted: bool = True) -> Optional[bytes]:
    def do():
        # chaos seams as in kv_put (horovod_tpu/runner/http_kv.py:413-415)
        from horovod_tpu_torch import chaos
        chaos.fire("kv.request")
        chaos.fire("kv.partition", peer=peer)
        req = Request(f"http://{addr}:{port}/{scope}/{key}",
                      headers=_trace_headers())
        return urlopen(req, timeout=timeout).read()

    try:
        return _with_retries(do, attempts=attempts,
                             deadline_s=2.0 * timeout, site=site,
                             count_exhausted=count_exhausted)
    except HTTPError as e:
        if e.code == 404:
            return None
        raise


