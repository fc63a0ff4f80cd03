"""Per-worker HTTP metrics exporter: ``/metrics`` + ``/healthz``.

A copy of ``horovod_tpu/metrics/exporter.py``: a Prometheus-compatible
scrape endpoint over the threaded HTTP server of the port's HTTP planes
(:mod:`horovod_tpu_torch.runner.http_kv`). One exporter per worker
process; on a multi-worker host each worker binds
``HVD_TPU_METRICS_PORT + local_rank`` so a pod-wide scrape config is just
``host:base_port+i``. The same routes serve liveness (``/healthz``),
readiness (``/readyz``), the fleet fan-in tree (``/metrics/fleet``,
``POST /metrics/push``) and the hang-autopsy and profiling endpoints
(``/debug/{stacks,flight,engine,profile,exemplars}``), each answered from
the server's own threads, so they serve while training is blocked.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler
from typing import Callable, Iterable, Optional

from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.metrics.registry import (Registry, default_registry,
                                                render_prometheus)
from horovod_tpu_torch.runner.http_kv import ThreadedHTTPServer

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def peer_endpoint(rank: int, base_port: int,
                  hosts: Optional[list] = None) -> tuple:
    """(host, exporter port) for ``rank`` under the exporter contract:
    port is ``base + local rank`` (the rank's index among the ranks
    sharing its host), host from a rank-indexed ``HVD_TPU_PEER_HOSTS``
    list.  THE one implementation of the peer-address derivation — the
    autopsy's cross-rank evidence fetch and the fleet tree's upstream
    push both route through it, so the addressing contract cannot
    silently fork.  A rank beyond (or blank in) the host map falls back
    to the no-map convention (loopback, base + global rank) instead of
    raising — a short map must degrade, not kill the caller's loop."""
    if hosts and rank < len(hosts) and hosts[rank]:
        host = hosts[rank]
        local = sum(1 for q in range(rank)
                    if q < len(hosts) and hosts[q] == host)
        return host, base_port + local
    return "127.0.0.1", base_port + rank


class _MetricsHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # silence per-scrape access lines
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        raw_path, _, query = self.path.partition("?")
        path = raw_path.rstrip("/") or "/"
        exporter: "MetricsExporter" = self.server.exporter
        if path in ("/metrics", "/"):
            body = exporter.render().encode()
            self._send(200, body, CONTENT_TYPE)
        elif path == "/metrics/fleet":
            # tree-aggregated whole-job view (docs/OBSERVABILITY.md
            # "Fleet view"): rank 0 serves the full fleet; any other
            # rank serves its subtree (useful for debugging a branch)
            fleet = exporter.fleet
            if fleet is None:
                self._send(404, b"fleet aggregation not enabled\n",
                           "text/plain")
                return
            try:
                body = fleet.render_fleet().encode()
            except Exception as e:
                self._send(500, repr(e).encode() + b"\n", "text/plain")
                return
            self._send(200, body, CONTENT_TYPE)
        elif path == "/healthz":
            doc = exporter.health()
            code = 200 if doc.get("status") == "ok" else 503
            self._send(code, json.dumps(doc).encode(), "application/json")
        elif path == "/readyz":
            # READINESS, split from /healthz LIVENESS (docs/SERVING.md):
            # healthz answers "is the process alive and making progress"
            # (restart me when not); readyz answers "should you route
            # traffic/work at me right now" (a draining or still-
            # restoring replica is alive but NOT ready) — orchestrators
            # that conflate the two discover drain via errors
            doc = exporter.ready()
            code = 200 if doc.get("ready") else 503
            self._send(code, json.dumps(doc).encode(), "application/json")
        elif path.startswith("/debug/"):
            self._debug(path[len("/debug/"):], query)
        else:
            self._send(404, b"not found\n", "text/plain")

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        exporter: "MetricsExporter" = self.server.exporter
        if path != "/metrics/push":
            self._send(404, b"not found\n", "text/plain")
            return
        fleet = exporter.fleet
        if fleet is None:
            self._send(404, b"fleet aggregation not enabled\n",
                       "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length))
            accepted = fleet.ingest(doc)
        except Exception as e:  # a malformed push must not kill serving
            self._send(400, repr(e).encode() + b"\n", "text/plain")
            return
        if accepted:
            self._send(200, b"ok\n", "text/plain")
        else:
            # 409: sender is from another world/generation — tells an
            # elastic straggler to stop pushing here
            self._send(409, b"rejected (world/generation mismatch)\n",
                       "text/plain")

    def _debug(self, kind: str, query: str = "") -> None:
        """Hang-autopsy evidence + deep-profiling endpoints
        (docs/OBSERVABILITY.md "Flight recorder & hang autopsy" /
        "Deep profiling"): rank 0's watchdog scrapes every peer's
        ``/debug/stacks`` / ``/debug/flight`` / ``/debug/engine`` so
        one directory answers "which rank is stuck in what", and
        ``/debug/profile?steps=N`` arms a bounded device-trace capture
        of the next N steps (``&peers=1`` fans the request out to every
        peer exporter via the ``HVD_TPU_PEER_HOSTS`` map).  Served from
        the exporter's own thread pool, so they answer even while the
        training thread is wedged."""
        try:
            if kind == "profile":
                self._send(200,
                           json.dumps(_arm_profile(query),
                                      default=str).encode(),
                           "application/json")
            elif kind == "stacks":
                from horovod_tpu_torch.diagnostics.autopsy import \
                    stacks_text
                self._send(200, stacks_text().encode(), "text/plain")
            elif kind == "flight":
                from horovod_tpu_torch.diagnostics.flight_recorder import \
                    recorder
                self._send(200,
                           json.dumps(recorder().dump(),
                                      default=str).encode(),
                           "application/json")
            elif kind == "engine":
                from horovod_tpu_torch.diagnostics.autopsy import engine_doc
                self._send(200,
                           json.dumps(engine_doc(), default=str).encode(),
                           "application/json")
            elif kind == "exemplars":
                # the serving ledger's tail exemplars: worst requests
                # per window with trace id + full stage breakdown
                # (docs/OBSERVABILITY.md "Serving request ledger")
                from horovod_tpu_torch.serving.ledger import exemplars
                self._send(200,
                           json.dumps({"exemplars": exemplars()},
                                      default=str).encode(),
                           "application/json")
            else:
                self._send(404, b"unknown debug endpoint\n", "text/plain")
        except Exception as e:  # evidence collection must never crash
            self._send(500, repr(e).encode() + b"\n", "text/plain")


def _arm_profile(query: str) -> dict:
    """``/debug/profile`` body: arm a capture on THIS rank (and, with
    ``peers=1``, on every peer reachable through the autopsy's
    ``HVD_TPU_PEER_HOSTS`` addressing).  The capture starts at the next
    step boundary; the response carries the planned trace path (or
    ``started: false`` when a capture is already pending/active)."""
    from urllib.parse import parse_qs
    from urllib.request import urlopen

    from horovod_tpu_torch.profiling import default_manager
    params = parse_qs(query)

    def _int(name, default):
        try:
            return int(params[name][0])
        except (KeyError, IndexError, ValueError):
            return default

    steps = _int("steps", 0) or None
    info = default_manager().request_capture(steps=steps,
                                             reason="debug_endpoint")
    doc = {"rank": _best_effort_rank(), "started": info is not None}
    if info is not None:
        doc["path"] = info["path"]
        doc["steps"] = info["steps"]
    else:
        doc["status"] = default_manager().status()
    if _int("peers", 0):
        from horovod_tpu_torch.diagnostics.autopsy import peer_debug_ports
        peers = {}
        steps_q = f"?steps={steps}" if steps else ""
        for r, (host, port) in sorted(peer_debug_ports().items()):
            url = f"http://{host}:{port}/debug/profile{steps_q}"
            try:
                body = urlopen(url, timeout=5.0).read()
                peers[str(r)] = json.loads(body)
            except Exception as e:  # best-effort fan-out
                peers[str(r)] = {"error": repr(e)}
        doc["peers"] = peers
    return doc


def _best_effort_rank() -> int:
    from horovod_tpu_torch.diagnostics.flight_recorder import (
        _best_effort_rank as _rank)
    return _rank()


class MetricsExporter:
    """Threaded scrape server for one worker process.

    Args:
      registry: registry to render (default: the process-wide one).
      port: TCP port; 0 binds an ephemeral port (tests).
      health_fn: optional callable returning the ``/healthz`` JSON doc;
        default reports ``{"status": "ok"}``. ``/readyz`` derives from
        it (ready iff healthy); serving replicas implement the /readyz
        contract on their own request server
        (:mod:`horovod_tpu_torch.serving.replica`).

      collectors: callables run before each render to refresh derived
        gauges (the eager engine's
        :class:`~horovod_tpu_torch.metrics.engine.EngineCollector`).

    The JAX exporter also takes a separate ``ready_fn``; no caller of the
    port's needs one.
    """

    def __init__(self, registry: Optional[Registry] = None, port: int = 0,
                 health_fn: Optional[Callable[[], dict]] = None,
                 collectors: Iterable[Callable[[], None]] = ()) -> None:
        self._registry = registry or default_registry()
        self._collectors = list(collectors)
        self._health_fn = health_fn
        self._httpd = ThreadedHTTPServer(("0.0.0.0", port), _MetricsHandler)
        self._httpd.exporter = self
        self._thread: Optional[threading.Thread] = None
        # fleet fan-in node served/fed through this exporter's HTTP
        # plane (/metrics/fleet, /metrics/push); owned: stop() stops it
        self.fleet = None  # metrics.fleet.FleetAggregator

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def render(self) -> str:
        for fn in self._collectors:
            try:
                fn()
            except Exception as e:  # scrapes must never crash training
                get_logger().debug("metrics collector %r failed: %r", fn, e)
        return render_prometheus(self._registry.snapshot())

    def health(self) -> dict:
        if self._health_fn is not None:
            try:
                return self._health_fn()
            except Exception as e:
                return {"status": "error", "error": repr(e)}
        return {"status": "ok"}

    def ready(self) -> dict:
        """The ``/readyz`` doc: ready iff healthy (a failing health probe
        reads as not ready)."""
        h = self.health()
        return {"ready": h.get("status") == "ok", "health": h}

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-tpu-metrics",
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        # the tree node first: its push loop targets peers that are
        # also shutting down, and it must not outlive its own registry
        if self.fleet is not None:
            try:
                self.fleet.stop()
            except Exception:
                pass
            self.fleet = None
        # shutdown() handshakes with serve_forever() and blocks forever if
        # the serving thread was never started — only call it after start()
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()


def start_worker_exporter(state) -> Optional[MetricsExporter]:
    """Start the per-worker exporter for an initialized ``_GlobalState``
    when ``HVD_TPU_METRICS_PORT`` is set (>0). Called from ``init``;
    never raises — a port squat degrades to a warning, not a failed init.
    """
    cfg = state.config
    base = getattr(cfg, "metrics_port", 0)
    if not base or base <= 0:
        return None
    port = base + max(state.local_rank, 0)

    def health():
        """Liveness, not just process-up: last step age + watchdog state
        + engine reachability, going 503 (``status != ok``) once the
        step age crosses the watchdog threshold — an external
        orchestrator can act on the stall BEFORE the in-process autopsy
        fires."""
        doc = {"status": "ok" if state.initialized else "shutdown",
               "rank": state.rank, "size": state.size,
               "hostname": state.hostname}
        from horovod_tpu_torch.diagnostics import watchdog as _wd
        live = _wd.liveness()
        age = live.get("last_step_age_s")
        doc["watchdog"] = {"armed": live["armed"],
                           "timeout_s": live["timeout_s"],
                           "last_fed_age_s": age}
        doc["last_step"] = live.get("last_step")
        doc["last_step_age_s"] = age
        # the eager engine answers its counters, or is not started yet
        be = getattr(state, "eager", None)
        engine_alive = None
        if be is not None:
            try:
                be.counters()
                engine_alive = True
            except Exception:
                engine_alive = False
        doc["engine_alive"] = engine_alive
        threshold = live["timeout_s"]
        if doc["status"] == "ok" and threshold and threshold > 0 \
                and age is not None and age > threshold:
            # steps HAVE been flowing (age is only set after the first
            # progress stamp) and then stopped past the hang threshold
            doc["status"] = "stalled"
        return doc

    registry = default_registry()
    # a re-meshed world must not serve the dead engine's last values as
    # live state: the mirror gauges are filled again by the NEW
    # collector at its first scrape (hvd_stall_warnings_total, a
    # cumulative counter of another prefix, survives)
    for prefix in ("hvd_engine_", "hvd_straggler_"):
        registry.drop_prefix(prefix)
    for name in ("hvd_autotune_fusion_bytes", "hvd_autotune_cycle_ms",
                 "hvd_autotune_hierarchical", "hvd_autotune_cache_enabled"):
        registry.drop_prefix(name)
    from horovod_tpu_torch.common.basics import (counters as _counters,
                                                 stragglers as _stragglers)
    from horovod_tpu_torch.metrics.engine import EngineCollector
    collector = EngineCollector(_counters, registry=registry,
                                stragglers_fn=_stragglers)
    try:
        exp = MetricsExporter(registry=registry, port=port,
                              health_fn=health,
                              collectors=[collector.collect])
        exp.start()
    except (OSError, OverflowError) as e:  # squat or base+local_rank > 65535
        get_logger().warning(
            "metrics exporter could not bind port %d (%s); metrics "
            "disabled for this worker", port, e)
        return None
    # fleet fan-in tree node: child pushes ride this exporter plane,
    # rank 0 serves /metrics/fleet; rebuilt per init so a re-init
    # re-wires the tree from the NEW (rank, size)
    from horovod_tpu_torch.metrics.fleet import (FleetAggregator,
                                                 fleet_enabled)
    if fleet_enabled() and state.rank >= 0:
        import os as _os
        gen = 0
        try:
            gen = int(_os.environ.get("HVD_ELASTIC_GENERATION", "0"))
        except ValueError:
            pass
        exp.fleet = FleetAggregator(
            rank=state.rank, size=state.size, base_port=base,
            registry=registry, collectors=[collector.collect],
            generation=gen,
            cross_size=state.cross_size).start()
    get_logger().info("metrics exporter serving on :%d/metrics", exp.port)
    return exp
