"""Tree fan-in relay for the driver's control-plane KV.

ROADMAP item 5: the rank-0 HTTP KV is an O(world) single point — every
worker's world polls, world-doc pushes and notification registrations
land on one server, exactly the coordinator bottleneck 1802.05799's
design is criticized for and 1909.09756 shows must become hierarchical
at pod scale.  This module arranges the workers into the same
complete-``arity``-ary tree the fleet metrics plane uses (PR 7:
``parent(r) = (r-1) // arity``), and routes each worker's KV traffic to
its PARENT's relay node instead of the root:

* **world polls** (``GET world/current``) are served from the parent's
  cache — the parent refreshes from ITS upstream at most once per
  ``HVD_TPU_KV_RELAY_TTL_S`` regardless of how many children poll, so
  the root sees O(arity) poll sessions, not O(world × poll rate).  The
  driver's push channel is unchanged and makes most polls moot anyway;
  pushed docs land in the relay node's local KV and serve as fresh
  cache.  Staleness is bounded by the TTL and harmless beyond latency:
  world docs are HMAC-signed and generation-checked by every consumer.
* **registrations and drain notices** (``PUT notify/<r>``,
  ``PUT drain/<r>``) are forwarded hop by hop up the tree to the root,
  so the root's PUT sessions come only from its direct children.

The relay NODE is the worker's existing notification listener (its
``KVStoreServer`` upgraded to a :class:`RelayKVServer`); the relay
CLIENT resolves its parent's listener address from the root's
``notify/<parent>`` registration (one bootstrap lookup per generation)
and **falls back to the root** whenever the parent is dead, unresolved,
or mid-registration — a killed relay node costs latency, never a failed
step.  Per-node request counters (``KVStoreServer.request_counts`` /
``hvd_kv_server_requests_total``) make the fan-in provable rather than
asserted.

``HVD_TPU_KV_RELAY_ARITY`` (default 0) enables the relay; 0 keeps the
flat everyone-to-root topology.  Elastic re-meshes rebuild the route:
the client is keyed by (rank, generation, root), so a renumbered worker
re-resolves its new parent on first use.

A copy of ``horovod_tpu/runner/kv_relay.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple

from horovod_tpu_torch.common.safe_metrics import safe_inc as _metric
from horovod_tpu_torch.runner.http_kv import (KVStoreServer, _KVHandler,
                                        _KVServer, kv_get, kv_put)

#: scopes relayed upstream toward the root (worker -> driver traffic);
#: everything else is local to the node (e.g. the driver's world pushes).
#: "action" carries the autopilot's remediation requests (ISSUE 12):
#: finding→action decisions ride the same tree as drain notices.
#: "result" carries each worker's signed completion receipt (docs/
#: ELASTIC.md "Driver failover & takeover") — a takeover driver that
#: adopted running workers classifies their exits from these.
FORWARD_SCOPES = ("notify", "drain", "action", "result")

#: scopes a relay node serves from its TTL cache (driver -> worker
#: traffic).  GETs for any other scope go root-direct: the relay
#: handler has no relay semantics for them, and a parent-local 404
#: would otherwise masquerade as an authoritative miss.
CACHED_SCOPES = ("world",)


def parent_dead_s() -> float:
    """``HVD_TPU_KV_RELAY_DEAD_S``: how long a failed parent stays
    bypassed (root-direct) before it is retried."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.1, env_float("KV_RELAY_DEAD_S", 5.0))


def resolve_ttl_s() -> float:
    """``HVD_TPU_KV_RELAY_RESOLVE_TTL_S``: how long a failed parent
    LOOKUP is cached.  At generation start every worker registers at
    ~the same moment, so early lookups legitimately miss — the negative
    cache keeps that from turning into a lookup-per-request storm, and
    its expiry is when the tree actually forms."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.05, env_float("KV_RELAY_RESOLVE_TTL_S", 10.0))


def relay_arity() -> int:
    from horovod_tpu_torch.common.config import env_int
    return max(0, env_int("KV_RELAY_ARITY", 0))


def relay_ttl_s() -> float:
    from horovod_tpu_torch.common.config import env_float
    return max(0.05, env_float("KV_RELAY_TTL_S", 1.0))


def relay_parent(rank: int, arity: int) -> Optional[int]:
    """This rank's relay parent, or None for a direct root route (rank
    0, unknown rank, or relay disabled)."""
    if arity <= 0 or rank <= 0:
        return None
    return (rank - 1) // arity


class RelayClient:
    """Routes one worker's control-plane KV traffic: parent first, root
    as the always-correct fallback."""

    def __init__(self, rank: int, root_addr: str, root_port: int,
                 arity: Optional[int] = None) -> None:
        self.rank = rank
        self.root_addr = root_addr
        self.root_port = int(root_port)
        self.arity = relay_arity() if arity is None else arity
        self.parent_rank = relay_parent(rank, self.arity)
        self._lock = threading.Lock()
        self._parent_addr: Optional[Tuple[str, int]] = None
        self._parent_dead_until = 0.0
        self._resolve_failed_until = 0.0

    # -- parent resolution --------------------------------------------------
    def _resolve_parent(self, timeout: float) -> Optional[Tuple[str, int]]:
        """The parent's listener address from the root's ``notify``
        scope; one bootstrap lookup per generation, negative results
        cached briefly (the parent may simply not have registered yet)."""
        if self.parent_rank is None:
            return None
        with self._lock:
            if self._parent_addr is not None:
                return self._parent_addr
            if time.monotonic() < self._resolve_failed_until:
                return None
        try:
            raw = kv_get(self.root_addr, self.root_port, "notify",
                         str(self.parent_rank), timeout=timeout,
                         site="kv_relay.resolve", peer="driver")
            if raw:
                host, _, port = raw.decode().rpartition(":")
                addr = (host, int(port))
                with self._lock:
                    self._parent_addr = addr
                return addr
        except (OSError, ValueError, UnicodeDecodeError):
            pass
        with self._lock:
            self._resolve_failed_until = time.monotonic() + resolve_ttl_s()
        return None

    def _parent_usable(self, timeout: float) -> Optional[Tuple[str, int]]:
        with self._lock:
            if time.monotonic() < self._parent_dead_until:
                return None
        return self._resolve_parent(timeout)

    def _mark_parent_dead(self, site: str) -> None:
        with self._lock:
            self._parent_dead_until = time.monotonic() + parent_dead_s()
            self._parent_addr = None  # re-resolve: it may have moved
            self._resolve_failed_until = 0.0
        _metric("hvd_kv_relay_fallback_total",
                "relay-parent failures degraded to a direct root "
                "request, per call site", site=site)

    # -- the client surface -------------------------------------------------
    def get(self, scope: str, key: str, timeout: float = 30.0,
            site: str = "kv_relay.get",
            count_exhausted: bool = True) -> Optional[bytes]:
        addr = self._parent_usable(timeout) \
            if scope in CACHED_SCOPES else None
        if addr is not None:
            try:
                # attempts=1: the root fallback IS the retry — a dead
                # parent must cost one timeout, not a full retry cycle
                # longer than its own bypass window
                return kv_get(addr[0], addr[1], scope, key,
                              timeout=timeout, site=site,
                              peer=self.parent_rank, attempts=1)
            except OSError:
                self._mark_parent_dead(site)
        return kv_get(self.root_addr, self.root_port, scope, key,
                      timeout=timeout, site=site, peer="driver",
                      count_exhausted=count_exhausted)

    def put(self, scope: str, key: str, value: bytes,
            timeout: float = 30.0, site: str = "kv_relay.put",
            count_exhausted: bool = True) -> None:
        addr = self._parent_usable(timeout) \
            if scope in FORWARD_SCOPES else None
        if addr is not None:
            try:
                kv_put(addr[0], addr[1], scope, key, value,
                       timeout=timeout, site=site,
                       peer=self.parent_rank, attempts=1)
                return
            except OSError:
                self._mark_parent_dead(site)
        kv_put(self.root_addr, self.root_port, scope, key, value,
               timeout=timeout, site=site, peer="driver",
               count_exhausted=count_exhausted)


# -- relay node (server side) -------------------------------------------------
class _RelayHandler(_KVHandler):
    """The listener's KV handler with relay behavior: stale ``world``
    reads refresh from upstream (bounded by the TTL, so N polling
    children cost one upstream fetch per TTL), and PUTs to the forwarded
    scopes travel up the tree toward the root."""

    def do_GET(self):
        scope, key = self._split()
        srv = self.server
        if scope not in CACHED_SCOPES:
            # one source of truth with RelayClient.get's routing: a
            # scope the client would relay must have relay semantics
            # here, or a parent-local 404 would masquerade as an
            # authoritative miss
            return super().do_GET()
        srv.note_request("GET", scope)
        _metric("hvd_kv_relay_requests_total",
                "KV requests served by this relay node, per scope",
                scope=scope)
        def read_cache():
            with srv.kv_lock:
                return (srv.kv.get(scope, {}).get(key),
                        srv.fresh.get((scope, key), 0.0)
                        > time.monotonic() - relay_ttl_s())

        val, fresh = read_cache()
        if val is None or not fresh:
            # single-flight refresh: children poll in lockstep (commits
            # synchronize on the collective), so after a TTL expiry ALL
            # of them observe stale — without this gate each would fire
            # its own upstream fetch and the per-TTL fan-in bound would
            # quietly become per-child.  Waiters re-read what the
            # holder fetched.
            with srv.refresh_lock:
                val, fresh = read_cache()
                upstream = srv.upstream() \
                    if (val is None or not fresh) else None
                if upstream is not None:
                    try:
                        _metric("hvd_kv_relay_upstream_total",
                                "relay-node refreshes/forwards sent "
                                "upstream, per op", op="get")
                        got = upstream.get(scope, key, timeout=5.0,
                                           site="kv_relay.refresh")
                        if got is not None:
                            val = got
                        with srv.kv_lock:
                            if got is not None:
                                srv.kv.setdefault(scope, {})[key] = got
                            # a clean upstream 404 is also knowledge:
                            # don't re-ask for every child until the
                            # TTL passes
                            srv.fresh[(scope, key)] = time.monotonic()
                    except OSError:
                        # upstream dark: serve the stale copy if we have
                        # one (docs are generation-checked; stale =
                        # latency, not corruption), else tell the child
                        # to go to the root
                        if val is None:
                            self.send_response(503)
                            self.end_headers()
                            return
                        with srv.kv_lock:
                            # the failure also refreshes the stamp:
                            # a dark root costs ONE upstream attempt
                            # per TTL per node, not one per child
                            # (whose polls would otherwise pile up
                            # behind the refresh lock, time out, and
                            # hammer the dark root directly)
                            srv.fresh[(scope, key)] = time.monotonic()
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
        srv = self.server
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        srv.note_request("PUT", scope)
        if scope in FORWARD_SCOPES:
            _metric("hvd_kv_relay_requests_total",
                    "KV requests served by this relay node, per scope",
                    scope=scope)
            upstream = srv.upstream()
            if upstream is None:
                self.send_response(503)  # child falls back to the root
                self.end_headers()
                return
            # causal tracing: the publisher's context arrives as the
            # traceparent header; each relay hop re-stamps a CHILD span
            # and forwards under it, so the merged tree shows the doc's
            # path up the tree hop by hop
            from horovod_tpu_torch import tracing
            fwd_ctx = tracing.child(
                tracing.decode(self.headers.get(tracing.TRACEPARENT)),
                "kv")
            t0 = time.monotonic()
            try:
                _metric("hvd_kv_relay_upstream_total",
                        "relay-node refreshes/forwards sent upstream, "
                        "per op", op="put")
                with tracing.activate(fwd_ctx):
                    upstream.put(scope, key, body, timeout=5.0,
                                 site="kv_relay.forward")
            except OSError:
                self.send_response(503)
                self.end_headers()
                return
            finally:
                tracing.record_span("kv", "relay_forward", fwd_ctx,
                                    dur_s=time.monotonic() - t0,
                                    scope=scope, key=key)
            self.send_response(200)
            self.end_headers()
            return
        with srv.kv_lock:
            srv.kv.setdefault(scope, {})[key] = body
            # a direct PUT (the driver's world push) is fresh truth
            srv.fresh[(scope, key)] = time.monotonic()
        self.send_response(200)
        self.end_headers()


class RelayKVServer(KVStoreServer):
    """A notification listener that is also a relay node.

    ``upstream_fn`` returns the RelayClient routing THIS worker's own
    traffic (parent-or-root) — children's requests recurse up the same
    tree the client descends."""

    def __init__(self, upstream_fn, port: int = 0) -> None:
        self._upstream_fn = upstream_fn
        super().__init__(port=port)
        self._httpd.fresh = {}
        self._httpd.refresh_lock = threading.Lock()
        self._httpd.upstream = self._upstream

    def _make_server(self, port: int):
        return _KVServer(("0.0.0.0", port), _RelayHandler)

    def _upstream(self) -> Optional[RelayClient]:
        try:
            return self._upstream_fn()
        except Exception:
            return None


def elastic_kv_endpoint() -> Optional[Tuple[str, int]]:
    """The managing elastic driver's KV endpoint from
    ``HVD_ELASTIC_KV`` (``host:port``) — THE one parse of that env
    contract, shared by every worker→driver publisher (drain notices,
    autopilot action requests).  Returns None when no driver manages
    this job; raises :class:`ValueError` on a malformed value so the
    caller can say, in its own words, that this is a config bug and
    not a transient."""
    kv = os.environ.get("HVD_ELASTIC_KV", "")
    if not kv:
        return None
    addr, _, port = kv.rpartition(":")
    try:
        return addr, int(port)
    except ValueError:
        raise ValueError(f"malformed HVD_ELASTIC_KV {kv!r}") from None


# -- process-wide client ------------------------------------------------------
_client: Optional[RelayClient] = None
_client_key = None
_client_lock = threading.Lock()


def _identity() -> Tuple[int, str]:
    rank = os.environ.get("HOROVOD_RANK",
                          os.environ.get("HVD_TPU_RANK", "0"))
    gen = os.environ.get("HVD_ELASTIC_GENERATION", "0")
    try:
        return int(rank), gen
    except ValueError:
        return 0, gen


def client(root_addr: str, root_port: int) -> RelayClient:
    """The process's relay client for the given root, rebuilt whenever
    the worker's (rank, generation) or the root moves — an elastic
    re-mesh renumbers ranks, and the route must follow."""
    global _client, _client_key
    rank, gen = _identity()
    key = (rank, gen, root_addr, int(root_port), relay_arity())
    with _client_lock:
        if _client is None or _client_key != key:
            _client = RelayClient(rank, root_addr, int(root_port))
            _client_key = key
        return _client


def reset() -> None:
    """Drop the cached route (tests / full shutdown)."""
    global _client, _client_key
    with _client_lock:
        _client = None
        _client_key = None
