"""Push-based worker notification channel.

Reference: ``horovod/runner/elastic/worker.py:46+``
(``WorkerNotificationService``/``WorkerNotificationManager``: every worker
runs a tiny HTTP listener and the driver pushes host-update requests to
it). With minutes-long steps, the poll-at-commit design alone makes
growth-response latency equal to the commit interval; the push channel
delivers the driver's new world document the moment it is published, so
``state.commit()`` finds it locally (one in-process read, no driver
round-trip) and ``HostsUpdatedInterrupt`` fires at the very next commit.

Design: the worker listener IS a :class:`KVStoreServer` (the same HMAC'd
world-document bytes the driver publishes to its own KV are pushed into
the worker's local KV under ``world/current``), and workers register
their listener address in the driver KV under ``notify/<rank>``. The
driver pushes best-effort with short timeouts — the commit-time poll of
the driver KV remains as the fallback, so a lost push costs latency, not
correctness. Docs are HMAC-verified on the worker regardless of which
channel delivered them (the listener port is open to the network).

``HVD_ELASTIC_PUSH=0`` disables the listener (poll-only mode).

A copy of ``horovod_tpu/elastic/notification.py``.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional

from horovod_tpu_torch.common.logging import get_logger

_lock = threading.Lock()
_listener: Optional["WorkerNotificationListener"] = None
_disabled = False
_registered_as = None  # (rank, generation) the listener is known to hold


class WorkerNotificationListener:
    """Per-worker push endpoint + registration with the driver KV.

    With the KV relay enabled (``HVD_TPU_KV_RELAY_ARITY`` > 0,
    docs/ELASTIC.md "Relayed control-plane KV") the listener doubles as
    this worker's RELAY NODE: children's world polls are served from its
    cache and their registrations forwarded up the tree, so the driver's
    root KV handles O(arity) sessions instead of O(world)."""

    def __init__(self, driver_addr: Optional[str] = None,
                 driver_port: Optional[int] = None) -> None:
        from horovod_tpu_torch.runner import kv_relay
        self._driver = (driver_addr, driver_port)
        if kv_relay.relay_arity() > 0 and driver_addr is not None:
            self._kv = kv_relay.RelayKVServer(self._upstream)
        else:
            from horovod_tpu_torch.runner.http_kv import KVStoreServer
            self._kv = KVStoreServer()
        self._kv.start()

    def _upstream(self):
        from horovod_tpu_torch.runner import kv_relay
        addr, port = self._driver
        if addr is None:
            return None
        return kv_relay.client(addr, int(port))

    @property
    def port(self) -> int:
        return self._kv.port

    @property
    def kv(self):
        """The underlying KV server (relay diagnostics / tests)."""
        return self._kv

    def pending_raw(self) -> Optional[bytes]:
        """The most recently pushed world document (unvalidated bytes)."""
        return self._kv.get("world", "current")

    def register(self, driver_addr: str, driver_port: int) -> None:
        """Record ``notify/<rank> -> host:port`` in the driver KV so the
        driver knows where to push (host = this worker's slot hostname,
        which the driver can route to by construction).  Routed through
        the KV relay when enabled — the registration travels up the tree
        to the root, falling back to a direct root PUT."""
        from horovod_tpu_torch.runner import kv_relay
        my_host = os.environ.get("HOROVOD_HOSTNAME") or socket.getfqdn()
        rank = os.environ.get("HOROVOD_RANK",
                              os.environ.get("HVD_TPU_RANK", "0"))
        # site label: registration failures show up on /metrics as their
        # own retry series, not blended into generic KV traffic — a
        # worker whose registrations keep exhausting is a worker the
        # driver will deem unrecoverable (docs/ELASTIC.md)
        kv_relay.client(driver_addr, driver_port).put(
            "notify", rank, f"{my_host}:{self.port}".encode(),
            timeout=5.0, site="elastic.notify.register")

    def stop(self) -> None:
        self._kv.stop()


def ensure_listener(driver_addr: str, driver_port: int) -> \
        Optional[WorkerNotificationListener]:
    """Start + register the singleton listener on first use; returns None
    when push is disabled or registration failed (poll-only fallback)."""
    global _listener, _disabled, _registered_as
    with _lock:
        if _disabled or os.environ.get("HVD_ELASTIC_PUSH", "1") == "0":
            return None
        if _listener is not None:
            # rank/generation changed (in-place recovery renumbered us and
            # the driver cleared its registrations): re-register the SAME
            # listener under the new identity so pushes — and the driver's
            # recovery-viability check — keep seeing this worker
            ident = _identity()
            if ident != _registered_as:
                try:
                    _listener.register(driver_addr, driver_port)
                    _registered_as = ident
                except OSError:
                    pass  # poll-at-commit still works
            return _listener
        try:
            listener = WorkerNotificationListener(driver_addr, driver_port)
            listener.register(driver_addr, driver_port)
        except OSError as e:
            # an unreachable driver KV or unbindable port must never break
            # training: fall back to poll-at-commit for the process's life
            get_logger().warning(
                "worker notification listener disabled (%s); falling back "
                "to poll-at-commit", e)
            _disabled = True
            try:
                listener.stop()
            except Exception:
                pass
            return None
        _listener = listener
        _registered_as = _identity()
        return _listener


def _identity():
    return (os.environ.get("HOROVOD_RANK",
                           os.environ.get("HVD_TPU_RANK", "0")),
            os.environ.get("HVD_ELASTIC_GENERATION", "0"))


def mark_stale() -> None:
    """Forget the registered identity WITHOUT tearing the listener down:
    the next ``ensure_listener`` re-registers the same endpoint.  Called
    when a driver takeover is detected (``elastic.outage``) — the fresh
    driver's KV starts with an empty ``notify`` scope, so the old
    registration exists only in a dead process's memory and pushes would
    silently stop until the worker re-announced itself."""
    global _registered_as
    with _lock:
        _registered_as = None


def current_listener() -> Optional[WorkerNotificationListener]:
    """The already-started listener, or None — never creates one (the
    cheap mid-step probe must not pay bind/registration latency)."""
    with _lock:
        return _listener


def reset_listener() -> None:
    """Tear down the singleton (tests / full shutdown)."""
    global _listener, _disabled, _registered_as
    with _lock:
        if _listener is not None:
            _listener.stop()
        _listener = None
        _disabled = False
        _registered_as = None
    from horovod_tpu_torch.runner import kv_relay
    kv_relay.reset()
