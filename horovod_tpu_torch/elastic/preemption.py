"""Proactive preemption drain: act on advance notice instead of timeout.

The reactive elastic path needs a host to DIE before anything happens —
survivors block in a collective until the transport deadline trips,
``HorovodInternalError`` fires, and the driver publishes a recovery
world (the ``failure_detect`` phase of the re-mesh timeline is bound by
the transport timeout).  But cloud hosts *announce* maintenance and
preemption in advance (the GCE ``maintenance-event`` metadata surface,
the same on a GPU VM as on a TPU VM),
SIGTERM-with-grace is the standard cloud eviction contract, and the
chaos harness can inject the same notice deterministically.  This
module turns those signals into a **planned** drain:

1. the :class:`PreemptionWatcher` (one daemon thread per worker, armed
   by ``hvd.init`` whenever an elastic driver manages the job) learns
   the host is doomed from one of three sources —
   ``runner/gpu_discovery.py`` metadata polling, an opt-in SIGTERM hook
   (``HVD_TPU_PREEMPTION_SIGTERM=1`` — off by default because the
   driver's own teardown speaks SIGTERM), or the chaos ``preemption``
   seam (docs/CHAOS.md);
2. it publishes a **drain notice** (``drain/<rank>``) through the
   driver KV (relay-routed, root fallback);
3. the driver plans a re-mesh around the doomed workers: survivors get
   a world doc stamped ``drain`` at their next commit (pushed — the
   ``failure_detect`` phase collapses to ~0), the doomed worker exits
   via the not-in-new-world path after its state was committed, and its
   slot is reserved for ``HVD_TPU_DRAIN_COOLDOWN_S`` before the host is
   re-admitted.  Drained workers are recorded ``DRAINED`` — never
   ``FAILURE``, never charged to ``host_crashes``, never blocklisted.

Every notice lands in the flight recorder (``preemption_notice``) and
on ``/metrics`` (``hvd_drain_notices_total{source=}``).  See
docs/ELASTIC.md "Proactive drain & preemption".

A copy of ``horovod_tpu/elastic/preemption.py``; the metadata source reads
:mod:`horovod_tpu_torch.runner.gpu_discovery`, and only where a metadata
server is named (:func:`metadata_enabled`).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Optional

from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.common.safe_metrics import safe_inc as _metric

DEFAULT_POLL_S = 5.0

_lock = threading.Lock()
_watcher: Optional["PreemptionWatcher"] = None
_sigterm_installed = False
_prev_sigterm = None


def watch_enabled() -> bool:
    from horovod_tpu_torch.common.config import env_bool
    return env_bool("PREEMPTION_WATCH", True)


def metadata_enabled() -> bool:
    """Does the watcher poll a metadata server's maintenance notice? Where
    ``HVD_TPU_METADATA_ENDPOINT`` names one (``http://metadata.google.
    internal`` on a GCE VM). The JAX watcher polls GCE's by default (a TPU
    VM always has the server); a GPU host often is no GCE VM, and a probe
    of ``metadata.google.internal`` from one would send a DNS query to its
    resolver every poll until the latch."""
    return bool(os.environ.get("HVD_TPU_METADATA_ENDPOINT"))


def poll_interval_s() -> float:
    from horovod_tpu_torch.common.config import env_float
    return max(0.05, env_float("PREEMPTION_POLL_S", DEFAULT_POLL_S))


def _identity():
    rank = os.environ.get("HOROVOD_RANK",
                          os.environ.get("HVD_TPU_RANK", "0"))
    host = os.environ.get("HOROVOD_HOSTNAME",
                          os.environ.get("HVD_TPU_HOSTNAME", "")) \
        or os.uname().nodename
    return rank, host


class PreemptionWatcher:
    """Polls the preemption signal sources and publishes ONE drain
    notice per doomed life (the flag survives re-meshes: a draining
    process stays draining until it exits)."""

    def __init__(self, poll_s: Optional[float] = None) -> None:
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flag_lock = threading.Lock()
        self._notified = False
        # a notice whose KV publish failed transiently: retried on later
        # polls (the signal source itself may be one-shot — a chaos
        # marker rule, a SIGTERM — so the SOURCE is remembered here)
        self._retry_source: Optional[str] = None
        # metadata polling latches off after this many consecutive
        # failures — but ONLY when it has never once succeeded: off a
        # cloud VM there is no metadata server and each probe costs a
        # connect timeout.  On a real VM (a probe has succeeded) a blip
        # must not permanently disable the primary production
        # preemption signal, so failures there just keep polling.
        self._metadata_failures = 0
        self._metadata_dead = False
        self._metadata_ok_once = False

    # -- signal sources -----------------------------------------------------
    def _chaos_notice(self) -> bool:
        try:
            from horovod_tpu_torch import chaos
            applied = chaos.fire("preemption")
            return any(kind == "notice" for _seam, kind in applied)
        except Exception:
            return False

    def _metadata_notice(self) -> bool:
        if self._metadata_dead or not metadata_enabled():
            return False
        from horovod_tpu_torch.runner import gpu_discovery
        try:
            event = gpu_discovery.maintenance_event()
            self._metadata_failures = 0
            self._metadata_ok_once = True
            return event.strip().upper() not in (
                "", gpu_discovery.MAINTENANCE_NONE)
        except OSError:
            self._metadata_failures += 1
            if self._metadata_failures >= 3 and not self._metadata_ok_once:
                self._metadata_dead = True  # not on a cloud VM: stop paying
            return False

    def check_once(self) -> Optional[str]:
        """One poll round; returns the source of a NEW notice or None."""
        if self._notified:
            return None
        if self._retry_source:
            # an earlier publish failed transiently (e.g. the driver KV
            # restarting); keep retrying — the advance notice is only
            # worth something if it actually lands
            return self._retry_source
        if self._chaos_notice():
            return "chaos"
        if self._metadata_notice():
            return "metadata"
        return None

    # -- the notice ---------------------------------------------------------
    def notify(self, source: str) -> bool:
        """Publish the drain notice (idempotent per process life)."""
        with self._flag_lock:
            if self._notified:
                return False
            self._notified = True
        rank, host = _identity()
        get_logger().warning(
            "preemption notice (%s): publishing drain for rank %s on %s",
            source, rank, host)
        from horovod_tpu_torch.runner import kv_relay
        try:
            endpoint = kv_relay.elastic_kv_endpoint()
        except ValueError as e:
            # a config bug, not a transient: retrying cannot help, and
            # this must not die as a debug-level line in the poll loop
            get_logger().warning(
                "drain notice has nowhere to go: %s — this process "
                "will be lost reactively", e)
            return False
        if endpoint is None:
            get_logger().warning(
                "drain notice has nowhere to go: no elastic driver KV "
                "(HVD_ELASTIC_KV) — this process will be lost reactively")
            return False
        addr, port_i = endpoint
        # causal tracing: the notice ROOTS a trace the driver handling,
        # the drain-stamped world, and every survivor's re-mesh episode
        # continue — "what caused this re-mesh" is one trace query
        from horovod_tpu_torch import tracing
        nctx = tracing.new_trace("elastic")
        doc = {
            "rank": int(rank), "host": host, "source": source,
            # metadata maintenance dooms the whole HOST; a chaos or
            # SIGTERM notice targets this worker process
            "scope": "host" if source == "metadata" else "worker",
            "generation": int(os.environ.get("HVD_ELASTIC_GENERATION",
                                             "0")),
            "at": time.time()}
        if nctx is not None:
            doc[tracing.TRACEPARENT] = nctx.traceparent
        notice = json.dumps(doc).encode()
        try:
            from horovod_tpu_torch.runner import kv_relay
            with tracing.activate(nctx):
                kv_relay.client(addr, port_i).put(
                    "drain", rank, notice, timeout=5.0,
                    site="elastic.drain_notice")
            self._retry_source = None
            # evidence is stamped only for a notice that actually
            # LANDED: the transient-failure path re-runs notify() every
            # poll, and counting each attempt would both inflate
            # hvd_drain_notices_total and churn useful history out of
            # the bounded flight ring
            try:
                from horovod_tpu_torch.diagnostics.flight_recorder import \
                    record_event
                record_event("preemption_notice", source=source,
                             rank=rank, host=host,
                             **tracing.fields(nctx))
            except Exception:
                pass
            _metric("hvd_drain_notices_total",
                    "preemption/maintenance drain notices published, "
                    "per signal source", source=source)
            return True
        except OSError as e:
            # transient (the driver KV restarting, an injected blackout
            # window): un-latch so a later poll retries the PUBLISH —
            # the signal source may be one-shot, so it must not be
            # re-consulted, only the delivery re-attempted
            get_logger().warning(
                "drain notice publish failed (will retry): %s", e)
            with self._flag_lock:
                self._notified = False
                self._retry_source = source
            return False

    @property
    def draining(self) -> bool:
        return self._notified

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-preemption", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                source = self.check_once()
                if source is not None:
                    self.notify(source)
            except Exception:  # the watcher must never kill training
                get_logger().debug("preemption poll failed", exc_info=True)
            self._stop.wait(self._poll_s
                            if self._poll_s is not None
                            else poll_interval_s())

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def _on_sigterm(signum, frame) -> None:
    # The handler runs on the main thread between bytecodes — possibly
    # while that thread holds the metrics-registry or flight-recorder
    # lock inside a training step.  notify() acquires both, so running
    # it inline could deadlock the process on its own lock; publish
    # from a fresh thread instead (the handler itself only spawns).
    w = _watcher
    if w is not None:
        threading.Thread(target=w.notify, args=("sigterm",),
                         name="hvd-tpu-sigterm-drain",
                         daemon=True).start()
    if callable(_prev_sigterm):
        _prev_sigterm(signum, frame)


def _maybe_install_sigterm() -> None:
    """Opt-in (``HVD_TPU_PREEMPTION_SIGTERM=1``): SIGTERM publishes a
    drain notice and CONTINUES running until the planned re-mesh drops
    this worker.  Off by default — the elastic driver's own teardown
    delivers SIGTERM to the process group, and swallowing that would
    turn every generation restart into a hang-until-SIGKILL."""
    global _sigterm_installed, _prev_sigterm
    from horovod_tpu_torch.common.config import env_bool
    if _sigterm_installed or not env_bool("PREEMPTION_SIGTERM", False):
        return
    if threading.current_thread() is not threading.main_thread():
        return  # signal.signal is main-thread-only
    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        _sigterm_installed = True
    except (ValueError, OSError):
        pass


def ensure_watcher() -> Optional[PreemptionWatcher]:
    """Arm the singleton watcher (idempotent; called from ``hvd.init``).
    Only armed when an elastic driver manages this job — without a
    driver KV a drain notice has no consumer."""
    global _watcher
    if not watch_enabled() or not os.environ.get("HVD_ELASTIC_KV"):
        return None
    with _lock:
        if _watcher is None:
            _watcher = PreemptionWatcher()
            _watcher.start()
    _maybe_install_sigterm()
    return _watcher


def current_watcher() -> Optional[PreemptionWatcher]:
    return _watcher


def draining() -> bool:
    """Has this process published (or tried to publish) a drain notice?"""
    w = _watcher
    return w is not None and w.draining


def reset() -> None:
    """Tests: stop and drop the singleton and the SIGTERM hook."""
    global _watcher, _sigterm_installed, _prev_sigterm
    with _lock:
        w, _watcher = _watcher, None
    if w is not None:
        w.stop()
    if _sigterm_installed:
        try:
            signal.signal(signal.SIGTERM,
                          _prev_sigterm or signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        _sigterm_installed = False
        _prev_sigterm = None
