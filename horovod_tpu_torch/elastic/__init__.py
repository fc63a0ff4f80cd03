"""Worker-side elastic training API.

Mirrors ``horovod_tpu/elastic/__init__.py`` (reference:
``horovod/common/elastic.py``: ``State``/``ObjectState``
commit/restore/sync :26-148, the ``run_fn`` retry loop :151-175): the
signed world documents, both delivery channels (the driver's push to a
per-worker listener, the poll at commit), ``run`` with its re-mesh
episodes, and ``_publish_result``'s signed completion receipt.

In-place re-mesh in the port: a survivor adopts the new world's slot
environment and rendezvous port, ends its process group
(``shutdown(force=...)``: forced when the world shrank, since a dead peer
cannot agree), re-reads the configuration and calls ``init()`` again. The
process keeps its PID and its tensors stay where they are (on the card
under a driver of cards): nothing is reloaded from disk. A collective that
fails because a peer died reaches ``run`` as :class:`HorovodInternalError`
(translated once, in :mod:`horovod_tpu_torch.ops.mesh_collectives`).

``ObjectState`` persists in two tiers as in the JAX package: rank 0's
pickle under the driver's ``HVD_ELASTIC_CKPT``, and, with durable commits
on, the port's ``ShardedCheckpointer`` (the JAX on-disk format, so a
durable commit of either package restores in the other).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch.common.basics import is_initialized
from horovod_tpu_torch.common.basics import rank as _hvd_rank
from horovod_tpu_torch.common.basics import size as _hvd_size


def rank() -> int:
    """Worker rank — from hvd if initialized, else the launcher env (elastic
    states are usable with the raw core backend too)."""
    if is_initialized():
        return _hvd_rank()
    return int(os.environ.get("HOROVOD_RANK", os.environ.get("HVD_TPU_RANK",
                                                             "0")))


def size() -> int:
    if is_initialized():
        return _hvd_size()
    return int(os.environ.get("HOROVOD_SIZE", os.environ.get("HVD_TPU_SIZE",
                                                             "1")))


class HorovodInternalError(RuntimeError):
    """A collective failed mid-step (reference: ``HorovodInternalError``)."""


class HostsUpdatedInterrupt(RuntimeError):
    """Membership changed; re-sync required (reference:
    ``HostsUpdatedInterrupt``). Carries the driver's new world document
    when growth-resync is active."""

    def __init__(self, update: Optional[dict] = None) -> None:
        super().__init__("hosts updated")
        self.update = update


_current_generation: Optional[int] = None


def world_doc_signature(secret: bytes, doc: dict) -> str:
    """HMAC over the canonical world doc — workers apply env/coordinator
    changes from this document, so it must not be forgeable by anyone who
    can reach the driver's KV port."""
    import hashlib
    import hmac
    import json
    body = json.dumps({k: v for k, v in doc.items() if k != "sig"},
                      sort_keys=True).encode()
    return hmac.new(secret, body, hashlib.sha256).hexdigest()


def _validate_doc(raw: Optional[bytes]) -> Optional[dict]:
    """Parse + HMAC-verify a world doc and keep it only when its
    generation is newer than ours — shared by both delivery channels
    (a pushed doc is no more trusted than a polled one: the listener
    port is open to the network)."""
    if raw is None:
        return None
    import hmac as _hmac
    import json
    try:
        doc = json.loads(raw)
        if not isinstance(doc, dict):
            return None
        secret_hex = os.environ.get("HVD_ELASTIC_SECRET", "")
        if secret_hex:
            expect = world_doc_signature(bytes.fromhex(secret_hex), doc)
            sig = doc.get("sig", "")
            if not isinstance(sig, str) or \
                    not _hmac.compare_digest(sig, expect):
                return None  # forged/corrupt doc: ignore
        if int(doc.get("generation", 0)) > _current_generation:
            return doc
    except (ValueError, TypeError, AttributeError):
        # anyone can PUT bytes at the listener port: malformed docs must
        # never escalate past "ignored" (a crash here kills training)
        return None
    return None


def _world_update(poll: bool = True) -> Optional[dict]:
    """A newer world document, if the driver published one. Checked in
    channel order: (1) the push channel — the driver POSTs the doc to a
    per-worker listener the moment it publishes (reference:
    ``runner/elastic/worker.py:46+`` WorkerNotificationService), so this
    is one in-process read; (2) with ``poll=True``, a poll of the driver
    KV as fallback for lost pushes (the original pull-at-commit design).
    """
    global _current_generation
    kv = os.environ.get("HVD_ELASTIC_KV", "")
    if not kv:
        return None
    if _current_generation is None:
        _current_generation = int(
            os.environ.get("HVD_ELASTIC_GENERATION", "0"))
    addr, _, port = kv.rpartition(":")

    # listener setup (bind + driver registration, up to one 5s kv_put) only
    # happens on the COMMIT path; the mid-step probe (poll=False) must stay
    # an in-process read and just sees "nothing yet" before first commit
    from horovod_tpu_torch.elastic.notification import (current_listener,
                                                  ensure_listener)
    listener = current_listener() if not poll else \
        ensure_listener(addr, int(port))
    if listener is not None:
        doc = _validate_doc(listener.pending_raw())
        if doc is not None:
            return doc
    if not poll:
        return None
    from horovod_tpu_torch.elastic import outage
    try:
        from horovod_tpu_torch.runner import kv_relay
        # short timeout: commit() must stay cheap even if the driver's
        # port silently drops packets.  Routed through the KV relay tree
        # when enabled (HVD_TPU_KV_RELAY_ARITY): the poll hits an
        # O(arity) parent's cache instead of the root, and degrades to a
        # direct root read when the parent is dead (docs/ELASTIC.md
        # "Relayed control-plane KV").  During a driver outage the polls
        # relabel to their own retry site and stop raising exhausted
        # alarms: a takeover window is a declared condition, not a fault
        # (docs/ELASTIC.md "Driver failover & takeover").
        raw = kv_relay.client(addr, int(port)).get(
            "world", "current", timeout=3.0,
            site="elastic.driver_outage" if outage.active()
            else "elastic.world_poll",
            count_exhausted=not outage.enabled())
    except OSError:
        # driver KV unreachable: open (or age) the outage window and
        # keep training on the cached world — ride-through, not escalate
        outage.note_failure()
        return None
    outage.note_success()
    return _validate_doc(raw)


def _publish_result() -> None:
    """Publish this worker's signed completion receipt
    (``result/<rank>``) to the driver KV.  A takeover driver that
    ADOPTED an already-running worker (docs/ELASTIC.md "Driver failover
    & takeover") never sees that worker's exit code — its original
    parent died with the old driver's process tree — so success is
    classified from this receipt instead.  HMAC-signed with the world
    secret: the receipt decides a SUCCESS classification and must not be
    forgeable by anyone who can reach the KV port.  Best-effort: a
    worker finishing while no driver is reachable just exits (the
    takeover driver's backstop classifies it conservatively)."""
    kv = os.environ.get("HVD_ELASTIC_KV", "")
    if not kv:
        return
    try:
        import json
        addr, _, port = kv.rpartition(":")
        doc = {"rank": rank(),
               "generation": int(
                   os.environ.get("HVD_ELASTIC_GENERATION", "0")),
               "ok": True}
        secret_hex = os.environ.get("HVD_ELASTIC_SECRET", "")
        if secret_hex:
            doc["sig"] = world_doc_signature(
                bytes.fromhex(secret_hex), doc)
        from horovod_tpu_torch.runner import kv_relay
        kv_relay.client(addr, int(port)).put(
            "result", str(doc["rank"]), json.dumps(doc).encode(),
            timeout=5.0, site="elastic.result")
    except (OSError, ValueError):
        pass


def has_pending_update() -> bool:
    """True when a newer world document has already ARRIVED at this worker
    (pushed by the driver) — without any driver round-trip. A long-running
    step can check this cheaply mid-step to decide to commit early."""
    return _world_update(poll=False) is not None


def _apply_world_update(update: dict, force_shutdown: bool = False) -> None:
    """Re-initialize into the new world IN PLACE (no process restart):
    survivors look up their slot by their CURRENT rank (growth keeps
    ranks stable; shrink docs are keyed by survivors' old ranks and may
    assign a smaller new rank), adopt the new size/topology env, tear the
    old core down and rendezvous into the new world.
    ``force_shutdown=True`` skips the shutdown-consensus grace — used on
    the shrink path, where a DEAD peer makes consensus impossible (growth
    keeps the negotiated drain: every survivor reaches its next commit).
    Reference analog: ``reset()`` after HostsUpdatedInterrupt,
    ``common/elastic.py:151-175``."""
    global _current_generation
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.diagnostics.flight_recorder import record_event
    from horovod_tpu_torch.elastic import remesh
    my_rank = str(rank())
    old_size = size()
    record_event("elastic_remesh", generation=update.get("generation"),
                 old_size=old_size, new_size=update.get("size"))
    slot_env = update["slots"].get(my_rank)
    if slot_env is None:  # we are not part of the new world
        hvd.shutdown(force=True)  # close our sockets for the survivors
        raise RuntimeError(
            f"rank {my_rank} is not in the new world (generation "
            f"{update['generation']}); exiting")
    # a SHRUNKEN world means departed peers: shutdown consensus cannot
    # complete, so skip its grace instead of stalling every survivor
    with remesh.phase("drain"):
        hvd.shutdown(force=force_shutdown
                     or int(update.get("size", 0)) < old_size)
    os.environ.update({k: str(v) for k, v in slot_env.items()})
    # the new world's rendezvous under every name init() reads (the
    # HVD_TPU_RENDEZVOUS_* pair wins over the launcher's gloo names)
    for addr_key, port_key in (
            ("HVD_TPU_COORD_ADDR", "HVD_TPU_COORD_PORT"),
            ("HVD_TPU_RENDEZVOUS_ADDR", "HVD_TPU_RENDEZVOUS_PORT"),
            ("HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_GLOO_RENDEZVOUS_PORT")):
        os.environ[addr_key] = update["coord_addr"]
        os.environ[port_key] = str(update["coord_port"])
    os.environ["HVD_ELASTIC_GENERATION"] = str(update["generation"])
    _current_generation = int(update["generation"])
    from horovod_tpu_torch.common.config import reset_config
    reset_config()
    # hvd.init() itself splits into the "rendezvous" (the process
    # group's creation) and "rebuild" (timeline / watchdog / exporter)
    # phases of the re-mesh timeline — see common/basics.py
    hvd.init()


class _NoWorldUpdateYet(Exception):
    """Internal: the driver has not published a newer world document
    (the retryable condition in :func:`_await_world_update`)."""


def _await_world_update(timeout_s: Optional[float] = None) -> Optional[dict]:
    """Poll the driver for a newer world document for up to ``timeout_s``
    (default ``HVD_ELASTIC_SHRINK_WAIT_S`` or 15s). Used after a
    HorovodInternalError: if a peer died, the driver notices its process
    exit and publishes the shrunken world within moments — the survivors
    wait here for it instead of dying for a generation restart.

    The wait rides :func:`horovod_tpu_torch.common.retry.retry_call` (jittered
    exponential backoff under the window as a deadline budget): a whole
    pod's survivors re-polling in lockstep after a shared failure is
    exactly the thundering herd the jitter de-correlates, and the
    attempts land on ``hvd_retry_*_total{site="elastic.await_world"}``
    — exhaustion there means "no recovery world inside the window"
    (the same-world retry follows), not an outage."""
    if not os.environ.get("HVD_ELASTIC_KV"):
        # no driver manages this job: a recovery world can never arrive,
        # and waiting out the full window would stall EVERY
        # HorovodInternalError retry by 15s for nothing
        return None
    if timeout_s is None:
        timeout_s = float(os.environ.get("HVD_ELASTIC_SHRINK_WAIT_S", "15"))

    from horovod_tpu_torch.common.retry import retry_call

    def poll():
        update = _world_update(poll=True)
        if update is None:
            raise _NoWorldUpdateYet()
        return update

    try:
        return retry_call(
            poll, site="elastic.await_world",
            retry_on=(_NoWorldUpdateYet,),
            attempts=1_000_000,  # the deadline is the real bound
            base_delay_s=0.25, backoff=1.5, max_delay_s=2.0, jitter=0.25,
            deadline_s=timeout_s)
    except _NoWorldUpdateYet:
        return None


class State:
    """Commit/restore/sync contract (reference: ``common/elastic.py:26-96``)."""

    def __init__(self) -> None:
        self._reset_callbacks = []

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    def commit(self) -> None:
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        from horovod_tpu_torch.elastic import remesh
        record_event("elastic_commit")
        self.save()
        # a committed unit of work after a recovery closes the re-mesh
        # timeline's first_step phase (loops without a StepTimer —
        # the raw elastic loop — still get a measured episode)
        remesh.note_step_end()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        """Raise :class:`HostsUpdatedInterrupt` when the driver published
        a newer world (elastic growth without restarting survivors);
        failures/shrink still arrive as process restarts.

        Every rank of the world raises at the same commit, with the
        newest document any of them holds (reference: the broadcast in
        ``common/elastic.py`` ``check_host_updates``; its TODO's max over
        the ranks). The JAX package checks each rank alone: a rank that
        sees the document first leaves for the new world while a peer
        that has not seen it yet enters its next step's collective,
        fails it, and reaches the same world through a recovery."""
        update = _world_update()
        import horovod_tpu_torch as hvd
        if hvd.is_initialized() and hvd.size() > 1:
            from horovod_tpu_torch.train.optimizer import allgather_object
            docs = [d for d in allgather_object(update) if d is not None]
            update = max(docs, key=lambda d: int(d["generation"])) \
                if docs else None
        if update is not None:
            raise HostsUpdatedInterrupt(update)

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


def _ckpt_path(name: str) -> Optional[str]:
    """Generation-restart persistence path — ONLY when the elastic driver
    manages this job (it exports a per-job ``HVD_ELASTIC_CKPT``,
    ``runner/elastic/driver.py``). Without a driver there is no restart
    mechanism to resume from, and persisting to a shared tempdir would let
    a later unrelated job silently adopt stale state — so standalone
    ObjectStates stay host-memory-only, like the reference's."""
    base = os.environ.get("HVD_ELASTIC_CKPT")
    if not base:
        return None
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"hvd_state_{name}.pkl")


def _durable_base() -> str:
    """Directory for DURABLE (sharded, shared-filesystem) commits:
    ``CHECKPOINT_DIR`` knob first, the driver's ``HVD_ELASTIC_CKPT``
    otherwise."""
    from horovod_tpu_torch.common.config import env_str
    return env_str("CHECKPOINT_DIR") or os.environ.get(
        "HVD_ELASTIC_CKPT") or ""


class ObjectState(State):
    """Arbitrary-attribute state with pickle persistence + rank-0 broadcast
    sync (reference: ``ObjectState``, ``common/elastic.py:99-148``).

    Persistence is two-tier: the per-host pickle is the fast local path
    (rank 0 only — it dies with the host that wrote it), and when
    durable commits are on (``durable=True`` or the
    ``HVD_TPU_ELASTIC_DURABLE`` knob) every commit ALSO lands in the
    native sharded store (:mod:`horovod_tpu_torch.checkpoint`) under the
    shared checkpoint directory — each rank writes its shard, so the
    state survives the loss of any host and restores at a different
    world size (docs/ELASTIC.md "Durable commits")."""

    def __init__(self, name: str = "default",
                 durable: Optional[bool] = None, **kwargs: Any) -> None:
        super().__init__()
        self._name = name
        self._saved: Dict[str, Any] = {}
        self._durable_opt = durable
        self._durable_store = None
        self._durable_key = None
        self._durable_step: Optional[int] = None
        self._warned_no_durable_dir = False
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._attrs = list(kwargs)
        if not self._maybe_load():
            self._snapshot()

    def _durable(self):
        """The sharded store for durable commits, rebuilt whenever the
        world (rank/size) changes under us — an elastic re-mesh means a
        new shard partition.  ``None`` when durable commits are off."""
        from horovod_tpu_torch.common.config import env_bool
        enabled = env_bool("ELASTIC_DURABLE", False) \
            if self._durable_opt is None else self._durable_opt
        if not enabled:
            return None
        base = _durable_base()
        if not base:
            if self._durable_opt:
                raise RuntimeError(
                    "durable elastic commits need a checkpoint directory: "
                    "set CHECKPOINT_DIR / HVD_TPU_CHECKPOINT_DIR (or run "
                    "under the elastic driver, which exports "
                    "HVD_ELASTIC_CKPT)")
            if not self._warned_no_durable_dir:
                # the env knob promised durability — failing silent would
                # be discovered only at the next host loss
                self._warned_no_durable_dir = True
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning(
                    "ELASTIC_DURABLE is set but no checkpoint directory "
                    "is configured (CHECKPOINT_DIR / HVD_ELASTIC_CKPT): "
                    "commits of state %r are NOT durable", self._name)
            return None
        key = (base, rank(), size())
        if self._durable_store is not None and self._durable_key != key:
            try:
                # wait=False: a world change usually means a peer DIED —
                # the old store's in-flight commit may be waiting out the
                # full commit timeout on that peer's marker, and recovery
                # must not stall behind it (the abandoned tmp dir is
                # nonce-protected and GC'd later)
                self._durable_store.close(wait=False)
            except Exception:
                pass
            self._durable_store = None
        if self._durable_store is None:
            from horovod_tpu_torch.checkpoint import ShardedCheckpointer
            self._durable_store = ShardedCheckpointer(
                os.path.join(base, f"hvd_state_{self._name}.sharded"),
                rank=key[1], world_size=key[2])
            self._durable_key = key
            self._durable_step = None
        return self._durable_store

    def _public(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._attrs}

    def _snapshot(self) -> None:
        self._saved = {k: _copy_leaf(v) for k, v in self._public().items()}

    def _maybe_load(self) -> bool:
        data = None
        path = _ckpt_path(self._name)
        if path is not None and os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    data = pickle.load(f)
            except Exception:
                data = None
        if data is None:
            # pickle gone or torn (e.g. the host that wrote it is the
            # one that died): fall back to the durable sharded store
            store = self._durable()
            if store is not None:
                try:
                    data = store.restore_latest()
                    self._durable_step = store.latest_step()
                except Exception:
                    data = None
        if not isinstance(data, dict):
            return False
        for k, v in data.items():
            setattr(self, k, v)
            if k not in self._attrs:
                self._attrs.append(k)
        self._snapshot()
        return True

    def save(self) -> None:
        self._snapshot()
        path = _ckpt_path(self._name)
        if rank() == 0 and path is not None:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(self._saved, f)
            os.replace(tmp, path)
        store = self._durable()
        if store is not None:
            try:
                # drain a pending async failure NOW, attributed to the
                # save that caused it — submit() would re-raise it under
                # THIS commit's step number and silently drop this one
                store.check_error()
            except Exception:
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning(
                    "an earlier durable commit of state %r failed in the "
                    "background", self._name, exc_info=True)
                try:
                    self._durable_step = max(self._durable_step or 0,
                                             store.latest_step() or 0)
                except Exception:
                    pass
            if self._durable_step is None:
                self._durable_step = store.latest_step() or 0
            self._durable_step += 1
            try:
                # async sharded commit: every rank writes its shard; the
                # train loop doesn't block on disk
                store.save(self._durable_step, self._saved)
            except Exception:
                # pickle (or host memory) still holds the commit; a
                # flaky shared filesystem must not kill training
                from horovod_tpu_torch.common.logging import get_logger
                get_logger().warning(
                    "durable commit of state %r step %s failed",
                    self._name, self._durable_step, exc_info=True)
                # self-heal a desynced counter (e.g. this rank raced a
                # commit it read as not-yet-landed): next save targets
                # past everything already on disk
                try:
                    self._durable_step = max(self._durable_step,
                                             store.latest_step() or 0)
                except Exception:
                    pass

    def flush(self) -> None:
        """Drain pending DURABLE commits (they are async — the train loop
        never blocks on disk), so a worker about to exit knows its last
        commit actually landed.  A failed trailing commit is logged, not
        raised: the pickle tier and host memory still hold the state, and
        an exit path must not crash over a flaky shared filesystem."""
        store = self._durable_store
        if store is None:
            return
        try:
            store.wait()
        except Exception:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning(
                "flush: a trailing durable commit of state %r failed",
                self._name, exc_info=True)

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, _copy_leaf(v))
        self.on_reset()

    def sync(self) -> None:
        if size() > 1:
            from horovod_tpu_torch.train.optimizer import broadcast_object
            # the durable step counter rides the same broadcast: every
            # rank must target the SAME next step or rank 0's commit
            # barrier waits on shards that never come (a fresh worker
            # reading latest_step() can lag an in-flight commit)
            step = self._durable_step
            if step is None:
                store = self._durable()
                if store is not None and rank() == 0:
                    step = store.latest_step() or 0
            data = broadcast_object(
                {"state": self._public(), "durable_step": step},
                root_rank=0, name=f"elastic.{self._name}")
            for k, v in data["state"].items():
                setattr(self, k, v)
            if data.get("durable_step") is not None:
                self._durable_step = int(data["durable_step"])
        self._snapshot()


def _copy_leaf(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        # a copy on the tensor's own device: a snapshot of parameters on
        # the card stays on the card
        return v.detach().clone()
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, (dict, list, tuple)):
        return pickle.loads(pickle.dumps(v))
    return v


def run(func: Callable) -> Callable:
    """Elastic run decorator (reference: ``run_fn``,
    ``common/elastic.py:151-175``): retry on HorovodInternalError with
    ``state.restore()``; resync on HostsUpdatedInterrupt."""

    def wrapper(state: State, *args: Any, **kwargs: Any):
        from horovod_tpu_torch.elastic import remesh
        state.sync()
        while True:
            try:
                result = func(state, *args, **kwargs)
                # signed completion receipt: how a takeover driver that
                # adopted this (already running) worker learns the run
                # SUCCEEDED without ever having seen the exit code
                _publish_result()
                return result
            except HorovodInternalError:
                # re-mesh timeline (docs/OBSERVABILITY.md "Re-mesh
                # timeline"): the episode opens at the failure and
                # closes at the first completed step/commit of the new
                # world; each phase lands as a flight span and an
                # hvd_remesh_seconds{phase} observation
                ep = remesh.begin("internal_error", old_size=size())
                with remesh.phase("drain"):
                    state.restore()
                # peer death? the driver publishes the shrunken world as
                # soon as it reaps the dead process — re-rendezvous into
                # it IN PLACE (params stay in host memory, PID unchanged).
                # No doc inside the window -> transient op error: retry
                # in the same world like the reference.
                with remesh.phase("failure_detect"):
                    update = _await_world_update()
                if update is not None:
                    # the recovery world carries the trace the driver
                    # rooted for this reactive re-mesh — the episode's
                    # phases join it (docs/OBSERVABILITY.md)
                    try:
                        from horovod_tpu_torch import tracing
                        ep.set_trace(tracing.child(
                            tracing.from_doc(update), "remesh"))
                    except Exception:
                        pass
                    _apply_world_update(update, force_shutdown=True)
                    with remesh.phase("restore"):
                        state.on_reset()
                        state.sync()
                    remesh.mark_recovered(
                        new_size=size(),
                        generation=int(update["generation"]))
                else:
                    # same-world retry: the mesh did not change, so
                    # this is NOT a re-mesh episode — close it with a
                    # retry marker (hvd_remesh_* must mean what it
                    # says, and already-emitted spans must not dangle)
                    remesh.note_same_world_retry()
                    state.sync()
            except HostsUpdatedInterrupt as e:
                # a world doc carrying a drain stamp is the PLANNED
                # re-mesh of the proactive preemption path
                # (docs/ELASTIC.md "Proactive drain & preemption"): the
                # doomed host announced itself, the driver published
                # around it, and detection cost ~nothing — record the
                # failure_detect phase anyway (≈0) so the
                # hvd_remesh_seconds series makes the planned-vs-
                # reactive difference a measured quantity, not a gap
                trigger = "preemption_drain" \
                    if isinstance(e.update, dict) and e.update.get("drain") \
                    else "hosts_updated"
                ep = remesh.begin(trigger, old_size=size())
                # the drain stamp carries the causal trace the notice/
                # finding rooted (a plain growth doc may carry a
                # doc-level one); this survivor's episode is a child
                # span of the driver's handling, so the whole chain —
                # finding → decision → action → drain → these phases →
                # first healthy step — shares one trace id
                try:
                    from horovod_tpu_torch import tracing
                    src = e.update.get("drain") \
                        if trigger == "preemption_drain" else e.update
                    ep.set_trace(tracing.child(
                        tracing.from_doc(src), "remesh"))
                except Exception:
                    pass
                with remesh.phase("failure_detect"):
                    pass  # the doc arrived WITH the interrupt
                if trigger == "preemption_drain":
                    # the interrupt is only ever raised from commit()'s
                    # check_host_updates, so state.save() ran moments
                    # ago under the OLD world — while the doomed host is
                    # still alive (that is the whole point of advance
                    # notice).  What remains is to DRAIN any async
                    # durable commits to disk before the doomed worker
                    # exits, so its shard of the sharded store lands
                    # and the planned path hands the new world a
                    # complete checkpoint instead of hoping the pickle
                    # tier survives the host
                    try:
                        flush = getattr(state, "flush", None)
                        if callable(flush):
                            flush()
                    except Exception:
                        from horovod_tpu_torch.common.logging import get_logger
                        get_logger().warning(
                            "final drain flush failed; continuing with "
                            "the last committed state", exc_info=True)
                if e.update is not None:
                    _apply_world_update(e.update)  # in-place re-mesh
                with remesh.phase("restore"):
                    state.on_reset()
                    state.sync()
                remesh.mark_recovered(
                    new_size=size(),
                    generation=int(e.update["generation"])
                    if e.update is not None else None)

    return wrapper
