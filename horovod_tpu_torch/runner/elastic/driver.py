"""Elastic driver: discovery-driven launch/relaunch with blacklist and
rank-stable assignments.

Reference: ``horovod/runner/elastic/driver.py`` (``ElasticDriver``: discovery
thread :181-201, stable rank assignment :233-275, worker spawn per slot
:277-295, blacklist + exit handling :297-313).

A copy of ``horovod_tpu/runner/elastic/driver.py`` with these departures:

* **Rendezvous ports are held, never handed over.** The JAX driver takes
  each world's port from ``exec_run.free_port`` (bind port 0, close,
  hand the number on: another process can take it before rank 0 binds).
  The port reserves it with :func:`~horovod_tpu_torch.runner.exec_run.
  reserve_port` and holds the socket until the next world's port is
  reserved or the driver ends, so rank 0's store binds a port nobody
  else could take.
* **An adopted worker is its pid and its start time.** The spawn record
  carries the pid's start time (``start``, an optional field the JAX
  journal ignores), and a takeover driver signals the pid's group only
  while the pid still names that process: the JAX driver polls and kills
  the bare pid, which the kernel may have given to another process.

The design — every world change keeps SURVIVORS in-process
(reference: the reset loop, ``common/elastic.py:151-175``); the
generation-restart path is the backstop, not the norm:

* **Crashes recover in place** (round 5): the lost worker's peers catch
  ``HorovodInternalError``, the driver publishes a recovery world and
  respawns a REPLACEMENT for the dead rank onto free discovery capacity
  (shrinking to the survivors when capacity is gone); survivors
  re-rendezvous under their (possibly renumbered) ranks with parameters
  still in host memory. Viability requires every survivor to hold a
  fresh elastic-listener registration (proof it can apply a world doc);
  recoveries share the ``--reset-limit`` budget with restarts.
* **Planned capacity loss shrinks in place**: discovery dropping slots
  publishes the kept-worker world; dropped workers exit via the
  not-in-new-world path at their next commit.
* **Growth keeps survivors running** (VERDICT r1 #6): when discovery only
  ADDS capacity, the driver publishes a new world document (generation,
  size, per-rank env, fresh rendezvous port) to its KV server and spawns
  workers for the new slots only. Survivors pick the update up at their
  next ``state.commit()`` (``HostsUpdatedInterrupt`` → in-place re-init).
  Ranks are stable under growth, so survivors keep their shard
  assignments.
* **Restart backstop**: jobs without committed elastic state, completion
  races, reshuffled assignments, or too-few survivors terminate the
  generation and relaunch from the last ``HVD_ELASTIC_CKPT`` commit
  (stable ranks, failed hosts blacklisted).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.runner.elastic import journal as journal_mod
from horovod_tpu_torch.runner.elastic.discovery import HostDiscovery, HostManager
from horovod_tpu_torch.runner.elastic.registration import (DRAINED, FAILURE,
                                                     SUCCESS, TERMINATED,
                                                     WorkerStateRegistry)
from horovod_tpu_torch.runner.exec_run import reserve_port, slot_command
from horovod_tpu_torch.runner.hosts import (HostInfo, SlotInfo,
                                      get_host_assignments)
from horovod_tpu_torch.runner.safe_exec import (GRACEFUL_TERMINATION_TIME_S,
                                                is_same_process,
                                                kill_group_of,
                                                process_start_time,
                                                safe_execute)

DISCOVERY_INTERVAL_S = 1.0


def loss_settle_s() -> float:
    """``HVD_TPU_LOSS_SETTLE_S``: how long the driver lets a worker loss
    SETTLE before planning recovery.  A correlated failure (a whole host
    group dying in one chaos window, a switch losing a rack) lands as
    several process exits milliseconds apart; recovering after the first
    one would plan a world containing peers that are already dead —
    a second recovery round at best, a spurious generation restart at
    worst.  The settle window collapses the burst into ONE re-mesh."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.0, env_float("LOSS_SETTLE_S", 0.3))


def drain_cooldown_s() -> float:
    """``HVD_TPU_DRAIN_COOLDOWN_S``: how long a drained host's capacity
    stays reserved after its preemption notice — long enough for the
    maintenance/preemption to actually happen, short enough that a
    repaired host rejoins promptly (expiry re-admits the capacity and
    the growth path re-spawns onto it)."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.0, env_float("DRAIN_COOLDOWN_S", 60.0))


def takeover_settle_s() -> float:
    """``HVD_TPU_DRIVER_TAKEOVER_SETTLE_S``: how long a takeover driver
    holds OFF recovery planning while adopted survivors re-register
    their elastic listeners.  The takeover KV starts with an empty
    ``notify`` scope — every registration the old driver held died with
    it — so a recovery planned in the first ticks would flunk the
    viability check and burn a generation restart, the exact outcome the
    takeover exists to avoid.  Survivors re-register at their next
    commit; the window only needs to outlast one step interval."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.0, env_float("DRIVER_TAKEOVER_SETTLE_S", 30.0))


def restart_cooldown_s() -> float:
    """``HVD_TPU_RESTART_COOLDOWN_S``: reservation window for an
    autopilot ``restart`` action (the hbm_growth planned restart,
    docs/OBSERVABILITY.md "Autopilot").  Unlike a preemption drain the
    host is HEALTHY — the restarted worker should respawn onto it as
    soon as the old process has exited and released its chip, so the
    default is seconds, not the drain cooldown's minute."""
    from horovod_tpu_torch.common.config import env_float
    return max(0.0, env_float("RESTART_COOLDOWN_S", 5.0))


class _GenRuntime:
    """Mutable bookkeeping of ONE running generation — the poll loop's
    former closure state, promoted to an object so the drain-notice and
    autopilot-action handlers can be driver METHODS instead of blocks
    inlined in ``_run_generation``'s poll loop (PR 10's documented
    debt, paid down as the autopilot action channel landed in the same
    loop)."""

    def __init__(self, slots, gen: int, coord_addr: str,
                 coord_port: int) -> None:
        self.failure = threading.Event()
        self.teardown = threading.Event()  # restart path: kill survivors
        self.worker_lost = threading.Event()  # crash: in-place shrink 1st
        self.fail_lock = threading.Lock()
        # per-worker bookkeeping keyed by (spawn_generation, rank): ranks
        # are reused across in-generation worlds (shrink renumbers,
        # growth appends), so the rank alone is not a stable identity
        self.results: Dict[tuple, str] = {}
        self.lost_keys: set = set()
        # keys whose exit was classified as the ORIGINATING failure (not
        # a casualty of someone else's crash): only these charge their
        # host's crash budget — a cascade must not blocklist every host
        # whose healthy workers died from the collective error
        self.originators: set = set()
        self.host_crashes: Dict[str, int] = {}
        # workers a capacity-loss shrink dropped from the world: their
        # exit (the not-in-new-world path) is EXPECTED, not a crash
        self.expected_exits: set = set()
        # workers a preemption drain (or an autopilot action) planned
        # out of the world: EXPECTED exits recorded DRAINED — never
        # FAILURE, never a host_crashes charge, never blocklist evidence
        self.drained_exits: set = set()
        # drain-notice / action-request tokens already acted on; tokens
        # are (scope, key, payload) so the two KV scopes cannot collide
        self.handled_tokens: set = set()
        # tokens whose planned world was not viable yet (min_np, last
        # host, completion race): token -> (next_try, delay).  The world
        # can BECOME viable — discovery adds a host — so the request is
        # retried with backoff instead of burned.
        self.deferred_tokens: dict = {}
        self.threads: Dict[tuple, threading.Thread] = {}
        self.slot_by_key: Dict[tuple, object] = {}
        self.current_rank: Dict[tuple, int] = {}  # rank in CURRENT world
        self.slots = slots
        self.np = len(slots)
        # the job is DONE when every worker of the generation it started
        # with succeeds (minus crash-shrunken ones) — growth-spawned
        # stragglers whose world the survivors never joined (completion
        # raced the scale-up) must not hold the driver hostage
        self.essential_keys: List[tuple] = [(gen, s.rank) for s in slots]
        self.essential_gen = gen
        # the generation of the most recently PUBLISHED world — what the
        # workers' HVD_ELASTIC_GENERATION reads after they adopt it, and
        # therefore what their drain notices / action requests carry.
        # Tracked separately from essential_gen because in-place GROWTH
        # publishes a new generation (rank numbering unchanged — the
        # stable-assignment check guarantees it) without touching the
        # essential set.
        self.world_gen = gen
        # the generation of the last publish that CHANGED the rank
        # numbering: growth keeps numbering stable, so notices stamped
        # anywhere in [numbering_gen, world_gen] still name a valid
        # rank; in-place shrink recoveries compact ranks and bump it
        self.numbering_gen = gen
        self.coord_addr = coord_addr
        self.coord_port = coord_port
        self.spawn = None  # bound by _run_generation


#: autopilot action kinds the driver honors, mapped to whether the
#: target's host capacity is reserved for the full drain cooldown
#: (True: the host is suspect — place the replacement elsewhere) or
#: only the short restart window (False: the host is healthy, the
#: replacement should respawn onto it as soon as the chip is free).
#: ``quarantine`` (ISSUE 13) additionally BLOCKLISTS the host with the
#: action's evidence once the planned re-mesh succeeds — the one
#: planned exit that is held against the hardware, because silent data
#: corruption is a device property, not a scheduling accident.
_ACTION_KINDS = {"drain": True, "restart": False, "quarantine": True}


def _finished_thread() -> threading.Thread:
    """A dead, already-joined Thread object.  Takeover rebuilds preload
    journal-replayed exits into ``_GenRuntime.threads`` — membership
    code indexes ``threads[k].is_alive()`` without a guard, so every
    bookkept key needs a Thread whose liveness answers correctly."""
    t = threading.Thread(target=lambda: None, daemon=True)
    t.start()
    t.join()
    return t


class ElasticDriver:
    def __init__(self, discovery: HostDiscovery, command: List[str],
                 min_np: int = 1, max_np: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None,
                 reset_limit: Optional[int] = None,
                 verbose: bool = False,
                 ckpt_dir: Optional[str] = None,
                 target_np: Optional[int] = None,
                 remote_exec=None,
                 world_secret: Optional[bytes] = None,
                 timestamp_output: bool = False,
                 start_timeout: Optional[float] = None,
                 elastic_timeout: Optional[float] = None,
                 journal_dir: Optional[str] = None,
                 takeover: bool = False) -> None:
        # remote_exec(slot, command, worker_env, events) -> rc replaces the
        # local/ssh exec when the cluster reaches hosts another way — e.g.
        # Spark tasks acting as host agents (spark/elastic.py). The
        # reference's analog is routing exec through its task services
        # instead of ssh (spark/gloo_run.py). world_secret lets such a
        # caller pre-share the world-doc HMAC key over its own trusted
        # channel instead of shipping it in worker envs over the network.
        self._remote_exec = remote_exec
        self._preshared_secret = world_secret
        self._timestamp_output = timestamp_output
        self._hosts = HostManager(discovery)
        self._command = command
        self._min_np = min_np
        self._max_np = max_np
        self._target_np = target_np
        self._env = dict(env if env is not None else os.environ)
        self._registry = WorkerStateRegistry(reset_limit)
        self._verbose = verbose
        self._ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="hvd_elastic_")
        # reference: --start-timeout bounds the initial min-host wait,
        # --elastic-timeout the re-scale waits after a generation ends
        # (an explicit 0 means "fail fast", so only None gets the default)
        self._start_timeout = 600.0 if start_timeout is None \
            else start_timeout
        self._elastic_timeout = 600.0 if elastic_timeout is None \
            else elastic_timeout
        self._stop = threading.Event()
        self._hosts_changed = threading.Event()
        self._generation = 0
        # world-document KV: survivors poll it at commit for growth resync.
        # Docs are HMAC-signed — workers apply env/coordinator changes from
        # them, and the KV port is open to the network.
        import secrets as _secrets
        import socket as _socket
        from horovod_tpu_torch.runner.http_kv import KVStoreServer
        self._kv = KVStoreServer()
        self._world_secret = self._preshared_secret or \
            _secrets.token_bytes(16)
        # the KV runs on THIS driver machine; remote workers need an
        # address that routes back here, not rank 0's host. gethostname,
        # not getfqdn: the latter can resolve to 'localhost' → ::1 while
        # the KV server is IPv4-only (see spark/elastic.py kv_addr)
        self._driver_addr = _socket.gethostname()
        # -- control-plane journal + crash takeover (docs/ELASTIC.md
        # "Driver failover & takeover") --------------------------------
        self._journal: Optional[journal_mod.DriverJournal] = None
        self._replay: Optional[journal_mod.ReplayState] = None
        self._takeover = bool(takeover)
        # rank -> addr last journaled as a "notify" record; the poll
        # loop journals only registration CHANGES, not every tick
        self._journaled_notify: Dict[str, str] = {}
        jd = journal_dir or journal_mod.journal_dir()
        kv_port: Optional[int] = None
        if self._takeover:
            if not jd:
                raise journal_mod.TakeoverRefused(
                    "takeover requested but no journal directory is "
                    "configured: set HVD_TPU_DRIVER_JOURNAL_DIR "
                    "(docs/ELASTIC.md 'Driver failover & takeover')")
            state = journal_mod.load(
                os.path.join(jd, journal_mod.JOURNAL_NAME))
            state.check_takeover()  # TakeoverRefused propagates: the
            # supervisor/operator falls back to the generation-restart
            # backstop instead of risking a stale world
            self._replay = state
            meta = state.meta
            # the fleet's worker envs carry the OLD secret/ckpt/address:
            # the takeover driver must become that identity, not mint a
            # fresh one the workers would reject
            if meta.get("secret") and self._preshared_secret is None:
                self._world_secret = bytes.fromhex(meta["secret"])
            if meta.get("ckpt_dir"):
                self._ckpt_dir = meta["ckpt_dir"]
            if meta.get("driver_addr"):
                self._driver_addr = meta["driver_addr"]
            if meta.get("kv_port"):
                kv_port = int(meta["kv_port"])
            self._generation = state.world_gen + 1
        if jd:
            self._journal = journal_mod.DriverJournal(jd)
            # WAL worker listener registrations AS THEY ARRIVE: the poll
            # loop may be stalled (or die this very tick) between a
            # worker's first commit and the next tick, and a
            # registration the journal never saw is a registration the
            # takeover driver cannot restore
            self._kv.on_put = self._observe_kv_put
        # rebinds the previously advertised port on takeover (workers
        # keep polling driver_addr:kv_port; SO_REUSEADDR rides out the
        # dead listener's TIME_WAIT)
        self._kv.start(port=kv_port)
        if self._journal is not None and not self._takeover:
            self._journal.append(
                "job_open", secret=self._world_secret.hex(),
                kv_port=self._kv.port, driver_addr=self._driver_addr,
                ckpt_dir=self._ckpt_dir, min_np=self._min_np,
                max_np=self._max_np, target_np=self._target_np,
                pid=os.getpid(), ts=journal_mod.now_wall())
        self._coord_hold = None  # the current world's held port
        self._poll_tick = 0
        self._init_driver_chaos()

    # -- journal plumbing ----------------------------------------------------
    def _journal_append(self, rtype: str, critical: bool = False,
                        **fields) -> None:
        """Write-ahead append; no-op without a journal.  ``critical``
        records (world publishes, takeover stamps) propagate I/O
        failure — a driver that cannot journal the decisions a takeover
        depends on must not keep making them; everything else degrades
        to a warning (losing a spawn pid costs the takeover an adopted
        monitor, not correctness)."""
        if self._journal is None:
            return
        try:
            self._journal.append(rtype, **fields)
        except Exception:
            if critical:
                raise
            get_logger().warning(
                "driver journal append (%s) failed", rtype, exc_info=True)

    def _observe_kv_put(self, scope: str, key: str,
                        value: bytes) -> None:
        """KV write observer (HTTP PUT path, called before the 200):
        journals worker listener registrations synchronously so they
        are durable the moment the worker is told they took."""
        if scope != "notify" or self._journal is None:
            return
        addr = value.decode("utf-8", errors="replace") \
            if isinstance(value, (bytes, bytearray)) else str(value)
        if self._journaled_notify.get(str(key)) != addr:
            self._journal_append("notify", rank=str(key), addr=addr)
            self._journaled_notify[str(key)] = addr

    def _journal_notify_observations(self) -> None:
        """Journal worker listener registrations as the poll loop sees
        them land in the ``notify`` scope.  A worker whose in-flight KV
        get simply retried across a short driver outage never observes
        the takeover and never re-registers — the journal is the only
        place the registration survives, and a takeover driver restores
        it so in-place recovery stays viable (docs/ELASTIC.md "Driver
        failover & takeover")."""
        if self._journal is None:
            return
        for rank, raw in self._kv.scope("notify").items():
            addr = raw.decode("utf-8", errors="replace") \
                if isinstance(raw, (bytes, bytearray)) else str(raw)
            if self._journaled_notify.get(str(rank)) != addr:
                self._journal_append("notify", rank=str(rank), addr=addr)
                self._journaled_notify[str(rank)] = addr

    def _journal_token(self, token) -> None:
        """Journal a handled drain-notice/action token so a takeover
        driver never re-handles a request the dead driver already acted
        on (or deliberately burned)."""
        scope, key, raw = token
        self._journal_append(
            "token", scope=scope, key=key,
            raw=raw.decode("utf-8", errors="replace")
            if isinstance(raw, (bytes, bytearray)) else str(raw))

    def _init_driver_chaos(self) -> None:
        """Arm only the fault plan's ``driver``-seam rules, in a private
        engine (``horovod_tpu/runner/elastic/driver.py:371-390``). The
        module-level ``chaos.install()`` is the workers': its rules
        default to every rank and this process would read as rank 0, so
        installing it here would fire worker faults inside the control
        plane. A malformed plan raises ``FaultPlanError`` here."""
        self._chaos = None
        from horovod_tpu_torch.chaos.plan import load_plan_from_env
        plan = load_plan_from_env()
        if plan is None:
            return
        rules = [r for r in plan.rules if r.seam == "driver"]
        if not rules:
            return
        import dataclasses as _dc

        from horovod_tpu_torch.chaos import ChaosEngine
        self._chaos = ChaosEngine(_dc.replace(plan, rules=rules), rank=0)
        get_logger().warning(
            "chaos: %d driver-seam rule(s) armed in the elastic driver",
            len(rules))

    def _reserve_coord_port(self) -> int:
        """A fresh rendezvous port for the next world, held until the
        world after it (or the driver's end) releases it."""
        hold, self._coord_hold = self._coord_hold, reserve_port()
        if hold is not None:
            hold.close()
        return self._coord_hold.getsockname()[1]

    # -- discovery thread (reference: driver.py:181-201) --------------------
    def _discovery_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self._hosts.update_available_hosts():
                    self._hosts_changed.set()
            except Exception as e:  # discovery script hiccup: keep going
                get_logger().warning("host discovery failed: %s", e)
            time.sleep(DISCOVERY_INTERVAL_S)

    def _wait_for_min_hosts(self, timeout: float = 600.0) -> None:
        deadline = time.time() + timeout
        consecutive_failures = 0
        while time.time() < deadline:
            try:
                self._hosts.update_available_hosts()
                consecutive_failures = 0
            except Exception as e:  # transient discovery hiccup: keep going
                consecutive_failures += 1
                get_logger().warning("host discovery failed: %s", e)
                if consecutive_failures >= 5:
                    # permanent misconfiguration (bad script path etc.):
                    # surface the real error instead of spinning to timeout
                    raise RuntimeError(
                        "host discovery failed 5 times in a row; check the "
                        f"discovery script: {e}") from e
            if self._hosts.slot_count() >= self._min_np:
                return
            time.sleep(DISCOVERY_INTERVAL_S)
        raise TimeoutError(
            f"needed {self._min_np} slots, found {self._hosts.slot_count()}")

    # -- world publication ---------------------------------------------------
    def _cap_np(self) -> int:
        return min(self._target_np or self._hosts.slot_count(),
                   self._max_np or self._hosts.slot_count(),
                   self._hosts.slot_count())

    def _publish_world(self, gen: int, slots, coord_addr: str,
                       coord_port: int, keyed_slots=None,
                       extra=None, runtime=None) -> None:
        """Publish a signed world doc. ``slots`` keys the doc by each
        slot's own (stable) rank — the growth case. ``keyed_slots``
        overrides with an explicit ``{lookup_rank: env}`` mapping — the
        shrink case, where survivors look themselves up by their OLD
        rank but adopt a smaller new one from the env.  ``extra`` merges
        additional signed fields into the doc (the ``drain`` stamp of a
        planned preemption re-mesh, which survivors use to label their
        re-mesh episode ``preemption_drain``).  ``runtime`` is the
        post-publish generation bookkeeping (:meth:`_runtime_record`)
        journaled WITH the doc — the write-ahead rule: the fsync'd
        journal line lands BEFORE the KV put, so the journal is always
        at least as new as anything the fleet saw and a takeover can
        complete an interrupted publish but never resurrect a stale
        world."""
        import json
        from horovod_tpu_torch.elastic import world_doc_signature
        doc = {"generation": gen, "size": len(slots),
               "coord_addr": coord_addr, "coord_port": coord_port,
               "slots": keyed_slots if keyed_slots is not None
               else {str(s.rank): s.to_env() for s in slots}}
        if extra:
            doc.update(extra)
        doc["sig"] = world_doc_signature(self._world_secret, doc)
        body = json.dumps(doc).encode()
        if self._journal is not None:
            self._journal_append("world_publish", critical=True,
                                 doc=doc, **(runtime or {}))
            try:
                # world-publish boundaries are the one safe compaction
                # point: the canonical record set re-emits this world
                self._journal.maybe_compact()
            except Exception:
                get_logger().warning("driver journal compaction failed",
                                     exc_info=True)
        self._kv.put("world", "current", body)
        self._push_world(body)

    @staticmethod
    def _runtime_record(gen: int, slots, coord_addr: str, coord_port: int,
                        essential_keys, current_rank, numbering_gen: int,
                        essential_gen: int, expected_exits=(),
                        drained_exits=()) -> dict:
        """The generation bookkeeping a ``world_publish`` record carries
        — everything :meth:`_rebuild_generation` needs to reconstruct a
        live :class:`_GenRuntime` without guessing.  Pure JSON-able
        data: (gen, rank) key tuples become 2-lists, slots become their
        dataclass dicts."""
        import dataclasses as _dc
        return {
            "world_gen": gen,
            "numbering_gen": numbering_gen,
            "essential_gen": essential_gen,
            "np": len(slots),
            "coord_addr": coord_addr,
            "coord_port": coord_port,
            "slots": [_dc.asdict(s) for s in slots],
            "essential_keys": [list(k) for k in essential_keys],
            "current_rank": [[list(k), r]
                             for k, r in current_rank.items()],
            "expected_exits": [list(k) for k in expected_exits],
            "drained_exits": [list(k) for k in drained_exits],
        }

    def _push_world(self, body: bytes) -> None:
        """Push the published doc to every registered worker listener
        (reference: WorkerNotificationService push,
        ``runner/elastic/worker.py:46+``). Best-effort with short
        timeouts: a worker that missed the push still finds the doc by
        polling the KV at its next commit."""
        from horovod_tpu_torch.runner.http_kv import kv_put

        def push(host: str, port: int) -> None:
            try:
                kv_put(host, port, "world", "current", body, timeout=5.0,
                       site="elastic.world_push")
            except OSError as e:
                get_logger().debug("world push to %s:%d failed: %s",
                                   host, port, e)

        for _rank, addr in self._kv.scope("notify").items():
            try:
                # the KV PUT surface is open to the network: malformed
                # registrations must be skipped, never crash the driver
                host, _, port = addr.decode().rpartition(":")
                port_num = int(port)
            except (UnicodeDecodeError, ValueError):
                get_logger().warning("ignoring malformed notify "
                                     "registration for rank %s", _rank)
                continue
            threading.Thread(target=push, args=(host, port_num),
                             daemon=True).start()

    # -- in-place crash recovery --------------------------------------------
    def _try_inplace_recovery(self, survivors, results, threads,
                              slot_by_key, current_rank, target_np,
                              host_crashes, charge_reset=True,
                              drain=None, gen_runtime=None):
        """A worker died mid-generation: publish a new world around the
        SURVIVORS so they re-rendezvous IN PLACE (params stay in host
        memory, PIDs unchanged — reference: the reset loop after
        HorovodInternalError, ``common/elastic.py:151-175``) instead of
        paying a process restart + checkpoint reload. Replacement
        workers for the lost ranks are respawned onto free discovery
        capacity (the reference spawns missing ranks the same way); if
        capacity is gone (host dead / removed), the world SHRINKS to the
        survivors + whatever fits. Hosts that have already eaten as many
        crashes as they have slots get no replacements.

        Returns ``(new_slots, generation, replacement_slots, coord_addr,
        coord_port)`` on success, ``None`` when not viable — too few
        survivors+capacity, an essential worker already FINISHED (its
        result was published under the old generation; the restart path
        handles that completion race), or the --reset-limit budget is
        spent. ``charge_reset=False`` (planned capacity-loss shrinks)
        leaves the crash budget untouched — routine autoscaler
        downscales must never exhaust it."""
        if any(results.get(k) is not None or not threads[k].is_alive()
               for k in survivors):
            get_logger().info("in-place recovery not viable: an "
                              "essential worker already finished")
            return None
        # every survivor must have REGISTERED its notification listener
        # (done at its first elastic commit): that proves it runs an
        # elastic.run loop able to apply a new world doc. A worker still
        # inside hvd.init — or a job without elastic state at all — can
        # only be recovered by the generation-restart path; publishing a
        # world it will never read would deadlock the rendezvous.
        notify = {str(k) for k in self._kv.scope("notify")}
        unready = [k for k in survivors
                   if str(current_rank[k]) not in notify]
        if unready:
            get_logger().info(
                "in-place recovery not viable: survivors %s have no "
                "elastic listener registration (no committed elastic "
                "state)", [current_rank[k] for k in unready])
            return None
        surv_on: Dict[str, int] = {}
        for k in survivors:
            h = slot_by_key[k].hostname
            surv_on[h] = surv_on.get(h, 0) + 1
        # replacements go onto free capacity of healthy discovered hosts,
        # as discovery sees them now: the loss being recovered can be
        # newer than the discovery thread's last view (an agent whose
        # heartbeat just went stale), and a replacement planned onto its
        # slot would fail at once
        try:
            if self._hosts.update_available_hosts():
                self._hosts_changed.set()
        except Exception as e:  # discovery hiccup: plan on the last view
            get_logger().warning("host discovery failed: %s", e)
        hosts_now = self._hosts.current_hosts()
        placement: List[str] = []
        n_repl = max(0, target_np - len(survivors))
        for h in hosts_now:
            if len(placement) >= n_repl:
                break
            if host_crashes.get(h.hostname, 0) >= h.slots:
                continue  # this host just keeps killing workers
            free = h.slots - surv_on.get(h.hostname, 0)
            placement.extend([h.hostname] * max(0, min(
                free, n_repl - len(placement))))
        new_np = len(survivors) + len(placement)
        if new_np < max(self._min_np, 1):
            get_logger().info(
                "in-place recovery not viable: %d survivors + %d "
                "replacements < min_np %d", len(survivors),
                len(placement), self._min_np)
            return None
        if charge_reset:
            # charged only once viability is established — a non-viable
            # attempt already pays for its generation restart
            self._registry.note_reset()
            # the --reset-limit budget belongs to the JOB: journaled so
            # a takeover driver inherits the spent count instead of
            # handing a crash-looping worker a fresh allowance
            self._journal_append("reset",
                                 count=self._registry.reset_count)
            if self._registry.reset_limit_reached():
                get_logger().info("in-place recovery not viable: reset "
                                  "limit reached")
                return None
        # per-host entries: survivors (in current-rank order) first, then
        # replacements — block assignment then aligns host-wise
        host_order: List[str] = []
        entries: Dict[str, list] = {}
        for k in sorted(survivors, key=lambda k: current_rank[k]):
            h = slot_by_key[k].hostname
            if h not in entries:
                host_order.append(h)
                entries[h] = []
            entries[h].append(k)
        for h in placement:
            if h not in entries:
                host_order.append(h)
                entries[h] = []
            entries[h].append(None)  # replacement marker
        hosts2 = [HostInfo(h, len(entries[h])) for h in host_order]
        new_slots = get_host_assignments(hosts2, new_np)
        flat = [e for h in host_order for e in entries[h]]
        keyed = {}
        replacements = []
        for e, ns in zip(flat, new_slots):
            if e is None:
                replacements.append(ns)
                continue
            assert ns.hostname == slot_by_key[e].hostname, (e, ns)
            # survivors look the doc up by the rank they CURRENTLY hold;
            # the env inside hands them their new one
            keyed[str(current_rank[e])] = ns.to_env()
            current_rank[e] = ns.rank
        coord_port = self._reserve_coord_port()
        coord_addr = "127.0.0.1" if new_slots[0].hostname in (
            "localhost", "127.0.0.1") else new_slots[0].hostname
        gen = self._generation
        self._generation += 1
        get_logger().info(
            "elastic generation %d (%s): np=%d "
            "(%d survivors + %d replacements)", gen,
            "planned preemption drain" if drain
            else "in-place crash recovery", new_np,
            len(survivors), len(replacements))
        extra = {"drain": drain} if drain else {}
        from horovod_tpu_torch import tracing
        if drain is None:
            # a REACTIVE recovery has no inbound context to continue
            # (the planned path's drain stamp carries the notice's) —
            # root one here so every survivor's re-mesh episode still
            # shares a single trace id with this publish
            ctx = tracing.new_trace("elastic")
            if ctx is not None:
                extra["traceparent"] = ctx.traceparent
        # journaled runtime: the post-recovery world's bookkeeping —
        # survivors under their NEW ranks plus the replacements the
        # caller is about to spawn (exactly what the caller sets as
        # essential_keys after we return)
        essential2 = sorted(survivors, key=lambda k: current_rank[k]) + \
            [(gen, s.rank) for s in replacements]
        cr2 = {k: current_rank[k] for k in survivors}
        cr2.update({(gen, s.rank): s.rank for s in replacements})
        if gen_runtime is not None:
            with gen_runtime.fail_lock:
                exp = set(gen_runtime.expected_exits)
                drn = set(gen_runtime.drained_exits)
        else:
            exp, drn = set(), set()
        self._publish_world(gen, new_slots, coord_addr, coord_port,
                            keyed_slots=keyed, extra=extra or None,
                            runtime=self._runtime_record(
                                gen, new_slots, coord_addr, coord_port,
                                essential2, cr2, gen, gen, exp, drn))
        # driver-side half of the re-mesh timeline: the survivors
        # measure their own phases (hvd_remesh_seconds); the driver
        # stamps WHEN it published the recovery world, so a merged
        # flight view can attribute the workers' failure_detect wait
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        doc_ctx = tracing.decode((drain or {}).get("traceparent")) \
            if drain else ctx
        record_event("remesh_driver_published", generation=gen,
                     np=new_np, survivors=len(survivors),
                     replacements=len(replacements),
                     charge_reset=charge_reset,
                     **tracing.fields(doc_ctx))
        # registrations are stale the moment ranks renumber: survivors
        # re-register at their first commit in the new world, and a crash
        # BEFORE that commit conservatively takes the restart path
        self._kv.clear("notify")
        self._journaled_notify.clear()
        # so are drain notices: a notice names the rank its publisher
        # held in the OLD numbering — left behind, an unhandled notice
        # would match whichever innocent worker inherits that rank
        self._kv.clear("drain")
        # and so are autopilot action requests, for the same reason: the
        # rank an action targets is only meaningful in the numbering
        # whose finding fired it
        self._kv.clear("action")
        # completion receipts are stamped with rank + generation: after
        # a renumbering publish a stale receipt could name an innocent
        # worker's new rank, so they die with the old numbering too
        self._kv.clear("result")
        return new_slots, gen, replacements, coord_addr, coord_port

    # -- drain notices & autopilot actions (poll-loop handlers) -------------
    def _scan_scope(self, g: _GenRuntime, scope: str, label: str):
        """THE one validation core for worker→driver request scopes
        (drain notices and autopilot actions share it — a fix to the
        gating below must never apply to one and silently diverge the
        other).  For each entry: skip already-handled tokens and those
        inside their no-viable-world backoff window; burn (never retry)
        malformed JSON; require the stamped generation inside
        ``[numbering_gen, world_gen]`` — published under another rank
        NUMBERING, matching it against the current one could doom an
        innocent worker, while growth publishes bump the generation but
        keep the numbering (stable-assignment check) so anything since
        the last RENUMBERING publish is still valid; out-of-window
        entries are left unhandled (not burned): the next re-mesh
        clears the scope, worst case the worker dies reactively.
        Finally resolve the named rank to a live essential worker; a
        miss (already gone or renumbered) burns the token as stale.
        Returns ``[(token, doc, origin key, named rank)]``."""
        import json as _json
        out = []
        for key, raw in self._kv.scope(scope).items():
            token = (scope, key, raw)
            if token in g.handled_tokens:
                continue
            deferred = g.deferred_tokens.get(token)
            if deferred and deferred[0] > time.monotonic():
                continue  # no-viable-world backoff window
            try:
                doc = _json.loads(raw)
                if not isinstance(doc, dict):
                    raise TypeError(f"{label} is not an object")
                nrank = int(doc.get("rank"))
                ngen = int(doc.get("generation", -1))
            except (ValueError, TypeError):
                g.handled_tokens.add(token)  # never retried
                self._journal_token(token)
                get_logger().warning(
                    "ignoring malformed %s %r", label, key)
                continue
            if not g.numbering_gen <= ngen <= g.world_gen:
                continue  # another numbering (docstring above)
            origin = next(
                (k for k in g.essential_keys
                 if g.current_rank.get(k) == nrank
                 and g.results.get(k) is None
                 and g.threads[k].is_alive()), None)
            if origin is None:
                g.handled_tokens.add(token)
                self._journal_token(token)
                continue  # already gone or renumbered: stale
            out.append((token, doc, origin, nrank))
        return out

    def _scan_drain_notices(self, g: _GenRuntime):
        """Collect actionable drain notices from the KV ``drain`` scope
        (docs/ELASTIC.md "Proactive drain & preemption"): a doomed
        worker's PreemptionWatcher published ``drain/<rank>``; plan its
        world out AROUND it instead of waiting for the death +
        transport-timeout detection the reactive path pays.  Returns
        ``(doomed keys, notice meta, tokens)``."""
        doomed: set = set()
        notice_meta: list = []
        tokens: list = []
        for token, notice, origin, nrank in self._scan_scope(
                g, "drain", "drain notice"):
            tokens.append(token)
            if notice.get("scope") == "host":
                # host-wide maintenance dooms every worker there
                h = g.slot_by_key[origin].hostname
                doomed |= {k for k in g.essential_keys
                           if g.slot_by_key[k].hostname == h
                           and g.results.get(k) is None
                           and g.threads[k].is_alive()}
            else:
                doomed.add(origin)
            entry = {"rank": nrank,
                     "host": g.slot_by_key[origin].hostname,
                     "source": notice.get("source", "unknown")}
            if isinstance(notice.get("traceparent"), str):
                # the publisher's trace context rides the notice doc;
                # the handling and the published world continue it
                entry["traceparent"] = notice["traceparent"]
            notice_meta.append(entry)
        return doomed, notice_meta, tokens

    def _scan_action_requests(self, g: _GenRuntime):
        """Collect actionable autopilot requests from the KV ``action``
        scope (ISSUE 12; docs/OBSERVABILITY.md "Autopilot"): a policy
        engine's fired remediation asked the driver to plan a worker
        out of the world — ``drain`` (sick host: reserve its capacity
        for the full cooldown) or ``restart`` (healthy host: final
        durable commit, then respawn in place after the short restart
        window).  Validation is :meth:`_scan_scope`, shared with the
        drain notices; an unknown action kind is burned here.  Returns
        ``{kind: (doomed keys, meta, tokens)}``."""
        groups = {kind: (set(), [], []) for kind in _ACTION_KINDS}
        for token, req, origin, nrank in self._scan_scope(
                g, "action", "autopilot action"):
            kind = req.get("action")
            if kind not in _ACTION_KINDS:
                g.handled_tokens.add(token)
                self._journal_token(token)
                get_logger().warning(
                    "ignoring autopilot action %r with unknown kind %r",
                    token[1], kind)
                continue
            doomed, meta, tokens = groups[kind]
            doomed.add(origin)
            tokens.append(token)
            entry = {"rank": nrank,
                     "host": g.slot_by_key[origin].hostname,
                     "source": "autopilot",
                     "policy": req.get("policy"),
                     "action": kind}
            if isinstance(req.get("traceparent"), str):
                # finding → decision → action doc: the trace continues
                # through the driver's handling into the re-mesh
                entry["traceparent"] = req["traceparent"]
            if isinstance(req.get("evidence"), dict):
                # quarantine requests carry the canary digests that
                # convicted the rank — recorded with the blocklist
                entry["evidence"] = req["evidence"]
            meta.append(entry)
        return groups

    def _plan_world_out(self, g: _GenRuntime, doomed: set,
                        notice_meta: list, tokens: list,
                        cooldown: float, event_kind: str):
        """Plan the current world around ``doomed`` (shared by drain
        notices and autopilot actions): reserve the doomed capacity,
        mark the exits DRAINED, publish the survivor world, spawn
        replacements onto free capacity — or, when no viable world
        exists, REVERT every piece of that bookkeeping and retry the
        request with backoff (reactive recovery covers an actual
        death).  Returns ``"planned"`` when the survivor world was
        published, ``"retry"`` when no viable world existed and the
        request was re-armed with backoff — both truthy: the tick is
        consumed and the caller ``continue``s — or False when the
        request was deferred untouched (workers still registering
        their elastic listeners)."""
        # the planned path needs every involved worker able to APPLY a
        # world doc (elastic listener registered, i.e. it has committed
        # once).  A request racing the job's first commits — a
        # preemption can announce itself during hvd.init — is DEFERRED
        # to a later tick, not burned on a generation restart.
        notify = {str(r) for r in self._kv.scope("notify")}
        involved = set(doomed) | {
            k for k in g.essential_keys
            if k not in doomed and g.results.get(k) is None
            and g.threads[k].is_alive()}
        if any(str(g.current_rank[k]) not in notify for k in involved):
            return False
        g.handled_tokens.update(tokens)
        # the driver's handling is a CHILD span of the notice/action
        # that asked for it (docs/OBSERVABILITY.md "Causal tracing");
        # the drain-stamped world carries the context onward so every
        # survivor's re-mesh episode joins the same trace
        from horovod_tpu_torch import tracing
        hctx = None
        for m in notice_meta:
            hctx = tracing.child(
                tracing.decode(m.get("traceparent")), "elastic")
            if hctx is not None:
                break
        by_host: Dict[str, int] = {}
        for k in doomed:
            h = g.slot_by_key[k].hostname
            by_host[h] = by_host.get(h, 0) + 1
        for h, n in by_host.items():
            # reserve the doomed capacity so replacement placement
            # cannot land back on it before the cooldown re-admits it
            # (a drain's host announced its own death; a restart's is
            # healthy and re-admits within seconds)
            self._hosts.drain(h, n, cooldown)
            # wall-stamped so a takeover restores only the REMAINING
            # window (discovery.restore_state re-ages it)
            self._journal_append("drain", host=h, slots=n,
                                 remaining_s=cooldown,
                                 ts=journal_mod.now_wall())
        with g.fail_lock:
            # BEFORE the publish (same reason as the shrink path): the
            # doomed worker can read the pushed doc and exit before
            # this loop resumes, and that exit is DRAINED, never a
            # crash
            g.expected_exits.update(doomed)
            g.drained_exits.update(doomed)
        survivors = [k for k in g.essential_keys if k not in doomed]
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event(
            event_kind,
            notices=notice_meta,
            drained_ranks=sorted(g.current_rank[k] for k in doomed),
            hosts=sorted(by_host), cooldown_s=cooldown,
            **tracing.fields(hctx))
        get_logger().warning(
            "%s %s: planning world around doomed rank(s) %s (hosts %s "
            "reserved for %.0fs)", event_kind, notice_meta,
            sorted(g.current_rank[k] for k in doomed),
            sorted(by_host), cooldown)
        recovered = self._try_inplace_recovery(
            survivors, g.results, g.threads, g.slot_by_key,
            g.current_rank, self._cap_np(), g.host_crashes,
            charge_reset=False,
            drain={"ranks": sorted(g.current_rank[k] for k in doomed),
                   "hosts": sorted(by_host),
                   "sources": sorted({m["source"]
                                      for m in notice_meta}),
                   **({"traceparent": hctx.traceparent}
                      if hctx is not None else {})},
            gen_runtime=g)
        if recovered is None:
            # no viable planned world (the doomed host was the last
            # one, min_np would be violated, or a completion race): the
            # request is ADVISORY — the worker has not died, and may
            # never.  Tearing the generation down here would turn
            # advance notice into a guaranteed restart the reactive
            # path never pays, so revert the bookkeeping and fall back
            # to reactive recovery instead.
            with g.fail_lock:
                g.expected_exits.difference_update(doomed)
                g.drained_exits.difference_update(doomed)
                # a doomed worker that exited DURING the failed
                # planning attempt was classified an expected DRAINED
                # exit, so run_slot never marked it lost — re-mark it
                # here or no recovery would ever be planned for a
                # genuinely dead worker and the generation would wedge
                gone = [k for k in doomed
                        if g.results.get(k) is not None]
                if gone:
                    g.lost_keys.update(gone)
                    g.worker_lost.set()
            for h, n in by_host.items():
                self._hosts.undrain(h, n)
                self._journal_append("undrain", host=h, slots=n)
            # un-burn the requests: the world can BECOME viable
            # (discovery adds a host) before the doomed worker dies,
            # and a drain watcher is latched after its one publish —
            # without the retry the advance notice would be permanently
            # lost.  Backoff bounds the replanning churn.
            for t in tokens:
                g.handled_tokens.discard(t)
                delay = min(
                    g.deferred_tokens.get(t, (0.0, 1.0))[1] * 2, 30.0)
                g.deferred_tokens[t] = (time.monotonic() + delay, delay)
            get_logger().warning(
                "no viable planned world for %s %s; retrying with "
                "backoff, reactive recovery covers an actual death",
                event_kind, notice_meta)
            return "retry"
        # the tokens are journaled only now that their planned world is
        # COMMITTED (journal + publish): journaling them earlier would
        # let a takeover believe a notice was handled when no world was
        # ever published for it — the worker would then die reactively,
        # which is exactly the fallback the reactive path covers
        for t in tokens:
            self._journal_token(t)
        # rebind the coordinator BEFORE spawning: run_slot reads the
        # runtime's coord fields at call time, and a replacement
        # pointed at the dead world's port would never find the mesh
        new_slots2, rec_gen, replacements, g.coord_addr, \
            g.coord_port = recovered
        for s in replacements:
            g.spawn(s, rec_gen)
        g.essential_keys = survivors + [
            (rec_gen, s.rank) for s in replacements]
        g.essential_gen = g.world_gen = g.numbering_gen = rec_gen
        g.slots = new_slots2
        g.np = len(new_slots2)
        return "planned"

    def _poll_drain_notices(self, g: _GenRuntime) -> bool:
        doomed, notice_meta, tokens = self._scan_drain_notices(g)
        if not doomed:
            return False
        return self._plan_world_out(g, doomed, notice_meta, tokens,
                                    drain_cooldown_s(),
                                    "drain_notice_handled")

    def _poll_action_requests(self, g: _GenRuntime) -> bool:
        groups = self._scan_action_requests(g)
        for kind, reserve_full in _ACTION_KINDS.items():
            doomed, meta, tokens = groups[kind]
            if not doomed:
                continue
            cooldown = drain_cooldown_s() if reserve_full \
                else restart_cooldown_s()
            result = self._plan_world_out(g, doomed, meta, tokens,
                                          cooldown,
                                          "autopilot_action_handled")
            if not result:
                continue  # deferred: try the other action kinds
            if kind == "quarantine" and result == "planned":
                # ISSUE 13: unlike a preemption drain, a quarantine IS
                # evidence against the hardware — blocklist the
                # divergent rank's host, with the canary digests that
                # convicted it on the record (re-admitted only by the
                # HVD_TPU_BLOCKLIST_COOLDOWN_S expiry)
                from horovod_tpu_torch.diagnostics.flight_recorder import (
                    record_event)
                for m in meta:
                    ev = {"reason": "quarantine", "rank": m["rank"],
                          "policy": m.get("policy"),
                          "evidence": m.get("evidence")}
                    self._hosts.blacklist(m["host"], evidence=ev)
                    self._journal_append("blocklist", host=m["host"],
                                         evidence=ev,
                                         ts=journal_mod.now_wall())
                    record_event("quarantine_blocklisted",
                                 host=m["host"], rank=m["rank"],
                                 policy=m.get("policy"),
                                 evidence=m.get("evidence"))
                    get_logger().error(
                        "quarantine: host %s (rank %d) blocklisted for "
                        "replica divergence — policy %s, evidence %s",
                        m["host"], m["rank"], m.get("policy"),
                        m.get("evidence"))
            return True
        return False

    def _recover_lost_workers(self, g: _GenRuntime) -> None:
        """A worker crashed mid-generation: recover the world in place
        (or set the failure flag for the generation-restart backstop).
        Lets a correlated burst finish dying before planning: the other
        ranks of a doomed host group are typically milliseconds behind
        the first exit, and one settled re-mesh beats a cascade of
        partial ones."""
        time.sleep(loss_settle_s())
        with g.fail_lock:
            g.worker_lost.clear()
            lost_now = set(g.lost_keys)
            blamed = lost_now & g.originators
            # this round handles exactly lost_now; clearing lets the
            # NEXT crash classify as an originator again and keeps
            # host_crashes from re-counting old losses (originators
            # pruned alongside: keys are per-instance, a handled one
            # can never recur)
            g.lost_keys.clear()
            g.originators -= lost_now
            survivors = [k for k in g.essential_keys
                         if k not in lost_now]
        # only the originating FAILURE charges its host's crash budget;
        # casualties are fallout, not evidence the host is bad (their
        # replacement still respawns below)
        for k in blamed:
            h = g.slot_by_key[k].hostname
            g.host_crashes[h] = g.host_crashes.get(h, 0) + 1
        recovered = self._try_inplace_recovery(
            survivors, g.results, g.threads, g.slot_by_key,
            g.current_rank, g.np, g.host_crashes, gen_runtime=g)
        if recovered is None:
            g.failure.set()  # not viable: generation-restart path
            return
        # rebind the coordinator BEFORE spawning (see _plan_world_out)
        new_slots2, rec_gen, replacements, g.coord_addr, \
            g.coord_port = recovered
        for s in replacements:
            g.spawn(s, rec_gen)
        g.essential_keys = survivors + [
            (rec_gen, s.rank) for s in replacements]
        g.essential_gen = g.world_gen = g.numbering_gen = rec_gen
        g.slots = new_slots2
        g.np = len(new_slots2)

    def _apply_membership_change(self, g: _GenRuntime) -> None:
        """Discovery changed the host set mid-generation: shrink in
        place (capacity loss), grow in place (new slots spawned into
        the RUNNING generation), or set the teardown flag for a
        generation restart when neither is safe."""
        new_hosts = self._hosts.current_hosts()
        new_np = self._cap_np()
        old_hostnames = {s.hostname for s in g.slots}
        still_there = old_hostnames.issubset(
            {h.hostname for h in new_hosts})
        if not still_there or new_np < g.np:
            # capacity loss: keep the remaining workers IN PLACE when
            # they can all apply a world doc (elastic state committed
            # at least once); dropped workers exit via the
            # not-in-new-world path at their next commit. Anything
            # else — a finished essential, unregistered workers, too
            # little capacity — takes the generation-restart path.
            if any(g.results.get(k) is not None
                   for k in g.essential_keys):
                g.teardown.set()
                return
            # keep workers per host up to that host's NEW slot count
            # (the downscaled host must actually lose workers) in
            # current-rank order, capped at the new world size
            new_caps = {h.hostname: h.slots for h in new_hosts}
            alive = [k for k in g.essential_keys
                     if g.threads[k].is_alive()]
            kept, used = [], {}
            for k in sorted(alive, key=lambda k: g.current_rank[k]):
                h = g.slot_by_key[k].hostname
                if len(kept) < new_np and \
                        used.get(h, 0) < new_caps.get(h, 0):
                    kept.append(k)
                    used[h] = used.get(h, 0) + 1
            dropped = [k for k in g.essential_keys if k not in kept]
            with g.fail_lock:
                # BEFORE the publish: a dropped worker can read the
                # pushed doc and exit before this loop resumes, and
                # that exit must not be classified as a crash
                g.expected_exits.update(dropped)
            recovered = self._try_inplace_recovery(
                kept, g.results, g.threads, g.slot_by_key,
                g.current_rank, new_np, g.host_crashes,
                charge_reset=False, gen_runtime=g)
            if recovered is None:
                g.teardown.set()
                return
            new_slots2, rec_gen, replacements, g.coord_addr, \
                g.coord_port = recovered
            for s in replacements:
                g.spawn(s, rec_gen)
            g.essential_keys = kept + [(rec_gen, s.rank)
                                       for s in replacements]
            g.essential_gen = g.world_gen = g.numbering_gen = rec_gen
            g.slots = new_slots2
            g.np = len(new_slots2)
            return
        if new_np <= g.np:
            return  # capacity we are not using anyway
        # GROWTH: stable assignment keeps existing ranks; spawn only
        # the new slots, publish the new world for survivor resync
        new_slots = get_host_assignments(new_hosts, new_np)
        if not all(ns.rank == s.rank and ns.hostname == s.hostname
                   for ns, s in zip(new_slots, g.slots)):
            # assignment reshuffled existing ranks (host reordering):
            # in-place resync would double-assign ranks — restart
            get_logger().warning(
                "growth reshuffled existing ranks; falling back to a "
                "generation restart")
            g.teardown.set()
            return
        # fresh rendezvous for the new world
        g.coord_port = self._reserve_coord_port()
        gen = self._generation
        self._generation += 1
        get_logger().info(
            "elastic generation %d (growth, in-place): np=%d->%d",
            gen, g.np, new_np)
        # growth keeps the numbering: the runtime's current_rank simply
        # extends with the about-to-be-spawned slots' keys
        cr = dict(g.current_rank)
        cr.update({(gen, s.rank): s.rank for s in new_slots[g.np:]})
        with g.fail_lock:
            exp = set(g.expected_exits)
            drn = set(g.drained_exits)
        self._publish_world(gen, new_slots, g.coord_addr, g.coord_port,
                            runtime=self._runtime_record(
                                gen, new_slots, g.coord_addr,
                                g.coord_port, g.essential_keys, cr,
                                g.numbering_gen, g.essential_gen,
                                exp, drn))
        g.world_gen = gen  # survivors adopt this gen; notices carry it
        for s in new_slots[g.np:]:
            g.spawn(s, gen)
        g.slots = new_slots
        g.np = new_np

    # -- one generation ------------------------------------------------------
    def _run_generation(self) -> str:
        """Launch workers for the current host set; returns SUCCESS /
        FAILURE / 'HOSTS_CHANGED'. Growth extends the RUNNING generation
        (new world published to the KV, survivors resync at commit);
        shrink/failure tears it down for a restart."""
        hosts = self._hosts.current_hosts()
        np = self._cap_np()
        slots = get_host_assignments(hosts, np)
        coord_port = self._reserve_coord_port()
        coord_addr = "127.0.0.1" if slots[0].hostname in (
            "localhost", "127.0.0.1") else slots[0].hostname
        self._registry.reset(np)
        self._journal_append("reset", count=self._registry.reset_count)
        # drop listener registrations from the previous generation: its
        # processes are gone, and pushing signed world docs at dead (or
        # recycled) host:port addresses wastes a thread per publish and
        # could hand the doc to an unrelated process. This generation's
        # workers re-register at their first commit.
        self._kv.clear("notify")
        self._journaled_notify.clear()
        # stale drain notices die with their generation too: the rank a
        # notice names is only meaningful in the world that published it,
        # and the doomed HOST is already held out by its HostManager
        # drain reservation regardless
        self._kv.clear("drain")
        # autopilot action requests die with their generation too: the
        # rank a request targets is only meaningful in the world whose
        # finding fired it
        self._kv.clear("action")
        # completion receipts are per-generation too (rank + generation
        # stamped): a stale one must not vouch for this world's workers
        self._kv.clear("result")
        self._hosts_changed.clear()
        gen = self._generation
        self._generation += 1
        get_logger().info("elastic generation %d: np=%d hosts=%s", gen, np,
                          [h.hostname for h in hosts])
        self._publish_world(gen, slots, coord_addr, coord_port,
                            runtime=self._runtime_record(
                                gen, slots, coord_addr, coord_port,
                                [(gen, s.rank) for s in slots],
                                {(gen, s.rank): s.rank for s in slots},
                                gen, gen))

        g = _GenRuntime(slots, gen, coord_addr, coord_port)
        g.spawn = lambda slot, slot_gen: self._spawn_worker(
            g, slot, slot_gen)
        for s in slots:
            g.spawn(s, gen)
        return self._monitor_generation(g)

    def _run_slot(self, g: _GenRuntime, slot, slot_gen: int) -> None:
        key = (slot_gen, slot.rank)
        extra_env = {
            "HVD_TPU_ELASTIC": "1",
            "HVD_ELASTIC_GENERATION": str(slot_gen),
            "HVD_ELASTIC_CKPT": self._ckpt_dir,
            "HVD_ELASTIC_SECRET": self._world_secret.hex(),
            "HVD_ELASTIC_KV": f"127.0.0.1:{self._kv.port}"
            if slot.hostname in ("localhost", "127.0.0.1")
            else f"{self._driver_addr}:{self._kv.port}"}
        prefix = f"[{slot.rank}]" if self._verbose else ""

        def note_pid(pid):
            # the journaled pid is what lets a takeover driver ADOPT
            # this worker: monitor its liveness, and kill its process
            # group if the generation must die
            # ``start`` (the pid's start time, optional: the JAX
            # package's journal neither writes nor needs it) lets the
            # adopter tell this worker from a later process that the
            # kernel gave the same pid
            extra = {} if pid is None else \
                {"start": process_start_time(pid)}
            self._journal_append("spawn", key=list(key),
                                 host=slot.hostname, rank=slot.rank,
                                 pid=pid, ts=journal_mod.now_wall(), **extra)

        if self._remote_exec is not None:
            # agent transport: ship the RAW worker command + env; the
            # agent on slot.hostname execs it locally (no ssh wrap).
            # The remote pid is unknowable here — journaled as None, so
            # a takeover waits on the worker's completion receipt
            # instead of a liveness probe (documented limitation).
            note_pid(None)
            from horovod_tpu_torch.runner.exec_run import build_worker_env
            wenv = build_worker_env(slot, g.coord_addr, g.coord_port,
                                    self._env)
            wenv.update(extra_env)
            if self._preshared_secret is not None:
                # the caller distributed the secret over its own
                # trusted channel; keep it off the wire
                wenv.pop("HVD_ELASTIC_SECRET", None)
            rc = self._remote_exec(slot, self._command, wenv,
                                   [g.failure, g.teardown])
        else:
            # local-vs-ssh dispatch shared with the static launcher so
            # multi-host elastic jobs actually place workers remotely
            cmd, env = slot_command(
                slot, self._command, g.coord_addr, g.coord_port,
                self._env, extra_env=extra_env)
            rc = safe_execute(cmd, env=env, prefix=prefix,
                              events=[g.failure, g.teardown],
                              timestamp=self._timestamp_output,
                              on_start=note_pid)
        self._classify_exit(g, slot, key, rc)

    def _classify_exit(self, g: _GenRuntime, slot, key: tuple,
                       rc: int) -> None:
        """Record one worker exit.  Distinguishes the ORIGINATING
        failure from its fallout: workers the driver tore down, and
        CASUALTIES — workers that died from the collective error the
        originator caused (a job without elastic state has no way to
        ride out a peer loss).  Only the originator counts as FAILURE,
        so the blacklist and the restart decision see one crash, not a
        cascade.  A crash does not fail the generation outright: the
        monitor loop first tries to recover the world in place."""
        if rc == 0:
            g.results[key] = SUCCESS
            self._registry.record(slot.rank, slot.hostname, SUCCESS)
            self._journal_append("exit", key=list(key), state=SUCCESS,
                                 rank=slot.rank, host=slot.hostname)
            return
        with g.fail_lock:
            torn_down = g.failure.is_set() or g.teardown.is_set()
            expected = key in g.expected_exits
            casualty = bool(g.lost_keys) and not torn_down \
                and not expected
            if not torn_down and not expected:
                g.lost_keys.add(key)
                if not casualty:
                    g.originators.add(key)
                g.worker_lost.set()
            # classification is atomic with the membership checks:
            # _plan_world_out's no-viable-world revert edits these
            # sets under the same lock and must observe either a
            # fully recorded exit or none at all
            if key in g.drained_exits:
                state = DRAINED
            elif torn_down or casualty or expected:
                state = TERMINATED
            else:
                state = FAILURE
            g.results[key] = state
        self._registry.record(slot.rank, slot.hostname, state)
        self._journal_append("exit", key=list(key), state=state,
                             rank=slot.rank, host=slot.hostname)

    def _spawn_worker(self, g: _GenRuntime, slot, slot_gen: int) -> None:
        key = (slot_gen, slot.rank)
        t = threading.Thread(target=self._run_slot,
                             args=(g, slot, slot_gen), daemon=True)
        g.threads[key] = t
        g.slot_by_key[key] = slot
        g.current_rank[key] = slot.rank
        t.start()

    def _monitor_generation(self, g: _GenRuntime) -> str:
        """The generation's poll loop + final classification — split
        from :meth:`_run_generation` so a takeover driver can resume
        monitoring a REBUILT generation without re-spawning it."""
        while any(t.is_alive() for t in g.threads.values()):
            time.sleep(0.25)
            self._poll_tick += 1
            if self._chaos is not None:
                # the `driver` chaos seam (horovod_tpu/runner/elastic/
                # driver.py:1329), one invocation a poll tick: kill/exit
                # end this process mid-decision (the launcher's
                # supervisor respawns it into a journal takeover), stall
                # freezes the control plane while workers ride it out
                self._chaos.fire("driver", index=self._poll_tick)
            # WAL the listener registrations this tick observes: a
            # takeover driver restores them, because a survivor that
            # never noticed the outage will never re-register on its own
            self._journal_notify_observations()
            if not g.failure.is_set() and not g.teardown.is_set() and \
                    all(g.results.get(k) == SUCCESS
                        for k in g.essential_keys):
                # survivors finished; kill growth stragglers still waiting
                # for a rendezvous that will never complete
                g.teardown.set()
            # -- a worker crashed: recover the world in place --------------
            if g.worker_lost.is_set() and not g.failure.is_set() and \
                    not g.teardown.is_set():
                if self._adoption_settling(g):
                    continue  # survivors still re-registering (takeover)
                self._recover_lost_workers(g)
                continue
            if not g.failure.is_set() and not g.teardown.is_set():
                # -- a preemption/maintenance drain notice arrived ---------
                if self._poll_drain_notices(g):
                    continue
                # -- an autopilot action request arrived (ISSUE 12) --------
                if self._poll_action_requests(g):
                    continue
            if g.failure.is_set() or not self._hosts_changed.is_set():
                continue
            # -- membership changed mid-generation -------------------------
            self._hosts_changed.clear()
            self._apply_membership_change(g)

        ess_ok = all(
            g.results.get(k) == SUCCESS for k in g.essential_keys)
        if ess_ok:
            # only the ESSENTIAL workers are guaranteed complete —
            # in-place growth may have raised np while its stragglers
            # were torn down after the survivors finished in the old
            # world, and crash-shrunken workers' FAILURE records were
            # absorbed by the in-place re-mesh
            self._final_np = len(g.essential_keys)
            self._final_gen = g.essential_gen
            return SUCCESS
        if (g.teardown.is_set() or self._hosts_changed.is_set()) and \
                self._registry.count(FAILURE) == 0:
            return "HOSTS_CHANGED"
        if self._registry.count(FAILURE) > 0:
            for host, n in self._registry.failed_hosts().items():
                # a host whose every worker failed is blacklisted
                # (reference: driver blacklist, driver.py:297-313)
                host_slots = sum(1 for s in g.slots
                                 if s.hostname == host)
                if n >= host_slots:
                    ev = {"reason": "all_workers_failed", "failures": n,
                          "slots": host_slots}
                    self._hosts.blacklist(host, evidence=ev)
                    self._journal_append("blocklist", host=host,
                                         evidence=ev,
                                         ts=journal_mod.now_wall())
            return FAILURE
        self._final_np = len(g.essential_keys)
        self._final_gen = g.essential_gen
        return SUCCESS

    def _adoption_settling(self, g: _GenRuntime) -> bool:
        """True while a freshly adopted generation should HOLD OFF
        recovery planning: right after a takeover no survivor has
        re-registered its elastic listener yet (the old driver's
        ``notify`` scope died with it), so planning now would flunk the
        viability check and burn the generation restart the takeover
        exists to avoid.  Clears as soon as every live survivor has
        re-registered, or when the settle deadline passes (a survivor
        that never re-registers really is unrecoverable in place)."""
        deadline = getattr(g, "adopted_until", None)
        if deadline is None or time.monotonic() >= deadline:
            return False
        notify = {str(r) for r in self._kv.scope("notify")}
        with g.fail_lock:
            lost = set(g.lost_keys)
        waiting = [k for k in g.essential_keys
                   if k not in lost and g.results.get(k) is None
                   and g.threads[k].is_alive()
                   and str(g.current_rank.get(k)) not in notify]
        return bool(waiting)

    # -- crash takeover (docs/ELASTIC.md "Driver failover & takeover") -------
    def _begin_takeover(self) -> _GenRuntime:
        """Become the driver the journal describes: restore exclusion
        state and the reset budget, re-publish the last committed world
        doc VERBATIM (its HMAC is over the sort_keys canonical form, so
        the old signature stays valid), and rebuild the running
        generation from spawn/exit records — workers mid-step never
        re-mesh; they just find the same world at their next poll."""
        import json as _json
        state = self._replay
        assert state is not None and state.world is not None
        self._journal_append("takeover", critical=True, pid=os.getpid(),
                             ts=journal_mod.now_wall())
        try:
            from horovod_tpu_torch.metrics.registry import default_registry
            default_registry().counter(
                "hvd_driver_takeovers_total",
                help="elastic driver crash takeovers completed from the "
                     "control-plane journal").inc()
        except Exception:
            pass
        # the takeover span continues the adopted generation's trace —
        # one trace id from the world that was published through the
        # crash and into the recovered control plane
        from horovod_tpu_torch import tracing
        doc = state.world["doc"]
        ctx = tracing.decode(doc.get("traceparent")) \
            or tracing.new_trace("elastic")
        try:
            from horovod_tpu_torch.diagnostics.flight_recorder import \
                record_event
            record_event("driver_takeover", pid=os.getpid(),
                         generation=state.world_gen,
                         np=int(state.world.get("np", 0)),
                         adopted=len(state.live_workers()),
                         replayed_exits=len(state.exits),
                         blocklisted=len(state.blocklist),
                         **tracing.fields(ctx))
        except Exception:
            pass
        tracing.record_span("elastic", "driver_takeover",
                            tracing.child(ctx, "elastic"),
                            generation=state.world_gen,
                            adopted=len(state.live_workers()))
        self._hosts.restore_state(state.blocklist, state.drains)
        self._registry.restore_reset_count(state.reset_count)
        # seed the discovery view BEFORE clearing the change flag: the
        # takeover must not misread "first refresh populated an empty
        # view" as a mid-generation membership change
        try:
            self._hosts.update_available_hosts()
        except Exception as e:
            get_logger().warning(
                "takeover: initial host discovery failed (%s); the "
                "discovery loop will retry", e)
        self._hosts_changed.clear()
        # restore the journaled listener registrations: a survivor whose
        # KV gets retried straight through the outage never notices the
        # driver changed and never re-registers — without this restore
        # the empty ``notify`` scope flunks the in-place recovery
        # viability check and burns a generation restart
        for rank, rec in state.notify.items():
            addr = rec.get("addr", "")
            if addr:
                self._kv.put("notify", rank, addr.encode())
                self._journaled_notify[rank] = addr
        self._kv.put("world", "current", _json.dumps(doc).encode())
        g = self._rebuild_generation(state)
        get_logger().warning(
            "driver takeover complete: generation %d adopted (np=%d, "
            "%d live worker(s), %d prior exit(s), %d listener "
            "registration(s) restored, %d blocklisted host(s), reset "
            "budget %d spent)", g.world_gen, g.np,
            sum(1 for t in g.threads.values() if t.is_alive()),
            len(state.exits), len(state.notify), len(state.blocklist),
            state.reset_count)
        return g

    def _rebuild_generation(self,
                            state: journal_mod.ReplayState) -> _GenRuntime:
        """A live :class:`_GenRuntime` from the journal's last
        ``world_publish`` runtime + the spawn/exit records after it."""
        w = state.world
        slots = [SlotInfo(**d) for d in w["slots"]]
        slot_by_rank = {s.rank: s for s in slots}
        g = _GenRuntime(slots, int(w["essential_gen"]),
                        w["coord_addr"], int(w["coord_port"]))
        g.world_gen = int(w["world_gen"])
        g.numbering_gen = int(w["numbering_gen"])
        g.essential_keys = [tuple(k) for k in w["essential_keys"]]
        g.current_rank = {tuple(k): r for k, r in w["current_rank"]}
        g.expected_exits = {tuple(k)
                            for k in w.get("expected_exits", [])}
        g.drained_exits = {tuple(k) for k in w.get("drained_exits", [])}
        # token payloads journal as utf-8 text; the live dedupe set
        # holds the KV's raw BYTES — re-encode or every replayed token
        # would silently fail to match and be re-handled
        g.handled_tokens = {(s, k, r.encode("utf-8"))
                            for (s, k, r) in state.tokens}
        g.spawn = lambda slot, slot_gen: self._spawn_worker(
            g, slot, slot_gen)
        g.adopted_until = time.monotonic() + takeover_settle_s()

        def slot_for(key, rec):
            rank = g.current_rank.get(key)
            if rank in slot_by_rank:
                return slot_by_rank[rank]
            # spawn record as fallback (a straggler whose publish-time
            # rank is gone): enough identity to classify, not to place
            return SlotInfo(hostname=rec.get("host", "localhost"),
                            rank=key[1], local_rank=0, cross_rank=0,
                            size=len(slots), local_size=1,
                            cross_size=1)

        # exits the dead driver already classified: preloaded as
        # finished bookkeeping so membership checks (threads[k]
        # .is_alive() with no KeyError guard) and the success test see
        # them.  Only the current numbering window counts — older exits
        # were absorbed by re-meshes the journal already published.
        lo, hi = g.numbering_gen, g.world_gen
        lost_essentials = []
        for key_t, rec in state.exits.items():
            key = tuple(key_t)
            if not lo <= key[0] <= hi:
                continue
            st = rec.get("state", FAILURE)
            slot = slot_for(key, rec)
            g.results[key] = st
            g.threads[key] = _finished_thread()
            g.slot_by_key.setdefault(key, slot)
            g.current_rank.setdefault(key, rec.get("rank", key[1]))
            self._registry.record(rec.get("rank", key[1]),
                                  rec.get("host", slot.hostname), st)
            if st == FAILURE and key in g.essential_keys:
                lost_essentials.append(key)
        # live workers: adopt.  A local pid gets a liveness monitor
        # (and, if the generation must die, a process-group kill — the
        # setsid spawn is why these workers outlived their driver); a
        # remote/pid-less worker can only be awaited via its signed
        # completion receipt.
        import socket as _socket
        local_names = {"localhost", "127.0.0.1", _socket.gethostname()}
        to_start = []
        for key_t, rec in state.live_workers().items():
            key = tuple(key_t)
            if key in g.results:
                continue
            slot = slot_for(key, rec)
            g.slot_by_key.setdefault(key, slot)
            g.current_rank.setdefault(key, rec.get("rank", key[1]))
            pid, start = rec.get("pid"), rec.get("start")
            # a record without the pid's start time cannot tell the
            # worker from a later process with its pid: only the
            # receipt is trusted, and nothing is signalled
            if pid and start is not None and slot.hostname in local_names:
                t = threading.Thread(
                    target=self._monitor_adopted,
                    args=(g, key, slot, int(pid), int(start)), daemon=True)
            else:
                t = threading.Thread(
                    target=self._await_adopted_result,
                    args=(g, key, slot), daemon=True)
            g.threads[key] = t
            to_start.append(t)
        # essential keys with NEITHER an exit nor a spawn record (a
        # lost journal append, or a spawn the crash preempted): treated
        # as lost, which routes them through the normal in-place
        # recovery once the survivors have re-registered
        for key in list(g.essential_keys):
            if key in g.threads:
                continue
            slot = slot_for(key, {})
            g.slot_by_key.setdefault(key, slot)
            g.threads[key] = _finished_thread()
            get_logger().warning(
                "takeover: essential worker %s has no journal record; "
                "classifying it lost", key)
            self._classify_exit(g, slot, key, 1)
        # exits the dead driver classified FAILURE but never finished
        # recovering (crashed mid-re-mesh — the worst case): re-mark
        # them lost so the monitor loop plans the recovery the old
        # driver never published
        if lost_essentials:
            with g.fail_lock:
                g.lost_keys.update(lost_essentials)
                g.originators.update(lost_essentials)
                g.worker_lost.set()
        for t in to_start:
            t.start()
        return g

    def _monitor_adopted(self, g: _GenRuntime, key: tuple, slot,
                         pid: int, start: int) -> None:
        """Stand-in for the :meth:`_run_slot` thread of a worker THIS
        process never spawned: poll the adopted pid for liveness,
        escalate a generation teardown to its process group, and
        classify the exit from the worker's signed completion receipt
        (the exit CODE died with the old driver).

        The worker is the pid AND its start time (``start``, from the
        spawn record): once the pid names another
        process, the worker has ended, and that process is never
        signalled."""
        import signal as _signal
        killed_at = None
        while is_same_process(pid, start):
            if g.failure.is_set() or g.teardown.is_set():
                if killed_at is None:
                    kill_group_of(pid, start, _signal.SIGTERM)
                    killed_at = time.monotonic()
                elif time.monotonic() - killed_at > \
                        GRACEFUL_TERMINATION_TIME_S:
                    kill_group_of(pid, start, _signal.SIGKILL)
            time.sleep(0.25)
        rc = 0 if self._adopted_result_ok(g, key) else 1
        self._classify_exit(g, slot, key, rc)

    def _await_adopted_result(self, g: _GenRuntime, key: tuple,
                              slot) -> None:
        """Adoption monitor for a worker with no observable pid (remote
        exec, or the spawn record lacks its pid or its start time): the
        only signal is the signed completion receipt.  Documented
        limitation: such a
        worker's DEATH is invisible until a peer's transport error
        surfaces it — the reactive path still covers it, later."""
        while not (g.failure.is_set() or g.teardown.is_set()):
            if self._adopted_result_ok(g, key):
                self._classify_exit(g, slot, key, 0)
                return
            time.sleep(1.0)
        self._classify_exit(g, slot, key, 1)

    def _adopted_result_ok(self, g: _GenRuntime, key: tuple) -> bool:
        """True when the KV ``result`` scope holds a VALID completion
        receipt for the worker: HMAC-signed with the world secret
        (receipts influence SUCCESS classification and the PUT surface
        is open to the network), rank matching, generation inside the
        current numbering window."""
        import hmac as _hmac
        import json as _json
        rank = g.current_rank.get(key)
        if rank is None:
            return False
        raw = self._kv.get("result", str(rank))
        if raw is None:
            return False
        try:
            doc = _json.loads(raw)
            if not isinstance(doc, dict):
                return False
            from horovod_tpu_torch.elastic import world_doc_signature
            sig = doc.get("sig")
            if not isinstance(sig, str) or not _hmac.compare_digest(
                    sig, world_doc_signature(self._world_secret, doc)):
                return False
            if int(doc.get("rank", -1)) != int(rank):
                return False
            return g.numbering_gen <= \
                int(doc.get("generation", -1)) <= g.world_gen
        except (ValueError, TypeError):
            return False

    @property
    def final_np(self) -> Optional[int]:
        """World size of the generation that completed successfully (None
        until then) — callers collecting per-rank artifacts use it to
        ignore leftovers from aborted generations."""
        return getattr(self, "_final_np", None)

    @property
    def final_generation(self) -> Optional[int]:
        """Generation number the completed ranks were launched with
        (their ``HVD_ELASTIC_GENERATION``) — pairs with final_np for
        generation-scoped artifact collection."""
        return getattr(self, "_final_gen", None)

    # -- main loop -----------------------------------------------------------
    def run(self) -> int:
        adopted: Optional[_GenRuntime] = None
        if self._takeover:
            # the fleet is (presumably) still running: adopt it instead
            # of waiting for min hosts to relaunch it
            adopted = self._begin_takeover()
        else:
            self._wait_for_min_hosts(timeout=self._start_timeout)
        disc = threading.Thread(target=self._discovery_loop, daemon=True)
        disc.start()
        try:
            while True:
                if adopted is not None:
                    g, adopted = adopted, None
                    result = self._monitor_generation(g)
                else:
                    result = self._run_generation()
                if result == SUCCESS:
                    # clean_exit tells a later takeover attempt (and the
                    # supervisor) this rc was ON PURPOSE, not a crash
                    self._journal_append("clean_exit", rc=0)
                    return 0
                if self._registry.reset_limit_reached():
                    get_logger().error(
                        "elastic reset limit reached after %d generations",
                        self._registry.reset_count)
                    self._journal_append("clean_exit", rc=1)
                    return 1
                # wait until we have enough usable slots again
                try:
                    self._wait_for_min_hosts(timeout=self._elastic_timeout)
                except TimeoutError:
                    self._journal_append("clean_exit", rc=1)
                    return 1
        finally:
            self._stop.set()
            disc.join(timeout=3)
            self._kv.stop()
            if self._coord_hold is not None:
                self._coord_hold.close()
                self._coord_hold = None
            if self._journal is not None:
                self._journal.close()


def run_elastic(discovery: HostDiscovery, np: Optional[int],
                command: List[str],
                min_np: int = 1, max_np: Optional[int] = None,
                env: Optional[Dict[str, str]] = None,
                verbose: bool = False,
                reset_limit: Optional[int] = None,
                timestamp_output: bool = False,
                start_timeout: Optional[float] = None,
                elastic_timeout: Optional[float] = None,
                journal_dir: Optional[str] = None,
                takeover: bool = False) -> int:
    driver = ElasticDriver(discovery, command, min_np=min_np, max_np=max_np,
                           env=env, verbose=verbose, reset_limit=reset_limit,
                           target_np=np, timestamp_output=timestamp_output,
                           start_timeout=start_timeout,
                           elastic_timeout=elastic_timeout,
                           journal_dir=journal_dir, takeover=takeover)
    return driver.run()
