"""Process identity and lifecycle for the PyTorch port: ``init`` /
``shutdown`` / rank and size queries, and the CUDA device a process drives.

Mirrors ``horovod_tpu/common/basics.py`` (``init``, ``shutdown``, ``rank``,
``size``, ``local_rank``, ``local_size``, ``cross_rank``, ``cross_size``,
``is_homogeneous`` and ``_read_identity_from_env``). The launcher identity
is read from the same environment variables: ``HVD_TPU_<NAME>`` first,
then ``HOROVOD_<NAME>``.

On a GPU host a process drives one card, ``cuda:<local_rank>``. ``init``
starts a ``torch.distributed`` process group over the launched world: NCCL
when the process has a card, gloo otherwise (``HOROVOD_TPU_OPERATIONS=NCCL``
or ``GLOO`` picks one, the counterpart of the JAX package's data-plane
selector). A world of more than one process meets at rank 0's TCP store,
the rendezvous the JAX launcher exports (``HOROVOD_GLOO_RENDEZVOUS_ADDR``/
``_PORT``, or ``HVD_TPU_RENDEZVOUS_ADDR``/``_PORT``); a world of one uses an
in-process store. The eager API (broadcasts, ``DistributedOptimizer``
without an axis) keeps the JAX ``LocalBackend``'s scaled identity at size 1,
while a mesh axis of size 1 still runs its collective on the group.

The eager collectives (:mod:`horovod_tpu_torch.ops.collectives`) run on a
backend of their own, started at first use (:func:`eager_backend`): the
C++ negotiating core by default, which keeps a second rendezvous and a
negotiated shutdown off jobs that never call it. ``init(ranks=...)``
restricts the global set and ``init(process_sets=...)`` registers sets,
as in the JAX ``init``; both start the engine at once.

``init`` also brings up the diagnostics plane, as the JAX ``init`` does:
the host timeline (``HVD_TPU_TIMELINE``; with
``HVD_TPU_TIMELINE_ALL_RANKS`` a shard a rank, anchored by the clock
offset measured over the new group), the flight recorder's crash hooks
and ``init`` event, the hang watchdog's re-arm, and the per-worker
exporter (``HVD_TPU_METRICS_PORT``) with its fleet tree node. It arms
the control plane as the JAX ``init`` does: the chaos fault plan
(``HVD_TPU_FAULT_PLAN``) before the group forms, then the preemption
watcher (under an elastic driver) and the autopilot's policy engine.
``shutdown`` stands them down before the group is destroyed.

``shutdown(force=False)`` ends a world as the JAX package's negotiated
shutdown does: every rank meets at a barrier, bounded by
``HVD_TPU_SHUTDOWN_GRACE_S``, before any rank destroys the group, so rank
0 (whose process hosts the rendezvous store) cannot tear the store down
while a peer still needs it; after the barrier the other ranks return only
once rank 0's store has closed, so ``init`` may rendezvous again on the
same port. ``force=True`` (the elastic path after a
peer died, where no barrier can complete) tears the group down at once;
under NCCL it aborts the communicators, so a dead peer cannot hang the
survivor in ``destroy_process_group``. Inside an elastic re-mesh
(``horovod_tpu_torch.elastic.remesh``) the group's creation is the
episode's ``rendezvous`` phase and the rest of ``init`` its ``rebuild``
phase, as in the JAX ``init``.
"""

from __future__ import annotations

import atexit
import datetime
import os
import threading
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.config import (Config, get_config,
                                             reset_config)


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__(
            "horovod_tpu_torch has not been initialized; call init() first.")


class _GlobalState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.hostname = ""
        self.backend = ""               # the process group's: nccl or gloo
        self.launched_rank = 0          # the launcher's identity, before
        self.launched_size = 1          # any init(ranks=...) restriction
        self.world_ranks = None         # the restricted global set
        self.eager = None               # ops.backend.Backend, at first use
        self.eager_lock = threading.Lock()
        self.process_set_table = None   # common.process_sets._ProcessSetTable
        self.config: Optional[Config] = None
        self.timeline = None            # common.timeline.Timeline
        self.metrics_exporter = None    # metrics.exporter.MetricsExporter


_state = _GlobalState()


def _read_identity_from_env() -> dict:
    """Launcher-injected identity, under the reference's variable names."""
    def geti(name: str, default: int) -> int:
        v = os.environ.get("HVD_TPU_" + name, os.environ.get("HOROVOD_" + name))
        return int(v) if v not in (None, "") else default

    return dict(
        rank=geti("RANK", 0),
        size=geti("SIZE", 1),
        local_rank=geti("LOCAL_RANK", 0),
        local_size=geti("LOCAL_SIZE", 1),
        cross_rank=geti("CROSS_RANK", 0),
        cross_size=geti("CROSS_SIZE", 1),
        hostname=os.environ.get(
            "HVD_TPU_HOSTNAME", os.environ.get("HOROVOD_HOSTNAME", "")),
    )


def _backend_name(operations: str) -> str:
    """``HOROVOD_TPU_OPERATIONS`` → the ``torch.distributed`` backend."""
    if operations == "":
        return "nccl" if torch.cuda.is_available() else "gloo"
    if operations == "GLOO":
        return "gloo"
    if operations == "NCCL":
        if not torch.cuda.is_available():
            raise RuntimeError("HOROVOD_TPU_OPERATIONS=NCCL needs a CUDA "
                               "device; this process has none")
        return "nccl"
    raise ValueError(f"HOROVOD_TPU_OPERATIONS={operations!r}: expected NCCL "
                     f"or GLOO")


def init(ranks: Optional[Sequence[int]] = None,
         process_sets: Optional[list] = None) -> None:
    """Read the launcher identity and start the process group.

    ``ranks`` restricts the global set to those launched ranks (reference
    semantics of ``hvd.init(ranks)``, ``operations.cc:881-965``): rank and
    size become relative to it, and a launched process outside it has
    rank -1 but still joins the world (and the core's), so every
    rendezvous completes. ``process_sets`` are registered at once
    (``add_process_set`` on each, in order)."""
    with _state.lock:
        if _state.initialized:
            return
        reset_config()
        cfg = get_config()
        ident = _read_identity_from_env()
        size, rank = ident["size"], ident["rank"]
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} is outside a world of {size}")
        # Chaos harness (horovod_tpu/common/basics.py:125): arm the fault
        # plan before any backend boots, so the core's transport reads
        # the compiled spec and rank-scoped rules follow the rank an
        # elastic re-mesh just handed us. A malformed plan raises here.
        from horovod_tpu_torch import chaos as _chaos
        _chaos.install(rank=rank)
        backend = _backend_name(cfg.tpu_operations)
        kw = dict(backend=backend, rank=rank, world_size=size,
                  timeout=datetime.timedelta(seconds=cfg.gloo_timeout_seconds))
        if backend == "nccl":
            dev = torch.device("cuda", ident["local_rank"])
            torch.cuda.set_device(dev)
            kw["device_id"] = dev    # the communicator binds its card at init
        if size == 1:
            kw["store"] = dist.HashStore()
        elif cfg.rendezvous_addr and cfg.rendezvous_port:
            kw["init_method"] = (f"tcp://{cfg.rendezvous_addr}:"
                                 f"{cfg.rendezvous_port}")
        else:
            raise ValueError(
                f"a launched world of {size} processes needs the rendezvous: "
                f"set HOROVOD_GLOO_RENDEZVOUS_ADDR and _PORT (or "
                f"HVD_TPU_RENDEZVOUS_ADDR and _PORT) to rank 0's address")
        from horovod_tpu_torch.elastic import remesh as _remesh
        with _remesh.phase("rendezvous"):
            dist.init_process_group(**kw)
        t_rebuild = time.perf_counter()
        _state.launched_rank, _state.launched_size = rank, size
        _state.world_ranks = None
        from horovod_tpu_torch.common.process_sets import global_process_set
        global_process_set._group = global_process_set._world_ranks = None
        if ranks is not None and len(ranks) > 0:
            world = sorted(set(int(r) for r in ranks))
            if rank not in world and size == 1:
                raise ValueError(f"init(ranks={world}): this process has "
                                 f"rank {rank}, which is not in the list")
            _state.world_ranks = world
            global_process_set._world_ranks = world
            global_process_set._group = dist.new_group(world)
            rank = world.index(rank) if rank in world else -1
            size = len(world)
        _state.rank, _state.size = rank, size
        _state.local_rank = ident["local_rank"]
        _state.local_size = ident["local_size"]
        _state.cross_rank = ident["cross_rank"]
        _state.cross_size = ident["cross_size"]
        _state.backend = backend
        _state.config = cfg
        _state.hostname = ident["hostname"] or os.uname().nodename
        global_process_set.ranks = list(range(size))
        from horovod_tpu_torch.common.process_sets import _ProcessSetTable
        _state.process_set_table = _ProcessSetTable(_state)

        # Timeline (host-side chrome tracing): rank 0 owns the
        # HVD_TPU_TIMELINE file (the eager core, once started, writes its
        # own <timeline>.core.json beside it). With
        # HVD_TPU_TIMELINE_ALL_RANKS every rank writes a shard
        # (<timeline>.rank<r>.json) instead, anchored on the wall clock
        # and the offset to rank 0 measured over the new group, merged
        # by `python -m horovod_tpu_torch.diagnostics merge`.
        from horovod_tpu_torch.common.timeline import Timeline, shard_path
        all_shards = bool(cfg.timeline) and cfg.timeline_all_ranks
        own_file = cfg.timeline if not all_shards else ""
        _state.timeline = Timeline(rank, own_file)
        if all_shards:
            from horovod_tpu_torch.diagnostics.clock import \
                estimate_wall_offset
            offset = estimate_wall_offset()
            # the flight recorder shares the shard's offset so the
            # merged timeline aligns flight events with shard spans
            from horovod_tpu_torch.diagnostics.flight_recorder import \
                set_wall_offset
            set_wall_offset(offset)
            _state.timeline.start_shard(
                shard_path(cfg.timeline, rank), wall_offset_s=offset,
                mark_cycles=cfg.timeline_mark_cycles)

        # Flight recorder: always on; crash hooks make an uncaught
        # exception leave a dump next to the autopsy bundle. Span
        # counters restart with the world.
        from horovod_tpu_torch.diagnostics import spans as _spans
        _spans.reset()
        from horovod_tpu_torch.diagnostics import watchdog as _wd
        _wd.resume()  # re-arm across a shutdown->init cycle
        from horovod_tpu_torch.diagnostics.flight_recorder import (
            install_crash_hooks, record_event)
        install_crash_hooks()
        record_event("init", rank=rank, size=size, backend=backend)

        _state.initialized = True

        # Per-worker /metrics + /healthz exporter (HVD_TPU_METRICS_PORT).
        # After the initialized flag: /healthz reports live state, and a
        # bind failure only warns.
        from horovod_tpu_torch.metrics.exporter import start_worker_exporter
        _state.metrics_exporter = start_worker_exporter(_state)
        # Proactive preemption watcher (horovod_tpu/common/basics.py:247):
        # armed only under an elastic driver; idempotent across re-inits.
        try:
            from horovod_tpu_torch.elastic import preemption as _preemption
            _preemption.ensure_watcher()
        except Exception:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().debug("preemption watcher not armed",
                               exc_info=True)
        # Autopilot policy engine (horovod_tpu/common/basics.py:265):
        # armed here so a malformed HVD_TPU_AUTOPILOT_POLICY fails the
        # job at init; a re-init refreshes the engine's rank.
        from horovod_tpu_torch import autopilot as _autopilot
        _autopilot.ensure_engine()
        if _state.world_ranks is not None or process_sets:
            # an excluded process submits nothing, yet the core's world
            # must form: the engine starts now, on every process
            _start_eager(_state)
            for ps in process_sets or ():
                _state.process_set_table.register(ps)
        ep = _remesh.current()
        if ep is not None and not ep.finished:
            ep.add_phase("rebuild", time.perf_counter() - t_rebuild)


def shutdown(force: bool = False) -> None:
    """Stand the diagnostics plane down and end the world; ``init`` may be
    called again after. Without ``force`` every rank agrees first (see the
    module docstring); ``force=True`` skips the agreement, for a world
    that lost a peer."""
    with _state.lock:
        if not _state.initialized:
            return
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event("shutdown", rank=_state.rank, force=force)
        try:
            # a watchdog must not run against a torn-down world, but a
            # shutdown->init cycle must not silently disarm it either:
            # suspend (remember armed); init() resumes it
            from horovod_tpu_torch.diagnostics import watchdog as _wd
            _wd.suspend()
        except Exception:
            pass
        try:
            # the eager engine first: the core negotiates its own end with
            # every rank that started it (force: at once)
            if _state.process_set_table is not None:
                _state.process_set_table.shutdown()
                _state.process_set_table = None
            if _state.eager is not None:
                eager, _state.eager = _state.eager, None
                eager.shutdown(force=force)
        except Exception as e:
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("shutdown: the eager engine did not stop "
                                 "cleanly (%s)", e)
        try:
            # the exporter and its fleet thread push to peers over the
            # world's addresses: stopped before the group goes
            if _state.metrics_exporter is not None:
                try:
                    _state.metrics_exporter.stop()
                except Exception:
                    pass
                _state.metrics_exporter = None
            if _state.timeline is not None:
                _state.timeline.close()
                _state.timeline = None
        finally:
            _state.initialized = False
            if dist.is_initialized():
                if not force and not _agree_to_end(
                        _state.config.shutdown_grace_s):
                    force = True
                if force:
                    _abort_group(_state.backend)
                else:
                    _destroy_after_store(_state.config.shutdown_grace_s)


def _agree_to_end(grace: float) -> bool:
    """Every rank reaches a barrier before any destroys the group. False
    when the barrier failed or outlived the grace: a peer is gone."""
    if dist.get_world_size() == 1:
        return True
    try:
        work = dist.barrier(async_op=True)
        work.wait(timeout=datetime.timedelta(seconds=grace))
        return True
    except RuntimeError as e:   # DistBackendError, a peer's reset, timeout
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().warning(
            "shutdown: the world did not agree to end within %.1f s (%s); "
            "tearing the group down without waiting", grace, e)
        return False


def _destroy_after_store(grace: float) -> None:
    """Destroy the group; a rank other than 0 returns only once rank 0's
    store has closed (bounded by ``grace``). Otherwise a rank could
    ``init`` again on the same rendezvous port while rank 0's old store
    still listens, read the old world's keys there and lose the
    connection when the store closes under it."""
    store = None
    if dist.get_world_size() > 1 and dist.get_rank() != 0:
        from torch.distributed import distributed_c10d
        store = distributed_c10d._get_default_store()
    dist.destroy_process_group()
    if store is None:
        return
    try:
        # no rank sets this key: the wait ends when the server hangs up
        store.wait(["hvd_tpu/shutdown/store_closed"],
                   datetime.timedelta(seconds=grace))
    except dist.DistNetworkError:
        return                  # the server hung up: the store is closed
    except RuntimeError as e:   # DistStoreError: the wait timed out
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().warning(
            "shutdown: rank 0's store did not close within %.1f s (%s)",
            grace, e)


def _abort_group(backend: str) -> None:
    """Tear the group down without waiting on peers. NCCL's
    ``destroy_process_group`` waits for a dead peer's collectives, so its
    communicators are aborted instead; gloo's destroy returns at once."""
    if backend == "nccl":
        from torch.distributed import distributed_c10d
        distributed_c10d._abort_process_group()
    else:
        dist.destroy_process_group()


atexit.register(shutdown)


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    return _require_init().local_rank


def local_size() -> int:
    return _require_init().local_size


def cross_rank() -> int:
    return _require_init().cross_rank


def cross_size() -> int:
    return _require_init().cross_size


def is_homogeneous() -> bool:
    """True when every host runs the same number of processes; as in the
    JAX package, tested locally: this host's ``local_size`` times the host
    count accounts for every process."""
    st = _require_init()
    return st.local_size * max(st.cross_size, 1) == st.size


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Dynamic timeline start (reference: ``horovod_start_timeline``,
    ``operations.cc:1011-1041``; coordinator-only file). The JAX package
    hands the file to its engine when one runs multi-process; the port's
    host timeline owns it."""
    _require_init().timeline.start(file_path, mark_cycles=mark_cycles)


def stop_timeline() -> None:
    _require_init().timeline.stop()


def num_devices() -> int:
    """Cards this process can drive (``torch.cuda.device_count()``; 0
    without one). A rank drives one of them, ``cuda:<local_rank>``."""
    return torch.cuda.device_count()


def global_device_count() -> int:
    """Cards of the whole world: this host's :func:`num_devices` times the
    host count (``cross_size``), as the hosts of one job carry the same
    cards; this host's alone before ``init``."""
    return num_devices() * (_state.cross_size if _state.initialized else 1)


def backend() -> str:
    """The process group's backend, ``"nccl"`` or ``"gloo"``."""
    return _require_init().backend


def device() -> torch.device:
    """The card this process drives, ``cuda:<local_rank>``. Raises when no
    CUDA device is present: nothing in the port drifts onto the CPU unless
    the caller asks for it. Works before ``init()``: the binding follows
    from the launch, not from the process group."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    lr = (_state.local_rank if _state.initialized
          else _read_identity_from_env()["local_rank"])
    return torch.device("cuda", lr)


def _start_eager(st: _GlobalState):
    with st.eager_lock:
        if st.eager is None:
            from horovod_tpu_torch.ops.backend import make_backend
            st.eager = make_backend(st)
        return st.eager


def eager_backend():
    """The global set's eager backend, started at its first use.

    A world of one process gets ``LocalBackend``. A larger one gets the
    core (``HVD_TPU_EAGER_BACKEND=core``, the default: built from ``cpp/``
    at first use, then a rendezvous of its own) or the
    ``torch.distributed`` plane (``dist``). It starts at the first eager
    collective, ``add_process_set``, or ``init`` with ``ranks=`` or
    ``process_sets=``, never earlier: a job that uses only the training
    API and the mesh collectives pays for no second rendezvous and no
    negotiated shutdown. Every rank starts it at the same call, as every
    eager collective is made by every rank of its set. ``shutdown`` stops
    it, so an elastic re-mesh starts a new one over the new world."""
    st = _require_init()
    return st.eager if st.eager is not None else _start_eager(st)


def _started_eager():
    return _state.eager if _state.initialized else None


def counters() -> dict:
    """The eager engine's control-plane counters: negotiation cycles,
    response-cache hits/misses/evictions, fused units, bytes moved.
    Empty before the engine started and for a backend without a
    negotiating control plane (``LocalBackend``, the dist plane)."""
    be = _started_eager()
    return be.counters() if be is not None else {}


def stragglers() -> dict:
    """The coordinator's rank-attributed negotiation-wait report: per
    rank, the seconds the others waited on it being the LAST to announce
    a tensor, and how many tensors it held up. Only rank 0 of the core's
    world accumulates it; elsewhere it is empty."""
    fn = getattr(_started_eager(), "stragglers", None)
    return fn() if fn is not None else {}


def engine_state() -> dict:
    """The engine's pending tensors, with their ready and missing ranks,
    queue depth and join state, per coordination domain (meaningful on
    the coordinator): what the hang watchdog's autopsy names."""
    fn = getattr(_started_eager(), "engine_state", None)
    return fn() if fn is not None else {}


def metrics_snapshot() -> dict:
    """One-call observability snapshot, with the JAX package's four keys:
    the engine's raw ``counters`` as ``engine``, their ``derived`` ratios
    (cache-hit rate, fusion), the coordinator's ``stragglers`` report
    (all three empty until the eager engine has started, and for a
    backend without a negotiating control plane), and ``registry`` the
    process-wide metrics registry (step-time histograms, throughput/MFU
    gauges, goodput, compression, overlap and guard metrics). Needs no
    ``init``."""
    from horovod_tpu_torch.metrics.engine import derived_ratios
    from horovod_tpu_torch.metrics.registry import default_registry
    engine = counters()
    return {
        "engine": engine,
        "derived": derived_ratios(engine),
        "stragglers": stragglers(),
        "registry": default_registry().snapshot(),
    }


def resolve_device(dev=None) -> torch.device:
    """``None`` means the process's card (:func:`device`); anything else is
    taken as the caller's explicit choice."""
    return device() if dev is None else torch.device(dev)


# Build and availability queries (reference: horovod_mpi_built etc.,
# operations.cc:1085-1130): the port's planes are the core (the gloo-class
# TCP engine), torch.distributed's gloo and NCCL, and CUDA.
def tcp_core_built() -> bool:
    from horovod_tpu_torch.core import core_available
    return core_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def cuda_built() -> bool:
    return torch.version.cuda is not None


def gloo_enabled() -> bool:
    return gloo_built()


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def sycl_built() -> bool:
    return False
