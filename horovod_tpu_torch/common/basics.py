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

``init`` also brings up the diagnostics plane, as the JAX ``init`` does:
the host timeline (``HVD_TPU_TIMELINE``; with
``HVD_TPU_TIMELINE_ALL_RANKS`` a shard a rank, anchored by the clock
offset measured over the new group), the flight recorder's crash hooks
and ``init`` event, the hang watchdog's re-arm, and the per-worker
exporter (``HVD_TPU_METRICS_PORT``) with its fleet tree node.
``shutdown`` stands them down before the group is destroyed.
"""

from __future__ import annotations

import atexit
import datetime
import os
import threading
from typing import Optional

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
        self.backend = ""
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


def init() -> None:
    """Read the launcher identity and start the process group."""
    with _state.lock:
        if _state.initialized:
            return
        reset_config()
        cfg = get_config()
        ident = _read_identity_from_env()
        size, rank = ident["size"], ident["rank"]
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} is outside a world of {size}")
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
        dist.init_process_group(**kw)
        _state.rank, _state.size = rank, size
        _state.local_rank = ident["local_rank"]
        _state.local_size = ident["local_size"]
        _state.cross_rank = ident["cross_rank"]
        _state.cross_size = ident["cross_size"]
        _state.backend = backend
        _state.config = cfg
        _state.hostname = ident["hostname"] or os.uname().nodename
        from horovod_tpu_torch.common.process_sets import global_process_set
        global_process_set.ranks = list(range(size))

        # Timeline (host-side chrome tracing): rank 0 owns the
        # HVD_TPU_TIMELINE file (the port has no engine writing it, as the
        # JAX package's multi-process core does). With
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


def shutdown() -> None:
    """Stand the diagnostics plane down and destroy the process group;
    ``init`` may be called again after."""
    with _state.lock:
        if not _state.initialized:
            return
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event("shutdown", rank=_state.rank)
        try:
            # a watchdog must not run against a torn-down world, but a
            # shutdown->init cycle must not silently disarm it either:
            # suspend (remember armed); init() resumes it
            from horovod_tpu_torch.diagnostics import watchdog as _wd
            _wd.suspend()
        except Exception:
            pass
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


def metrics_snapshot() -> dict:
    """One-call observability snapshot, with the JAX package's four keys:
    ``engine`` and ``stragglers`` are ``{}`` (the port has no negotiating
    control plane, as the JAX package's backends without one report),
    ``derived`` the ratios of those counters (``{}`` too), and
    ``registry`` the process-wide metrics registry (step-time histograms,
    throughput/MFU gauges, goodput, compression, overlap and guard
    metrics). Needs no ``init``."""
    from horovod_tpu_torch.metrics.engine import derived_ratios
    from horovod_tpu_torch.metrics.registry import default_registry
    engine: dict = {}
    return {
        "engine": engine,
        "derived": derived_ratios(engine),
        "stragglers": {},
        "registry": default_registry().snapshot(),
    }


def resolve_device(dev=None) -> torch.device:
    """``None`` means the process's card (:func:`device`); anything else is
    taken as the caller's explicit choice."""
    return device() if dev is None else torch.device(dev)
