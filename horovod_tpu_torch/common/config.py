"""Environment-variable configuration: the knobs the port reads so far.

Mirrors ``horovod_tpu/common/config.py`` (``env_int``/``env_bool``/
``env_float``/``env_str``, ``Config``, ``get_config``, ``reset_config``),
trimmed to the knobs the port has ported so far. Every knob is read as
``HVD_TPU_<NAME>`` first, then ``HOROVOD_<NAME>``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    """Read ``HVD_TPU_<name>`` falling back to ``HOROVOD_<name>``."""
    v = os.environ.get("HVD_TPU_" + name)
    if v is None:
        v = os.environ.get("HOROVOD_" + name)
    return default if v is None else v


def env_int(name: str, default: int) -> int:
    v = _env(name)
    try:
        return int(v) if v not in (None, "") else default
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    v = _env(name)
    try:
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def env_bool(name: str, default: bool = False) -> bool:
    v = _env(name)
    if v in (None, ""):
        return default
    return v.lower() not in ("0", "false", "no", "off")


def env_str(name: str, default: str = "") -> str:
    v = _env(name)
    return default if v in (None, "") else v


@dataclasses.dataclass
class Config:
    """Snapshot of the runtime knobs.

    ``fusion_threshold_bytes`` is the reference's 64 MiB fusion buffer and
    the gradient bucket budget unless ``bucket_bytes`` is set;
    ``overlap_buckets`` off makes the eager gradient sync one bucket;
    buckets under ``small_bucket_floor`` bytes take one dense reduction.
    ``tpu_operations`` picks the ``torch.distributed`` backend (``NCCL`` or
    ``GLOO``; empty: NCCL when the process has a card, gloo otherwise).
    The rendezvous is rank 0's TCP store; a launched world of more than one
    process needs its address and port. ``log_level`` and
    ``log_hide_timestamp`` set the rank-tagged logger
    (``common/logging.py``). The mesh-path plan search
    (``train/autotune.py``): ``autotune_mesh`` makes it the default of
    the ``autotune=`` seams, ``autotune_budget_steps`` bounds it,
    ``autotune_cache_dir`` persists the winner (empty: off) and
    ``autotune_log`` names its CSV trace (``<log>.mesh.csv``). The
    checkpoint store (``checkpoint/store.py``, read when a store is made):
    ``checkpoint_max_to_keep`` committed steps kept (0: all),
    ``checkpoint_commit_timeout_s`` rank 0 waits for every shard marker,
    ``checkpoint_inflight`` async saves queued before ``save`` blocks, and
    ``checkpoint_dir`` the directory ``CheckpointCallback`` defaults
    to. Diagnostics: ``timeline`` is the host timeline's path (rank 0's
    file; a directory or a base for per-rank shards),
    ``timeline_mark_cycles`` its cycle markers, ``timeline_all_ranks``
    makes every rank write a shard (``<timeline>.rank<r>.json``) with a
    wall-clock anchor, merged by ``python -m
    horovod_tpu_torch.diagnostics merge``; ``metrics_port`` is the
    per-worker exporter's base port (0: off; a worker binds
    ``metrics_port + local_rank``). The other diagnostics knobs
    (``WATCHDOG_SECONDS``, ``FLIGHT_RECORDER_SIZE``, ``AUTOPSY_DIR``) are
    read live from the environment by ``horovod_tpu_torch.diagnostics``:
    they must track changes across a re-init and in tests, so they bypass
    this cached snapshot."""

    fusion_threshold_bytes: int = 64 * 1024 * 1024
    bucket_bytes: int = 0
    overlap_buckets: bool = True
    small_bucket_floor: int = 0
    tpu_operations: str = ""
    gloo_timeout_seconds: float = 30.0
    rendezvous_addr: str = ""
    rendezvous_port: int = 0
    log_level: str = "WARNING"
    log_hide_timestamp: bool = False
    autotune_mesh: bool = False
    autotune_budget_steps: int = 48
    autotune_cache_dir: str = ""
    autotune_log: str = ""
    checkpoint_max_to_keep: int = 3
    checkpoint_commit_timeout_s: float = 120.0
    checkpoint_inflight: int = 2
    checkpoint_dir: str = ""
    timeline: str = ""
    timeline_mark_cycles: bool = False
    timeline_all_ranks: bool = False
    metrics_port: int = 0

    @classmethod
    def from_env(cls) -> "Config":
        d = cls()
        return cls(
            fusion_threshold_bytes=env_int("FUSION_THRESHOLD",
                                           d.fusion_threshold_bytes),
            bucket_bytes=env_int("BUCKET_BYTES", d.bucket_bytes),
            overlap_buckets=env_bool("OVERLAP_BUCKETS", d.overlap_buckets),
            small_bucket_floor=env_int("SMALL_BUCKET_FLOOR",
                                       d.small_bucket_floor),
            tpu_operations=env_str("TPU_OPERATIONS", d.tpu_operations).upper(),
            gloo_timeout_seconds=env_float("GLOO_TIMEOUT_SECONDS",
                                           d.gloo_timeout_seconds),
            # the launcher also exports the reference's gloo names
            rendezvous_addr=env_str(
                "RENDEZVOUS_ADDR",
                os.environ.get("HOROVOD_GLOO_RENDEZVOUS_ADDR", "")),
            rendezvous_port=env_int(
                "RENDEZVOUS_PORT",
                int(os.environ.get("HOROVOD_GLOO_RENDEZVOUS_PORT") or 0)),
            log_level=env_str("LOG_LEVEL", d.log_level).upper(),
            log_hide_timestamp=env_bool("LOG_HIDE_TIME",
                                        d.log_hide_timestamp),
            autotune_mesh=env_bool("AUTOTUNE_MESH"),
            autotune_budget_steps=env_int("AUTOTUNE_BUDGET_STEPS",
                                          d.autotune_budget_steps),
            autotune_cache_dir=env_str("AUTOTUNE_CACHE_DIR",
                                       d.autotune_cache_dir),
            autotune_log=env_str("AUTOTUNE_LOG"),
            checkpoint_max_to_keep=env_int("CHECKPOINT_MAX_TO_KEEP",
                                           d.checkpoint_max_to_keep),
            checkpoint_commit_timeout_s=env_float(
                "CHECKPOINT_COMMIT_TIMEOUT_S", d.checkpoint_commit_timeout_s),
            checkpoint_inflight=env_int("CHECKPOINT_INFLIGHT",
                                        d.checkpoint_inflight),
            checkpoint_dir=env_str("CHECKPOINT_DIR"),
            timeline=env_str("TIMELINE"),
            timeline_mark_cycles=env_bool("TIMELINE_MARK_CYCLES"),
            timeline_all_ranks=env_bool("TIMELINE_ALL_RANKS"),
            metrics_port=env_int("METRICS_PORT", d.metrics_port),
        )


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def reset_config() -> None:
    """Re-read the environment on next access (``init`` and tests)."""
    global _config
    _config = None
