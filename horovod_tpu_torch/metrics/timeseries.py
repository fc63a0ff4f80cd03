"""Step-aligned time-series history: a bounded ring + append-only JSONL.

A copy of ``horovod_tpu/metrics/timeseries.py``: every completed step
lands as a small point in a bounded in-memory ring (always on, drop-oldest,
same philosophy as the flight recorder), and when ``HVD_TPU_OBS_DIR`` is
set each sampled point is ALSO appended to a per-rank JSONL file
(``obs_rank<r>.jsonl``) with size-based rotation, so the trajectory
survives the process. The file format is the JAX package's: its
``read_series`` (and its ``history`` command) reads the port's files,
and :func:`read_series` here reads the JAX package's.

Producers: ``StepTimer.end_step`` (every training loop with telemetry) and
the goodput ledger's closed windows. Consumers: the anomaly engine
(:mod:`horovod_tpu_torch.metrics.anomaly`) and readers of the files.

Stdlib-only, like the rest of the metrics plane.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

DEFAULT_RING_CAPACITY = 4096
DEFAULT_MAX_BYTES = 16 * 1024 * 1024
DEFAULT_SAMPLE_EVERY = 1


def _env_int(name: str, default: int) -> int:
    from horovod_tpu_torch.common.config import env_int
    return env_int(name, default)


def obs_dir() -> str:
    """``HVD_TPU_OBS_DIR`` — empty string disables persistence (the ring
    still records).  Read live, not from the cached Config snapshot: the
    obs plane must track env changes across re-init and tests."""
    from horovod_tpu_torch.common.config import env_str
    return env_str("OBS_DIR")


class TimeSeriesRing:
    """Thread-safe bounded ring of observation points (plain dicts)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = int(capacity) if capacity else _env_int(
            "OBS_RING_SIZE", DEFAULT_RING_CAPACITY)
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=max(self.capacity, 1))
        self._lock = threading.Lock()

    def append(self, point: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(point)

    def points(self, last_n: Optional[int] = None) -> List[dict]:
        with self._lock:
            pts = list(self._ring)
        return pts[-last_n:] if last_n else pts

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


class SeriesWriter:
    """Append-only JSONL writer with size-based rotation.

    One file per rank (``obs_rank<r>.jsonl``); when the file crosses
    ``max_bytes`` it is rotated to ``.1`` (one generation kept — the ring
    plus two file generations bound disk use regardless of run length).
    Writes are line-buffered appends; a failing disk degrades to a
    dropped point, never an exception on the training thread.
    """

    def __init__(self, directory: str, rank: int = 0,
                 max_bytes: Optional[int] = None,
                 basename: str = "obs") -> None:
        self.directory = directory
        self.rank = int(rank)
        self.max_bytes = int(max_bytes) if max_bytes else _env_int(
            "OBS_MAX_BYTES", DEFAULT_MAX_BYTES)
        self.path = os.path.join(directory,
                                 f"{basename}_rank{self.rank}.jsonl")
        self._lock = threading.Lock()
        self._fh = None
        self._written = 0
        self.dropped = 0

    def _open(self):
        os.makedirs(self.directory, exist_ok=True)
        self._fh = open(self.path, "a")
        self._written = self._fh.tell()
        return self._fh

    def write(self, point: Dict[str, Any]) -> bool:
        line = json.dumps(point, default=str) + "\n"
        with self._lock:
            try:
                fh = self._fh or self._open()
                if self._written + len(line) > self.max_bytes \
                        and self._written > 0:
                    fh.close()
                    os.replace(self.path, self.path + ".1")
                    fh = self._open()
                fh.write(line)
                fh.flush()
                self._written += len(line)
                return True
            except OSError:
                self.dropped += 1  # history must never break training
                return False

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_series(directory: str, rank: Optional[int] = None,
                basename: str = "obs") -> List[dict]:
    """Read back the persisted trajectory, rotated generation first so
    points come out in recording order.  ``rank=None`` reads every
    rank's file, points tagged with their source rank and sorted by
    timestamp.  Torn trailing lines (a crash mid-append) are skipped."""
    out: List[dict] = []
    if rank is not None:
        names = [f"{basename}_rank{rank}.jsonl"]
    else:
        try:
            names = sorted(n for n in os.listdir(directory)
                           if n.startswith(basename + "_rank")
                           and n.endswith(".jsonl"))
        except OSError:
            return out
    for name in names:
        path = os.path.join(directory, name)
        try:
            r = int(name[len(basename + "_rank"):-len(".jsonl")])
        except ValueError:
            r = -1
        for p in (path + ".1", path):
            try:
                with open(p) as f:
                    for line in f:
                        try:
                            pt = json.loads(line)
                        except ValueError:
                            continue  # torn tail line
                        pt.setdefault("rank", r)
                        out.append(pt)
            except OSError:
                continue
    if rank is None:
        out.sort(key=lambda p: p.get("ts", 0.0))
    return out


class StepSeriesRecorder:
    """The glue between the step clock and the history layer: ring
    always, JSONL when ``HVD_TPU_OBS_DIR`` is set, sampling every
    ``HVD_TPU_OBS_SAMPLE_EVERY``-th step (default 1)."""

    def __init__(self, rank: Optional[int] = None,
                 directory: Optional[str] = None,
                 ring: Optional[TimeSeriesRing] = None) -> None:
        self.ring = ring or TimeSeriesRing()
        self.sample_every = max(
            1, _env_int("OBS_SAMPLE_EVERY", DEFAULT_SAMPLE_EVERY))
        d = obs_dir() if directory is None else directory
        if rank is None:
            from horovod_tpu_torch.diagnostics.flight_recorder import (
                _best_effort_rank)
            rank = _best_effort_rank()
        self.rank = rank
        self.writer = SeriesWriter(d, rank=rank) if d else None
        self._n = 0

    def record_step(self, step: int, seconds: float,
                    units: float = 0.0, **extra: Any) -> Optional[dict]:
        """Record one completed step; returns the point when it was
        sampled (None when skipped by the sampling stride)."""
        self._n += 1
        if (self._n - 1) % self.sample_every:
            return None
        point = {"ts": round(time.time(), 3), "step": int(step),
                 "step_time_s": round(float(seconds), 6)}
        if units:
            point["units"] = units
            if seconds > 0:
                point["units_per_s"] = round(units / seconds, 3)
        for k, v in extra.items():
            if v is not None:
                point[k] = v
        self.ring.append(point)
        if self.writer is not None:
            self.writer.write(point)
        return point

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


_RECORDER: Optional[StepSeriesRecorder] = None
_RECORDER_LOCK = threading.Lock()


def recorder() -> StepSeriesRecorder:
    """The process-wide step-series recorder (created on first use;
    :func:`reset` rebuilds it — a re-init can change rank and
    ``HVD_TPU_OBS_DIR``)."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = StepSeriesRecorder()
    return _RECORDER


def record_step(step: int, seconds: float, units: float = 0.0,
                **extra: Any) -> None:
    """Module-level convenience for the instrumented call site
    (``StepTimer.end_step``); never raises."""
    try:
        recorder().record_step(step, seconds, units, **extra)
    except Exception:
        pass


def record_point(point: Dict[str, Any]) -> None:
    """Free-form observability point riding the same ring + JSONL store
    as step points — used by the goodput ledger to persist each closed
    window.  Never raises."""
    try:
        r = recorder()
        doc = dict(point)
        doc.setdefault("ts", round(time.time(), 3))
        r.ring.append(doc)
        if r.writer is not None:
            r.writer.write(doc)
    except Exception:
        pass


def reset() -> None:
    """Drop the process-wide recorder so the next use re-reads rank and
    env (re-init, tests)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            _RECORDER.close()
        _RECORDER = None
