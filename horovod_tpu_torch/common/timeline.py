"""Chrome-tracing timeline for the host control plane.

A copy of ``horovod_tpu/common/timeline.py`` (reference:
``horovod/common/timeline.{h,cc}`` — a queue feeding a dedicated writer
thread, producing chrome://tracing JSON; activity names in
``horovod/common/common.h:73-105``; dynamic start/stop through
``start_timeline``/``stop_timeline``). Device-side profiling is
``torch.profiler``'s (:mod:`horovod_tpu_torch.profiling`).

Rank 0 writes ``HVD_TPU_TIMELINE``; with ``HVD_TPU_TIMELINE_ALL_RANKS``
every rank writes a shard (:func:`shard_path`) that opens with a
``SHARD_META`` wall-clock anchor, merged by
:mod:`horovod_tpu_torch.diagnostics.merge`. A shard holds its metadata,
its anchor and the instants the program marks (:meth:`Timeline.instant`);
the JAX package's per-collective spans (``collective_begin``/
``collective_end``) and its negotiation activities come with the eager
collective core (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import List, Optional

def shard_path(base: str, rank: int) -> str:
    """Per-rank shard path for timeline base ``base``
    (``HVD_TPU_TIMELINE``): ``<dir>/timeline.rank<r>.json`` when base is
    a directory, else ``<base>.rank<r>.json`` next to the rank-0 file —
    a distinct path, so two writers never interleave."""
    if base.endswith(os.sep) or os.path.isdir(base):
        return os.path.join(base, f"timeline.rank{rank}.json")
    return f"{base}.rank{rank}.json"


def shard_paths_for(base: str) -> List[str]:
    """Existing shard files for ``base`` (merger/autopsy discovery)."""
    if base.endswith(os.sep) or os.path.isdir(base):
        from horovod_tpu_torch.diagnostics.merge import find_shards
        return find_shards(base)
    import glob
    return sorted(glob.glob(f"{base}.rank*.json"))


class Timeline:
    """Asynchronous chrome-tracing writer.

    Events are enqueued from hot paths and serialized by a writer thread
    (mirrors the reference's SPSC-queue + writer-thread design,
    ``timeline.h:84-86``). Only the coordinator (rank 0) writes a file by
    default, matching ``operations.cc:459-475``.
    """

    def __init__(self, rank: int, file_path: str = "") -> None:
        self._rank = rank
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._file = None
        self._started = False
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._mark_cycles = False
        if file_path:
            self.start(file_path)

    # -- lifecycle ---------------------------------------------------------
    def start(self, file_path: str, mark_cycles: bool = False,
              force: bool = False, meta: Optional[dict] = None) -> None:
        """``force=True`` opens a file on ANY rank (per-rank shard mode,
        ``HVD_TPU_TIMELINE_ALL_RANKS``); ``meta`` args are embedded as
        the shard's leading ``SHARD_META`` event with a wall-clock
        anchor so the merger can align shards across hosts."""
        with self._lock:
            if self._started:
                return
            self._mark_cycles = mark_cycles
            if self._rank != 0 and not force:
                # Workers keep timeline state but only rank 0 writes a file
                # (reference: coordinator-only file, operations.cc:459-475).
                self._started = True
                return
            try:
                self._file = open(file_path, "w")
            except OSError:
                return
            # fresh queue per generation: a writer thread that outlived a
            # timed-out stop() keeps its OLD queue/file and can never
            # steal (or corrupt) this generation's events
            self._q = queue.Queue()
            self._file.write("[\n")
            if meta is not None:
                # wall + monotonic sampled back-to-back: the merger maps
                # event ts onto the wall clock via this anchor pair
                wall, mono = time.time(), time.monotonic()
                self._file.write(json.dumps({
                    "ph": "i", "name": "SHARD_META", "pid": self._rank,
                    "tid": "meta", "ts": (mono - self._t0) * 1e6,
                    "s": "g",
                    "args": {"epoch_us": wall * 1e6, **meta},
                }) + ",\n")
                # on disk at once: an autopsy may merge this shard before
                # its first event reaches the writer
                self._file.flush()
            self._thread = threading.Thread(
                target=self._writer_loop, args=(self._q, self._file),
                name="hvd-tpu-timeline", daemon=True)
            self._thread.start()
            self._started = True

    def stop(self) -> None:
        # Phase 1 (under the lock): flip _started so no new emission can
        # begin, and detach the writer thread handle. The join happens
        # OUTSIDE the lock — _emit now serializes on the same lock, and a
        # join while holding it would deadlock an emitter waiting to bail.
        with self._lock:
            if not self._started:
                return
            self._started = False
            thread, self._thread = self._thread, None
        if thread is not None:
            self._q.put(None)
            thread.join(timeout=5)
        # Phase 2: drain stragglers that slipped in before _started
        # flipped — the old stop/emit race dropped those events silently
        # with the file already closed. Only safe once the writer has
        # actually exited: draining concurrently with a writer that
        # outlived the join would interleave writes into the same file
        # and could swallow its shutdown sentinel.
        with self._lock:
            if self._file is not None:
                try:
                    if thread is None or not thread.is_alive():
                        while True:
                            try:
                                ev = self._q.get_nowait()
                            except queue.Empty:
                                break
                            if ev is not None:
                                self._file.write(json.dumps(ev) + ",\n")
                        self._file.write("{}]\n")
                    self._file.close()
                except (OSError, ValueError):
                    pass
                self._file = None

    def start_shard(self, path: str, wall_offset_s: float = 0.0,
                    mark_cycles: bool = False) -> None:
        """Open a per-rank shard at ``path`` (any rank) with merge
        metadata: this rank, ``source=host`` and the estimated wall
        offset to the coordinator
        (:mod:`horovod_tpu_torch.diagnostics.clock`)."""
        self.start(path, mark_cycles=mark_cycles, force=True,
                   meta={"rank": self._rank, "source": "host",
                         "wall_offset_us": wall_offset_s * 1e6})

    def flush(self, timeout: float = 1.0) -> None:
        """Best-effort: let the writer drain so an autopsy reading the
        shard file mid-run sees the recent events (the writer flushes
        per event; truncated tails are repaired by the merger)."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def close(self) -> None:
        self.stop()

    @property
    def enabled(self) -> bool:
        return self._started

    # -- event emission ----------------------------------------------------
    def _emit(self, ph: str, name: str, cat: str, tid: str,
              args: Optional[dict] = None) -> None:
        # cheap unguarded pre-check keeps the disabled path lock-free...
        if not self._started or self._file is None:
            return
        ev = {"ph": ph, "name": name, "cat": cat, "pid": self._rank,
              "tid": tid, "ts": (time.monotonic() - self._t0) * 1e6}
        if args:
            ev["args"] = args
        # ...but enqueueing re-checks under the lock: stop() flips
        # _started under the same lock before draining, so an event that
        # makes it into the queue here is guaranteed to be written (either
        # by the writer thread or by stop()'s drain), never dropped into a
        # closed file.
        with self._lock:
            if not self._started or self._file is None:
                return
            self._q.put(ev)

    def mark_cycle(self) -> None:
        """Cycle tick marker (reference: HOROVOD_TIMELINE_MARK_CYCLES)."""
        if self._mark_cycles:
            self._emit("i", "CYCLE_START", "cycle", "cycle")

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        self._emit("i", name, "marker", "marker", args)

    # -- writer thread -----------------------------------------------------
    def _writer_loop(self, q: "queue.Queue[Optional[dict]]", file) -> None:
        # q/file are bound at thread start: a writer leaked past stop()'s
        # join timeout must keep writing ITS generation, never a new one
        while True:
            ev = q.get()
            if ev is None:
                return
            try:
                file.write(json.dumps(ev) + ",\n")
                # flush on drain, not per event (same policy as the reference's
                # writer): batches syscalls when a high-rate trace backs
                # the queue up, while an idle — or hung — shard still
                # has a fresh tail on disk for the autopsy
                if q.empty():
                    file.flush()
            except (OSError, ValueError):
                return
