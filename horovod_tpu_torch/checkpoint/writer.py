"""Background checkpoint writer: one serializing thread per store.

A copy of ``horovod_tpu/checkpoint/writer.py``, with
:meth:`AsyncWriter.wait_for_slot` added.

The device→host snapshot (the consistent cut) is queued inline on the
caller's thread; everything that touches the filesystem — npz
serialization, fsync, the rank-0 commit wait — runs here so the train
loop never blocks on disk.  A bounded inflight cap provides backpressure
when saves outrun storage: ``submit`` blocks once ``max_inflight``
snapshots are queued or being written. The store waits for a free slot
(:meth:`AsyncWriter.wait_for_slot`) before it takes the next snapshot, so
host memory holds at most ``max_inflight`` copies of the state.

One thread (not a pool) on purpose: jobs for steps N and N+1 must hit
the two-phase commit protocol in order, and a single queue gives that
for free.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional


class AsyncWriter:
    def __init__(self, max_inflight: int = 2,
                 on_inflight: Optional[Callable[[int], None]] = None,
                 name: str = "hvd-ckpt-writer") -> None:
        self._cap = max(1, int(max_inflight))
        self._jobs: "deque[Callable[[], None]]" = deque()
        self._cond = threading.Condition()
        self._busy = False
        self._error: Optional[BaseException] = None
        self._closed = False
        self._running = False  # worker loop alive; guarded by _cond
        self._name = name
        self._on_inflight = on_inflight

    def _inflight_locked(self) -> int:
        return len(self._jobs) + (1 if self._busy else 0)

    def _notify_inflight(self, n: int) -> None:
        if self._on_inflight is not None:
            try:
                self._on_inflight(n)
            except Exception:
                pass  # a metrics hiccup must never fail a checkpoint

    def _raise_pending_locked(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue; blocks while the inflight cap is reached.  Re-raises
        the first error of any PREVIOUS job (an async failure surfaces
        at the next save/wait, never silently)."""
        with self._cond:
            self._raise_pending_locked()
            if self._closed:
                raise RuntimeError("writer is closed")
            while self._inflight_locked() >= self._cap:
                self._cond.wait()
                self._raise_pending_locked()
            self._jobs.append(job)
            n = self._inflight_locked()
            spawn = not self._running
            if spawn:
                # flagged under the SAME lock the worker uses to decide
                # exit, so a drained thread can never strand a fresh job
                self._running = True
            self._cond.notify_all()
        self._notify_inflight(n)
        if spawn:
            threading.Thread(target=self._run, name=self._name,
                             daemon=True).start()

    def wait_for_slot(self) -> None:
        """Block until a job can be queued without waiting (fewer than
        ``max_inflight`` queued or being written); re-raises a previous
        job's error as :meth:`submit` does."""
        with self._cond:
            self._raise_pending_locked()
            if self._closed:
                raise RuntimeError("writer is closed")
            while self._inflight_locked() >= self._cap:
                self._cond.wait()
                self._raise_pending_locked()

    def check(self) -> None:
        """Re-raise (and clear) a pending async error WITHOUT blocking —
        lets callers attribute a failure to the save that caused it
        before submitting the next one."""
        with self._cond:
            self._raise_pending_locked()

    def wait(self) -> None:
        """Block until everything queued has been written; re-raise any
        async error."""
        with self._cond:
            while self._inflight_locked() > 0:
                self._cond.wait()
            self._raise_pending_locked()

    def close(self, wait: bool = True) -> None:
        if wait:
            self.wait()
        with self._cond:
            self._closed = True
            self._jobs.clear()
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._jobs or self._closed:
                    self._running = False
                    return
                job = self._jobs.popleft()
                self._busy = True
            try:
                # the JAX writer fires the chaos seam "checkpoint.write"
                # here (io_error, slow_fsync); it arrives with the chaos
                # harness (ROADMAP queue 1 item 7)
                job()
            except BaseException as e:  # held for the next submit/wait
                with self._cond:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    n = self._inflight_locked()
                    self._cond.notify_all()
                self._notify_inflight(n)
