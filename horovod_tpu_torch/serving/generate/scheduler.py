"""Slot scheduler: sequences join and leave the static decode batch
only at step boundaries.

A copy of ``horovod_tpu/serving/generate/scheduler.py`` (host code),
with one addition for the port's weight swap: ``admit(hold=True)``
admits nothing and charges the wait to ``swap_pause``, and a request
carries the ``weight_version`` it was admitted under.

The compiled decode step runs over a FIXED array of ``n_slots`` slots;
which sequences occupy them is host-side bookkeeping that changes
between steps, never inside one.  This module owns that bookkeeping:

* a FIFO waiting line fed by the admission queue (the replica's
  :class:`~horovod_tpu_torch.serving.batcher.DynamicBatcher` — bounded,
  explicit 429 sheds, drain semantics);
* admission: a waiting request takes a free slot only when the page
  pool can cover its WORST CASE (``prompt + max_new`` tokens) — a slot
  can be free while pages are scarce, and then the request keeps
  waiting rather than risking a mid-decode out-of-pages;
* prefill chunking: an admitted request's prompt is cut into
  ``prefill_chunk``-token chunks the engine runs one per engine
  iteration, so one long prompt never stalls the live decode batch;
* eviction at finish/deadline/error: the slot and its pages return to
  the pool the same step boundary the sequence leaves.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from horovod_tpu_torch.serving.generate.pages import PagePool

#: GenRequest lifecycle states
WAITING, PREFILL, DECODE, DONE = "waiting", "prefill", "decode", "done"


class GenRequest:
    """One generation request riding through the engine.

    ``tokens`` grows INCREMENTALLY as decode steps emit (callers may
    observe it mid-flight; ``on_token`` fires per emission for true
    streaming consumers); the terminal result/error is delivered
    through the admission queue's :class:`PendingRequest` the replica
    handler blocks on."""

    __slots__ = ("id", "prompt", "max_new", "state", "slot", "pages",
                 "prefill_pos", "tokens", "submitted_at", "admitted_at",
                 "first_token_at", "last_token_at", "prefill_chunks",
                 "decode_steps", "trace", "pending", "on_token",
                 "finish_reason", "wait_mark", "slot_wait_s",
                 "page_wait_s", "prefill_s", "decode_s", "swap_pause_s",
                 "weight_version")

    def __init__(self, req_id: str, prompt, max_new: int,
                 trace=None, on_token=None) -> None:
        self.id = req_id
        self.prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.state = WAITING
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        self.prefill_pos = 0          # prompt tokens already prefilled
        self.tokens: List[int] = []   # emitted tokens, grows per step
        self.submitted_at = time.monotonic()
        self.admitted_at = 0.0
        self.first_token_at = 0.0
        self.last_token_at = 0.0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.trace = trace
        self.pending = None           # admission-queue PendingRequest
        self.on_token = on_token
        self.finish_reason: Optional[str] = None
        # request-ledger stage accounting (docs/OBSERVABILITY.md
        # "Serving request ledger"): waiting time split by WHY the line
        # was blocked (free-slot scarcity vs page-pool scarcity), plus
        # wall seconds inside prefill/decode and weight-swap pauses
        self.wait_mark = self.submitted_at
        self.slot_wait_s = 0.0
        self.page_wait_s = 0.0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.swap_pause_s = 0.0
        # the engine's weight version when the request took its slot:
        # the weights every one of its tokens was decoded with
        self.weight_version: Optional[int] = None

    def stages(self) -> dict:
        """The generate-plane slice of this request's stage ledger."""
        return {"slot_wait": self.slot_wait_s,
                "page_wait": self.page_wait_s,
                "prefill": self.prefill_s,
                "decode": self.decode_s,
                "swap_pause": self.swap_pause_s}

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def worst_case_tokens(self) -> int:
        return self.prompt_len + self.max_new

    def emit(self, token: int, now: float) -> None:
        self.tokens.append(int(token))
        if not self.first_token_at:
            self.first_token_at = now
        self.last_token_at = now
        if self.on_token is not None:
            try:
                self.on_token(int(token))
            except Exception:
                pass  # a slow/broken stream consumer must not stall decode


class SlotScheduler:
    """Admission order, eviction, and prefill chunking over the static
    slot array.  Thread-safe; every mutation happens at an engine step
    boundary (the engine loop is the only caller of admit/evict)."""

    def __init__(self, n_slots: int, pool: PagePool,
                 prefill_chunk: int, max_ctx: int) -> None:
        assert n_slots >= 1 and prefill_chunk >= 1
        self.n_slots = int(n_slots)
        self.pool = pool
        self.prefill_chunk = int(prefill_chunk)
        self.max_ctx = int(max_ctx)
        self._lock = threading.Lock()
        self._waiting: Deque[GenRequest] = deque()
        self.slots: List[Optional[GenRequest]] = [None] * self.n_slots
        # what blocked the LAST admission pass: "slot" (no free slot)
        # or "page" (pool can't cover the head's worst case) — the
        # request ledger charges waiting time since that pass to the
        # matching stage (slot_wait vs page_wait), which is exactly the
        # discrimination the kv_thrash detector runs on
        self._block_cause: Optional[str] = None

    # -- intake -------------------------------------------------------------
    def add_waiting(self, req: GenRequest) -> None:
        with self._lock:
            self._waiting.append(req)

    def waiting_count(self) -> int:
        with self._lock:
            return len(self._waiting)

    # -- admission ----------------------------------------------------------
    def admit(self, hold: bool = False) -> List[GenRequest]:
        """Move waiting requests into free slots, FIFO, page-gated.
        The head of the line blocks the line: skipping a big request to
        admit a later small one would starve it forever under load.
        ``hold`` admits nothing (a weight swap waits for the live
        sequences to leave; the wait is charged to ``swap_pause``).
        Returns the newly admitted requests (state=PREFILL, pages
        allocated, slot assigned)."""
        admitted: List[GenRequest] = []
        now = time.monotonic()
        with self._lock:
            # settle waiting time accrued since the previous pass under
            # the cause that blocked it (default: slot — queue transit
            # before the first classification is batch-join wait)
            cause = self._block_cause
            for r in self._waiting:
                dt = max(0.0, now - r.wait_mark)
                r.wait_mark = now
                if cause == "page":
                    r.page_wait_s += dt
                elif cause == "swap":
                    r.swap_pause_s += dt
                else:
                    r.slot_wait_s += dt
            self._block_cause = "swap" if hold else None
            while self._waiting and not hold:
                free = [i for i, r in enumerate(self.slots) if r is None]
                if not free:
                    self._block_cause = "slot"
                    break
                req = self._waiting[0]
                pages = self.pool.alloc(
                    self.pool.plan.pages_for(req.worst_case_tokens))
                if pages is None:
                    # pool can't cover the head yet; keep FIFO
                    self._block_cause = "page"
                    break
                self._waiting.popleft()
                req.slot = free[0]
                req.pages = pages
                req.state = PREFILL
                req.admitted_at = now
                self.slots[free[0]] = req
                admitted.append(req)
        return admitted

    # -- prefill chunking ---------------------------------------------------
    def next_prefill_chunk(self, req: GenRequest) \
            -> Optional[Tuple[int, int]]:
        """The next (start, length) chunk of ``req``'s prompt still to
        prefill, or None when prefill is complete.  Chunks are at most
        ``prefill_chunk`` tokens; the engine runs ONE per iteration per
        sequence so prefill interleaves with live decode steps."""
        if req.prefill_pos >= req.prompt_len:
            return None
        start = req.prefill_pos
        return start, min(self.prefill_chunk, req.prompt_len - start)

    def chunks_for(self, prompt_len: int) -> int:
        return max(1, -(-int(prompt_len) // self.prefill_chunk))

    # -- views --------------------------------------------------------------
    def prefilling(self) -> List[GenRequest]:
        with self._lock:
            return [r for r in self.slots
                    if r is not None and r.state == PREFILL]

    def decoding(self) -> List[GenRequest]:
        with self._lock:
            return [r for r in self.slots
                    if r is not None and r.state == DECODE]

    def occupied(self) -> int:
        with self._lock:
            return sum(r is not None for r in self.slots)

    def busy(self) -> bool:
        with self._lock:
            return bool(self._waiting) or \
                any(r is not None for r in self.slots)

    # -- eviction -----------------------------------------------------------
    def evict(self, req: GenRequest, reason: str) -> None:
        """Return the slot and pages at a step boundary; terminal state
        delivery (set_result/set_error) is the engine's job."""
        with self._lock:
            if req.slot is not None \
                    and self.slots[req.slot] is req:
                self.slots[req.slot] = None
            req.state = DONE
            req.finish_reason = reason
            pages, req.pages = req.pages, []
        self.pool.free(pages)

    def drop_waiting(self, req: GenRequest) -> bool:
        """Remove a never-admitted request (deadline expired while
        waiting).  True when it was still in the line."""
        with self._lock:
            try:
                self._waiting.remove(req)
                return True
            except ValueError:
                return False
