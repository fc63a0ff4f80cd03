"""Paged KV-cache pool: byte-budgeted pages for the generative engine.

A copy of ``horovod_tpu/serving/generate/pages.py`` with the same
arithmetic; the itemsize comes from a torch dtype.

The decode engine never materializes one monolithic ``[slot, max_seq]``
KV tensor per sequence.  Instead the cache is a POOL of fixed-size
pages — block-granular chunks of ``page_tokens`` tokens each — and
every slot owns an ordered page table mapping its token positions onto
pool pages.  Sizing transplants the gradient-bucket idiom from
:mod:`horovod_tpu_torch.train.buckets`: the page byte budget resolves
explicit-arg > ``HVD_TPU_KV_PAGE_BYTES`` > a floor derived from the
engine's fusion threshold (the same "one unit of memory traffic"
number the bucket planner falls back to, capped so a page stays a
block, not a buffer), and the plan is pure metadata cached per model
fingerprint (layers/width/dtype/slots/context — an
``functools.lru_cache`` exactly like ``_plan_cached``).

The pool itself is host-side bookkeeping only (a free list + per-slot
ownership); the actual page ARRAYS live in the engine as fixed-shape
device tensors ``[L, total_pages+1, page_tokens, kv_width]`` — the +1 row
is the scratch page inactive slots write into so membership churn
never changes the compiled shape.  Allocation happens ONLY at
decode-step boundaries (admission/eviction), so the compiled decode
step sees a constant-shape page table every call.
"""

from __future__ import annotations

import functools
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from horovod_tpu_torch.common.config import env_int
from horovod_tpu_torch import chaos

#: cap on the fusion-threshold fallback: a KV page is a block (tokens of
#: one sequence), not a 64 MiB comm buffer
DEFAULT_PAGE_BYTES_CAP = 64 * 1024


def resolve_page_bytes(page_bytes: Optional[int] = None) -> int:
    """Effective page byte budget: explicit argument >
    ``HVD_TPU_KV_PAGE_BYTES`` > the bucket planner's fallback chain
    (``resolve_bucket_bytes``) capped at :data:`DEFAULT_PAGE_BYTES_CAP`."""
    if page_bytes is not None:
        return max(1, int(page_bytes))
    env = env_int("KV_PAGE_BYTES", 0)
    if env > 0:
        return env
    from horovod_tpu_torch.train.buckets import resolve_bucket_bytes
    return max(1, min(resolve_bucket_bytes(), DEFAULT_PAGE_BYTES_CAP))


class KVPagePlan(NamedTuple):
    """One model's paged-cache geometry (pure metadata, no arrays).

    ``page_tokens`` tokens fit one page under the byte budget (a page
    holds K AND V for every layer at those positions — the whole
    per-token cache footprint, so "pages in use" is directly a byte
    number).  ``pages_per_slot`` covers ``max_ctx`` tokens;
    ``total_pages`` is the shared pool capacity (scratch row NOT
    included)."""

    page_tokens: int
    pages_per_slot: int
    total_pages: int
    page_bytes: int       # actual bytes one page holds (≤ the budget)
    token_bytes: int      # K+V bytes per token across all layers
    total_bytes: int

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache positions."""
        return max(1, -(-int(tokens) // self.page_tokens))

    @property
    def slot_tokens(self) -> int:
        """Token capacity of one slot's full page table."""
        return self.pages_per_slot * self.page_tokens


@functools.lru_cache(maxsize=64)
def _plan_cached(n_layers: int, kv_width: int, itemsize: int,
                 slots: int, max_ctx: int, budget: int) -> KVPagePlan:
    token_bytes = 2 * n_layers * kv_width * itemsize  # K and V
    page_tokens = max(1, budget // token_bytes)
    pages_per_slot = max(1, -(-max_ctx // page_tokens))
    total_pages = slots * pages_per_slot
    return KVPagePlan(
        page_tokens=page_tokens,
        pages_per_slot=pages_per_slot,
        total_pages=total_pages,
        page_bytes=page_tokens * token_bytes,
        token_bytes=token_bytes,
        total_bytes=total_pages * page_tokens * token_bytes,
    )


def plan_kv_pages(n_layers: int, kv_width: int, dtype,
                  slots: int, max_ctx: int,
                  page_bytes: Optional[int] = None) -> KVPagePlan:
    """Plan the paged pool for a model fingerprint.

    ``kv_width`` is the per-token K (= V) feature width
    (``n_heads * head_dim``).  Cached per fingerprint — the same model
    served again reuses the plan object, and the gauges below always
    describe the ACTIVE plan."""
    plan = _plan_cached(int(n_layers), int(kv_width),
                        _itemsize(dtype), int(slots),
                        int(max_ctx), resolve_page_bytes(page_bytes))
    record_plan(plan)
    return plan


def _itemsize(dtype) -> int:
    """Bytes of one element of a torch dtype (numpy dtypes too)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


def record_plan(plan: KVPagePlan) -> None:
    from horovod_tpu_torch.serving import metrics as smetrics
    smetrics.set_kv_pool(in_use=0, total=plan.total_pages,
                         page_bytes=plan.page_bytes)


class PagePool:
    """Host-side page allocator over ``plan.total_pages`` page ids.

    Thread-safe; allocation is all-or-nothing (a request either gets
    every page its worst case needs at admission, or waits — the engine
    never hits a mid-decode out-of-pages).  Page ids are handed out
    lowest-first so freshly started pools allocate contiguously; the
    ``fragmentation`` stat reports how broken-up the free set has
    become (0 = one contiguous free run)."""

    def __init__(self, plan: KVPagePlan) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        # pop() hands out the lowest id first
        self._free = list(range(plan.total_pages - 1, -1, -1))
        self._high_water = 0

    # -- allocation ---------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` page ids, or None when the pool cannot cover it (the
        caller keeps the request WAITING — never a partial grant)."""
        if n <= 0:
            return []
        # the chaos seam ``serving.kv`` (horovod_tpu/serving/generate/
        # pages.py:138-146): a ``starve`` fault refuses the grant
        if any(kind == "starve" for _, kind in chaos.fire("serving.kv")):
            return None
        with self._lock:
            if n > len(self._free):
                return None
            pages = [self._free.pop() for _ in range(n)]
            self._high_water = max(self._high_water, self.in_use)
        self._publish()
        return pages

    def free(self, pages: List[int]) -> None:
        if not pages:
            return
        with self._lock:
            self._free.extend(pages)
            # keep low-first hand-out after churn
            self._free.sort(reverse=True)
        self._publish()

    # -- accounting ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.plan.total_pages

    @property
    def in_use(self) -> int:
        return self.plan.total_pages - len(self._free)

    @property
    def high_water(self) -> int:
        with self._lock:
            return max(self._high_water, self.in_use)

    def fragmentation(self) -> float:
        """1 − (largest contiguous free run / free pages): 0 when the
        free set is one run (or empty), → 1 as churn shreds it."""
        with self._lock:
            free = sorted(self._free)
        if not free:
            return 0.0
        longest = run = 1
        for a, b in zip(free, free[1:]):
            run = run + 1 if b == a + 1 else 1
            longest = max(longest, run)
        return 1.0 - longest / len(free)

    def stats(self) -> dict:
        return {"capacity": self.capacity, "in_use": self.in_use,
                "high_water": self.high_water,
                "fragmentation": round(self.fragmentation(), 4),
                "page_tokens": self.plan.page_tokens,
                "page_bytes": self.plan.page_bytes}

    def _publish(self) -> None:
        from horovod_tpu_torch.serving import metrics as smetrics
        smetrics.set_kv_pool(in_use=self.in_use, total=self.capacity,
                             page_bytes=self.plan.page_bytes)
