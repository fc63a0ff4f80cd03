"""Data loading helpers.

Mirrors ``horovod_tpu/data/data_loader.py``. Reference:
``horovod/data/data_loader_base.py`` (``BaseDataLoader`` and
``AsyncDataLoaderMixin`` — a background-thread prefetch queue, :23-151).
Additions: :class:`ShardedDataset` for per-worker sharding (the reference
leaves sharding to torch's DistributedSampler; the shuffle is numpy's
``RandomState(seed + epoch)``, so a rank sees the JAX package's order) and
:func:`device_prefetch`, host→card transfer on a side stream overlapped
with compute.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.tree import tree_flatten


class BaseDataLoader:
    """Iteration contract (reference: ``BaseDataLoader:23-60``)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self._iterate()


class AsyncDataLoaderMixin:
    """Background-thread prefetch (reference: ``AsyncDataLoaderMixin:63-151``).

    Mix in FIRST: ``class MyAsyncLoader(AsyncDataLoaderMixin, MyLoader)``.
    ``async_loader_queue_size=0`` disables prefetch (synchronous).
    """

    def __init__(self, *args: Any, async_loader_queue_size: int = 64,
                 **kwargs: Any) -> None:
        self._queue_size = async_loader_queue_size
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        super().__init__(*args, **kwargs)

    def close_async_loader(self) -> None:
        """Reference: ``close_async_loader`` — drain and join."""
        self._closing = True
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    class _End:
        def __init__(self, error=None):
            self.error = error

    def _put(self, item) -> bool:
        """Bounded put that aborts when the loader is closing (so the
        producer can never wedge in a full queue)."""
        while not self._closing:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        error = None
        try:
            for item in super()._iterate():
                if not self._put(item):
                    return
        except BaseException as e:  # surface loader errors to the consumer
            error = e
        self._put(self._End(error))

    def __iter__(self) -> Iterator[Any]:
        if self._queue_size <= 0:
            yield from super()._iterate()
            return
        self._closing = False
        self._q = queue.Queue(self._queue_size)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if isinstance(item, AsyncDataLoaderMixin._End):
                if item.error is not None:
                    raise item.error
                break
            yield item


def device_prefetch(iterator, buffer_size: int = 2, device=None):
    """Keep ``buffer_size`` batches RESIDENT ON THE CARD ahead of the
    consumer (double-buffered by default): each batch's tensors (or numpy
    arrays) are staged in pinned host memory and copied ``non_blocking`` on
    a side CUDA stream, so the host→card transfer of the next batches
    overlaps the compute consuming the current one. A batch is handed out
    after the consumer's current stream has been made to wait on its
    copies' event, and each of its tensors is marked used on that stream
    (``record_stream``), so the caching allocator cannot give its memory
    to another tensor while the consumer's kernels may still read it.

    Works on any iterator of nested dicts, lists and tuples; stack with
    :class:`AsyncDataLoaderMixin` so the host side (decode/augment) is off
    the critical path too. A rank's batch is its own, as ``shard_batch``
    gives it (there is no ``sharding=``). ``device=None`` is this
    process's card and raises without one; ``device="cpu"`` hands the
    batches out as CPU tensors, in the same order.

    If the source iterator raises mid-stream, batches already transferred
    are yielded first; the error surfaces at its true position in the
    stream. The returned iterator's ``buffered`` is the number of batches
    transferred and not yet handed out: what a dataset's cursor is ahead
    of the consumer."""
    if buffer_size < 1:
        # eager: a generator would defer this to the first next() deep
        # inside the training loop, far from the misconfigured call
        raise ValueError(f"buffer_size={buffer_size} must be >= 1")
    return _DevicePrefetch(iter(iterator), buffer_size, resolve_device(device))


class _DevicePrefetch:
    """The iterator :func:`device_prefetch` returns."""

    def __init__(self, it, buffer_size: int, device: torch.device) -> None:
        self._it = it
        self._device = device
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self._q: "collections.deque" = collections.deque()
        self._pending_error: Optional[BaseException] = None
        self._started = False
        self._buffer_size = buffer_size

    @property
    def buffered(self) -> int:
        return len(self._q)

    def __iter__(self):
        return self

    def _place(self, batch):
        leaves, unflatten = tree_flatten(batch)
        host = [torch.as_tensor(x) for x in leaves]
        for t in host:
            if t.device.type != "cpu":
                raise ValueError(f"device_prefetch takes host batches; a "
                                 f"leaf is on {t.device}")
        if self._stream is None:
            return unflatten(host), None
        # pinned staging copies; the host allocator keeps each from reuse
        # until the copy out of it has run
        host = [t if t.is_pinned() else t.pin_memory() for t in host]
        with torch.cuda.stream(self._stream):
            out = [t.to(self._device, non_blocking=True) for t in host]
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return unflatten(out), ready

    def _put_next(self) -> bool:
        if self._pending_error is not None:
            return False
        try:
            batch = next(self._it)
        except StopIteration:
            return False
        except BaseException as e:
            # drain the already-transferred batches before surfacing it
            self._pending_error = e
            return False
        self._q.append(self._place(batch))
        return True

    def __next__(self):
        if not self._started:
            self._started = True
            for _ in range(self._buffer_size):
                if not self._put_next():
                    break
        if not self._q:
            if self._pending_error is not None:
                err, self._pending_error = self._pending_error, None
                raise err
            raise StopIteration
        out, ready = self._q.popleft()
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in tree_flatten(out)[0]:
                t.record_stream(consumer)
        self._put_next()  # enqueue the NEXT transfer before handing this out
        return out


class ShardedDataset(BaseDataLoader):
    """Deterministic per-worker shard of an indexable dataset: worker r of n
    sees items ``r, r+n, r+2n, ...`` after an epoch-seeded shuffle — the
    sharding contract of torch's DistributedSampler that reference users
    pair with hvd (``torch/elastic/sampler.py`` is its elastic variant)."""

    def __init__(self, data: Sequence[Any], rank: int, size: int,
                 shuffle: bool = True, seed: int = 0) -> None:
        self._data = data
        self._rank = rank
        self._size = max(size, 1)
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._cursor = 0  # items this worker yielded in the current epoch
        self._resume_skip = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (reference: ``ElasticSampler.set_epoch``).
        Re-announcing the CURRENT epoch keeps the restored cursor — the
        standard resume loop (``load_state_dict`` then ``set_epoch``
        inside the epoch loop) must not replay committed items."""
        if epoch != self._epoch:
            self._cursor = 0
            self._resume_skip = 0
        self._epoch = epoch

    def state_dict(self) -> dict:
        """Checkpointable data position: ``{"epoch", "cursor"}`` —
        ``cursor`` counts the items THIS worker has yielded in the
        current epoch, so data position rides the same commit as model
        state (reference analog: ``ElasticSampler.state_dict``).  With a
        prefetching wrapper the cursor counts items handed to the
        prefetcher, which can run a few batches ahead of the consumer —
        commit ordering, not a correctness issue: behind
        :func:`device_prefetch`, the consumer's position is ``cursor``
        less the prefetcher's ``buffered``."""
        return {"epoch": self._epoch, "cursor": self._cursor}

    def load_state_dict(self, state: dict) -> None:
        """Resume mid-epoch: the next iteration replays the epoch's
        deterministic order and skips the first ``cursor`` items.  The
        cursor is per-worker: after an elastic world-size change start
        from the next epoch boundary instead (the shard stride changed,
        so mid-epoch positions don't map)."""
        self._epoch = int(state["epoch"])
        self._cursor = int(state.get("cursor", 0))
        self._resume_skip = self._cursor

    def __len__(self) -> int:
        return len(self._data) // self._size

    def _iterate(self) -> Iterator[Any]:
        idx = np.arange(len(self._data))
        if self._shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(idx)
        n = len(self) * self._size  # drop remainder so all workers agree
        skip, self._resume_skip = self._resume_skip, 0
        self._cursor = skip
        for pos, i in enumerate(idx[self._rank:n:self._size]):
            if pos < skip:
                continue
            self._cursor = pos + 1
            yield self._data[int(i)]
        # a completed epoch resets the position (an abandoned iterator —
        # e.g. a mid-epoch checkpoint + crash — keeps its cursor)
        self._cursor = 0
