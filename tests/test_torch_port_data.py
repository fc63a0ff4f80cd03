"""The port's data loading against the JAX package's, on the CPU:
``ShardedDataset`` gives each rank the JAX order of items for every
(rank, size, seed, epoch) tried, resumes from its cursor and resets it at
an epoch boundary (``tests/test_checkpoint_store.py``'s data-position
tests), ``AsyncDataLoaderMixin`` prefetches on a thread, and
``device_prefetch`` keeps its buffer bounded, says how far the cursor is
ahead of the consumer, and raises a source's error at its position in
the stream after the batches already transferred
(``tests/test_parity_tail.py``'s)."""

import numpy as np
import pytest
import torch

from horovod_tpu.data import ShardedDataset as JaxShardedDataset
from horovod_tpu_torch.data import (AsyncDataLoaderMixin, BaseDataLoader,
                                    ShardedDataset, device_prefetch)


@pytest.mark.parametrize("rank,size,seed,epoch,shuffle", [
    (0, 1, 0, 0, True), (1, 4, 7, 2, True), (3, 4, 7, 0, True),
    (2, 3, 123, 5, True), (1, 2, 0, 1, False)])
def test_order_equals_jax(rank, size, seed, epoch, shuffle):
    data = list(range(103))
    ours = ShardedDataset(data, rank, size, shuffle=shuffle, seed=seed)
    theirs = JaxShardedDataset(data, rank, size, shuffle=shuffle, seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    assert list(ours) == list(theirs)
    assert len(ours) == len(theirs) == 103 // size


def test_partition_is_disjoint_and_deterministic():
    data = list(range(103))
    seen = []
    for r in range(4):
        ds = ShardedDataset(data, rank=r, size=4, shuffle=True, seed=7)
        items = list(ds)
        assert len(items) == len(ds) == 103 // 4
        seen.extend(items)
    assert len(seen) == len(set(seen))
    ds = ShardedDataset(data, rank=1, size=4, shuffle=True, seed=7)
    a = list(ds)
    ds.set_epoch(0)
    assert list(ds) == a
    ds.set_epoch(1)
    assert list(ds) != a


def test_state_dict_resume():
    data = list(range(32))
    ds = ShardedDataset(data, rank=1, size=4, shuffle=True, seed=7)
    ds.set_epoch(2)
    full = list(ds)
    assert len(full) == 8

    ds2 = ShardedDataset(data, rank=1, size=4, shuffle=True, seed=7)
    ds2.set_epoch(2)
    it = iter(ds2)
    consumed = [next(it) for _ in range(3)]
    sd = ds2.state_dict()
    assert sd == {"epoch": 2, "cursor": 3}

    ds3 = ShardedDataset(data, rank=1, size=4, shuffle=True, seed=7)
    ds3.load_state_dict(sd)
    rest = list(ds3)
    assert consumed + rest == full

    # the standard resume loop re-announces the current epoch before
    # iterating — that keeps the restored cursor
    ds4 = ShardedDataset(data, rank=1, size=4, shuffle=True, seed=7)
    ds4.load_state_dict(sd)
    ds4.set_epoch(sd["epoch"])
    assert list(ds4) == rest
    ds4.set_epoch(sd["epoch"] + 1)
    assert len(list(ds4)) == 8


def test_cursor_resets_after_full_epoch():
    ds = ShardedDataset(list(range(16)), rank=0, size=2, shuffle=False)
    first = list(ds)
    assert ds.state_dict() == {"epoch": 0, "cursor": 0}
    assert list(ds) == first


def test_async_loader_prefetch():
    class Loader(BaseDataLoader):
        def __len__(self):
            return 10

        def _iterate(self):
            yield from range(10)

    class AsyncLoader(AsyncDataLoaderMixin, Loader):
        pass

    loader = AsyncLoader(async_loader_queue_size=4)
    assert list(loader) == list(range(10))
    assert list(loader) == list(range(10))  # reusable
    loader.close_async_loader()
    assert list(AsyncLoader(async_loader_queue_size=0)) == list(range(10))


def test_device_prefetch_order_bound_and_cursor():
    batches = [np.full((8, 4), i, np.float32) for i in range(6)]
    got = list(device_prefetch(iter(batches), device="cpu"))
    assert len(got) == 6
    for i, b in enumerate(got):
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(b.numpy(), batches[i])

    ds = ShardedDataset([{"x": np.ones(2) * i} for i in range(8)],
                        rank=0, size=2, shuffle=False)
    out = list(device_prefetch(ds, buffer_size=3, device="cpu"))
    assert [float(b["x"][0]) for b in out] == [0.0, 2.0, 4.0, 6.0]

    pulled = []

    def counting():
        for i in range(10):
            pulled.append(i)
            yield np.float32(i)

    gen = device_prefetch(counting(), buffer_size=2, device="cpu")
    for n_consumed, _ in enumerate(gen, start=1):
        assert len(pulled) <= n_consumed + 2, (len(pulled), n_consumed)
    assert len(pulled) == 10

    # the dataset's cursor less the buffer is the consumer's position,
    # and resuming there replays the batches the consumer never took
    ds = ShardedDataset(list(range(20)), rank=0, size=1, seed=3)
    pf = device_prefetch(ds, buffer_size=3, device="cpu")
    taken = [int(next(pf)) for _ in range(5)]
    assert pf.buffered == 3
    pos = dict(ds.state_dict(), cursor=ds.state_dict()["cursor"]
               - pf.buffered)
    assert pos["cursor"] == 5
    again = ShardedDataset(list(range(20)), rank=0, size=1, seed=3)
    again.load_state_dict(pos)
    full = list(ShardedDataset(list(range(20)), rank=0, size=1, seed=3))
    assert taken + list(again) == full

    with pytest.raises(ValueError, match="buffer_size"):
        device_prefetch(iter(batches), buffer_size=0, device="cpu")


@pytest.mark.parametrize("buffer_size", [1, 2, 5])
def test_device_prefetch_error_position(buffer_size):
    """A source error mid-stream: the batches already transferred come
    first, then the error, at its true position."""
    def flaky():
        for i in range(5):
            if i == 3:
                raise RuntimeError("decode failed")
            yield np.float32(i)

    seen = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for b in device_prefetch(flaky(), buffer_size=buffer_size,
                                 device="cpu"):
            seen.append(float(b))
    assert seen == [0.0, 1.0, 2.0]


def test_device_prefetch_refuses_device_tensors():
    pf = device_prefetch(iter([{"x": torch.ones(2, device="meta")}]),
                         device="cpu")
    with pytest.raises(ValueError, match="host batches"):
        next(pf)


def test_device_prefetch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError):
        device_prefetch(iter([np.ones(2)]))
