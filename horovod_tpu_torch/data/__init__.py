"""Data loading: ``ShardedDataset`` with its resumable cursor,
``AsyncDataLoaderMixin`` and ``device_prefetch`` onto the card."""

from horovod_tpu_torch.data.data_loader import (  # noqa: F401
    AsyncDataLoaderMixin,
    BaseDataLoader,
    ShardedDataset,
    device_prefetch,
)
