"""Back-compat shim (mirrors ``horovod_tpu/train/compression.py``): the
compressors live in :mod:`horovod_tpu_torch.compression`; this keeps the
``train.compression.Compression`` import path (the reference's
``horovod/torch/compression.py``) alive."""

from __future__ import annotations

from horovod_tpu_torch.compression import (  # noqa: F401
    BF16Compressor,
    Compression,
    Compressor,
    ErrorFeedback,
    FP16Compressor,
    NoneCompressor,
)
