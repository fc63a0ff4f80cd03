"""Gradient compression, on torch tensors.

Mirrors ``horovod_tpu/compression/``: the ``Compressor`` contract and the
fp16/bf16 casts (:mod:`.base`), block-wise int8 (CUDA kernels on the card),
fp8 and 1-bit codecs (:mod:`.quantizers`), and residual-carrying error
feedback (:mod:`.error_feedback`), and the pre/wire byte counters of
the quantized transports (:mod:`.metrics`).
"""

from horovod_tpu_torch.compression.base import (  # noqa: F401
    BF16Compressor,
    Compressor,
    FP16Compressor,
    NoneCompressor,
)
from horovod_tpu_torch.compression.quantizers import (  # noqa: F401
    BlockInt8Quantizer,
    FP8Quantizer,
    OneBitQuantizer,
    Quantized,
    QuantSpec,
    Quantizer,
    fp8_supported,
    resolve_compressor,
)
from horovod_tpu_torch.compression.error_feedback import (  # noqa: F401
    ErrorFeedback,
    ef_apply,
    ef_apply_one,
    init_residual,
)
from horovod_tpu_torch.compression.metrics import (  # noqa: F401
    compression_ratio,
    record_compression,
)


class Compression:
    """The reference's ``hvd.Compression`` namespace (``none``, ``fp16``)
    grown with the quantizing codecs. ``int8``/``onebit`` are default
    instances; build :class:`BlockInt8Quantizer` / :class:`FP8Quantizer`
    for other block sizes or flavours."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = BlockInt8Quantizer()
    onebit = OneBitQuantizer()


if fp8_supported():
    Compression.fp8_e4m3 = FP8Quantizer("e4m3")
    Compression.fp8_e5m2 = FP8Quantizer("e5m2")
    Compression.fp8 = Compression.fp8_e4m3
