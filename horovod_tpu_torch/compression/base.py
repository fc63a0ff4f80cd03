"""Compressor interface and the dtype-cast compressors, on torch tensors.

Mirrors ``horovod_tpu/compression/base.py`` (reference:
``horovod/torch/compression.py:20-75``). The contract every compressor
honours::

    payload, ctx = comp.compress(tensor)   # payload is what moves
    tensor ≈ comp.decompress(payload, ctx)

For the casts the payload is a tensor that a backend can sum directly;
quantizers (:mod:`horovod_tpu_torch.compression.quantizers`) carry
per-block scales, which do not sum.
"""

from __future__ import annotations

from typing import Tuple

import torch


class Compressor:
    """Interface (reference: ``Compressor``, ``compression.py:20-33``)."""

    @staticmethod
    def compress(tensor) -> Tuple:
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Cast floating tensors to ``wire`` for transport and back after."""

    wire: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire:
            return tensor.to(cls.wire), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """float32/float64 to float16 for transport
    (reference: ``compression.py:42-62``)."""

    wire = torch.float16


class BF16Compressor(_CastCompressor):
    """To bfloat16 for transport: fp32's exponent range, so no overflow
    handling is needed."""

    wire = torch.bfloat16
