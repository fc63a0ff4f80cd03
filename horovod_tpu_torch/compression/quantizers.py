"""Quantize/dequantize pairs for gradient transport, on torch tensors.

Mirrors ``horovod_tpu/compression/quantizers.py``:

* :class:`BlockInt8Quantizer` — one fp32 scale ``absmax/127`` per block of
  ``block_size`` elements and an int8 payload, through the CUDA kernels of
  :mod:`horovod_tpu_torch.ops.quantize` on the card. Error per element at
  most ``absmax_block / 254``.
* :class:`FP8Quantizer` — a scaled cast to ``torch.float8_e4m3fn`` /
  ``float8_e5m2`` with one per-tensor scale (plain PyTorch: the JAX package
  computes it in XLA too, with no kernel).
* :class:`OneBitQuantizer` — sign bits packed 8 a byte and the tensor's
  mean magnitude (plain PyTorch); meaningful only under error feedback.

``quantize(x) -> (Quantized(values, scales), QuantSpec)``;
``dequantize(q, spec)`` restores the shape and dtype. Quantizers hash and
compare by their configuration.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch

from horovod_tpu_torch.compression.base import Compressor


def _default_block_size() -> int:
    """Read at use: ``HVD_TPU_COMPRESSION_BLOCK_SIZE`` wins over the
    ``HOROVOD_COMPRESSION_BLOCK_SIZE`` alias, 256 otherwise."""
    for key in ("HVD_TPU_COMPRESSION_BLOCK_SIZE",
                "HOROVOD_COMPRESSION_BLOCK_SIZE"):
        v = os.environ.get(key)
        if v:
            return int(v)
    return 256


class Quantized(NamedTuple):
    """The payload: quantized values and their scales."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def wire_bytes(self) -> int:
        """Bytes this payload puts on the interconnect."""
        return (self.values.numel() * self.values.element_size()
                + self.scales.numel() * self.scales.element_size())


class QuantSpec(NamedTuple):
    """How to rebuild the tensor: its shape, dtype and the padding added."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    pad: int


def _flatten(x: torch.Tensor) -> Tuple[torch.Tensor, QuantSpec]:
    return x.reshape(-1), QuantSpec(shape=tuple(x.shape), dtype=x.dtype,
                                    pad=0)


class Quantizer(Compressor):
    """Base for codecs whose payload does not sum on the wire."""

    name = "quantizer"

    def quantize(self, x) -> Tuple[Quantized, QuantSpec]:
        raise NotImplementedError

    def dequantize(self, q: Quantized, spec: QuantSpec):
        raise NotImplementedError

    def wire_bytes(self, numel: int) -> int:
        """Bytes :meth:`quantize` puts on the wire for a tensor of
        ``numel`` elements, values plus scales, from the count alone (the
        JAX package's ``_quantized_wire_bytes``)."""
        raise NotImplementedError

    def qdq(self, x):
        """quantize∘dequantize: the simulated compression error feedback
        applies."""
        q, spec = self.quantize(x)
        return self.dequantize(q, spec)

    def compress(self, tensor):
        return self.quantize(tensor)

    def decompress(self, tensor, ctx):
        return self.dequantize(tensor, ctx)

    def _config(self) -> tuple:
        return (type(self).__name__,)

    def __hash__(self):
        return hash(self._config())

    def __eq__(self, other):
        return isinstance(other, Quantizer) and \
            self._config() == other._config()

    def __repr__(self):
        return f"{type(self).__name__}{self._config()[1:]}"


class BlockInt8Quantizer(Quantizer):
    """Block-wise int8: flatten, pad with zeros to a block multiple, one
    fp32 scale per ``block_size`` elements. ``block_size=None`` (the
    ``Compression.int8`` instance) reads the block-size environment
    variables at use, and the configuration hash follows the value read.

    Error bound: ``|x - qdq(x)| <= max|block| / 254`` elementwise."""

    name = "int8"

    def __init__(self, block_size: int = None):
        if block_size is not None and int(block_size) <= 0:
            raise ValueError("block_size must be positive")
        self._block_size = int(block_size) if block_size is not None \
            else None

    @property
    def block_size(self) -> int:
        return self._block_size if self._block_size is not None \
            else _default_block_size()

    def _config(self):
        return (type(self).__name__, self.block_size)

    def wire_bytes(self, numel: int) -> int:
        blocks = -(-numel // self.block_size)
        return blocks * self.block_size + blocks * 4   # int8 codes, fp32 scales

    def quantize(self, x):
        from horovod_tpu_torch.ops.quantize import block_quantize
        flat, spec = _flatten(x)
        block = self.block_size
        pad = (-flat.numel()) % block
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        vals, scales = block_quantize(flat.view(-1, block))
        return Quantized(vals, scales), spec._replace(pad=pad)

    def dequantize(self, q, spec):
        from horovod_tpu_torch.ops.quantize import block_dequantize
        flat = block_dequantize(q.values, q.scales).reshape(-1)
        if spec.pad:
            flat = flat[:flat.numel() - spec.pad]
        return flat.reshape(spec.shape).to(spec.dtype)


_FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}


def fp8_supported() -> bool:
    return hasattr(torch, "float8_e4m3fn") and hasattr(torch, "float8_e5m2")


class FP8Quantizer(Quantizer):
    """Scaled cast to fp8: one per-tensor fp32 scale maps the absmax onto
    the format's largest finite value. ``e4m3`` (default) favours
    precision, ``e5m2`` range."""

    name = "fp8"

    def __init__(self, flavor: str = "e4m3"):
        if flavor not in _FP8_MAX:
            raise ValueError(f"fp8 flavor must be e4m3|e5m2, got {flavor!r}")
        if not fp8_supported():
            raise NotImplementedError(
                "this torch build has no torch.float8_* dtypes; use "
                "Compression.int8 or Compression.bf16 instead")
        self.flavor = flavor
        self._dtype = torch.float8_e4m3fn if flavor == "e4m3" \
            else torch.float8_e5m2

    def _config(self):
        return (type(self).__name__, self.flavor)

    def wire_bytes(self, numel: int) -> int:
        return numel + 4                 # one byte a value, one fp32 scale

    def quantize(self, x):
        flat, spec = _flatten(x)
        f = flat.float()
        absmax = f.abs().amax() if f.numel() else f.new_zeros(())
        scale = torch.where(absmax > 0.0,
                            absmax / absmax.new_full((), _FP8_MAX[self.flavor]),
                            torch.ones_like(absmax))
        vals = (f / scale).to(self._dtype)
        return Quantized(vals, scale.reshape(1)), spec

    def dequantize(self, q, spec):
        flat = q.values.float() * q.scales[0]
        return flat.reshape(spec.shape).to(spec.dtype)


class OneBitQuantizer(Quantizer):
    """sign(x) packed 8 a byte (bit i of byte k is element 8k + i, set for
    x >= 0) and mean |x|: about 32x smaller than fp32. Biased on its own;
    compose it with
    :class:`~horovod_tpu_torch.compression.error_feedback.ErrorFeedback`."""

    name = "onebit"

    def wire_bytes(self, numel: int) -> int:
        return -(-numel // 8) + 4        # 8 signs a byte, one fp32 mean

    def quantize(self, x):
        flat, spec = _flatten(x)
        f = flat.float()
        mean = f.abs().mean() if f.numel() else f.new_zeros(())
        pad = (-f.numel()) % 8
        bits = f >= 0
        if pad:
            bits = torch.cat([bits, bits.new_zeros(pad)])
        weights = 2 ** torch.arange(8, dtype=torch.int32, device=f.device)
        packed = (bits.view(-1, 8).to(torch.int32) * weights).sum(1)
        return Quantized(packed.to(torch.uint8), mean.reshape(1)), \
            spec._replace(pad=pad)

    def dequantize(self, q, spec):
        shifts = torch.arange(8, dtype=torch.uint8, device=q.values.device)
        bits = (q.values[:, None] >> shifts) & 1
        signs = bits.reshape(-1).float() * 2.0 - 1.0
        if spec.pad:
            signs = signs[:signs.numel() - spec.pad]
        return (signs * q.scales[0]).reshape(spec.shape).to(spec.dtype)


def resolve_compressor(name: str):
    """A knob string (``--compression``) → a compressor: int8 | fp8 |
    fp8_e4m3 | fp8_e5m2 | onebit | fp16 | bf16 | none."""
    from horovod_tpu_torch.compression.base import (BF16Compressor,
                                                    FP16Compressor,
                                                    NoneCompressor)
    key = (name or "none").lower()
    fp8 = fp8_supported()
    table = {
        "none": NoneCompressor,
        "fp16": FP16Compressor,
        "bf16": BF16Compressor,
        "int8": BlockInt8Quantizer(),
        "fp8": FP8Quantizer("e4m3") if fp8 else None,
        "fp8_e4m3": FP8Quantizer("e4m3") if fp8 else None,
        "fp8_e5m2": FP8Quantizer("e5m2") if fp8 else None,
        "onebit": OneBitQuantizer(),
    }
    if key not in table:
        raise ValueError(
            f"unknown compression {name!r}; expected one of {sorted(table)}")
    comp = table[key]
    if comp is None:
        raise NotImplementedError(
            f"compression {name!r} needs torch.float8_* dtypes, absent from "
            "this torch build")
    return comp
