"""Block-wise int8 quantize/dequantize and the fused dequantize + optimizer
apply.

Mirrors ``horovod_tpu/ops/pallas_quantize.py``: ``block_quantize``,
``block_quantize_ef``, ``block_dequantize``, ``fused_sgd_apply`` and
``fused_adam_apply``, with the plain versions ``_xla_quantize``,
``_xla_quantize_ef``, ``_xla_dequantize``, ``_xla_fused_sgd`` (both
variants) and ``_xla_fused_adam`` as the six ``plain_*`` functions.

Operands are ``[n_blocks, block]`` with one fp32 scale a row,
``[n_blocks, 1]``. A CUDA tensor goes to the hand-written kernels of
``csrc/quantize.cu``, a CPU tensor to the plain version; a CUDA tensor the
kernels do not take (a dtype other than fp32 or bf16 for the quantizers, a
non-contiguous operand) raises. The kernels mask the ragged edge
themselves, so there is no row padding (the JAX wrappers pad to the
32-row int8 tile) and any ``block >= 1`` engages them (the JAX wrappers
need ``block % 128 == 0``).

Semantics, on both paths: ``scale = absmax / 127`` (1 for an all-zero
row), codes ``clip(round_half_even(x / scale), -127, 127)``; the divisions
are IEEE divisions and the hyperparameters fp32, as in the JAX package. The
optimizer deltas are optax-convention (``params += delta``). As the JAX
functions, every wrapper returns new tensors and leaves its operands as
they were.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from horovod_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# -- the plain versions (CPU tensors, and the checks on the card) ------------

def _h(ref: torch.Tensor, *vals) -> torch.Tensor:
    """Hyperparameters as fp32 on ``ref``'s device: the arithmetic is then
    fp32 throughout, as with the JAX package's ``jnp.float32`` stack."""
    return torch.tensor([float(v) for v in vals], dtype=torch.float32,
                        device=ref.device)


def plain_quantize(blocks: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_xla_quantize``: floats ``[n, block]`` → int8 codes and fp32
    scales ``[n, 1]``."""
    x = blocks.float()
    absmax = x.abs().amax(dim=1, keepdim=True)
    # a device tensor, not a Python scalar: PyTorch's CUDA division by a
    # scalar multiplies by its reciprocal, one ULP off the IEEE quotient
    scale = torch.where(absmax > 0.0, absmax / absmax.new_full((), 127.0),
                        torch.ones_like(absmax))
    vals = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return vals, scale


def plain_quantize_ef(blocks: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_xla_quantize_ef``: codes, scales and the fp32 residual
    ``x − codes·scale``."""
    x = blocks.float()
    vals, scale = plain_quantize(blocks)
    return vals, scale, x - vals.float() * scale


def plain_dequantize(vals: torch.Tensor, scales: torch.Tensor
                     ) -> torch.Tensor:
    """``_xla_dequantize``: ``codes·scale`` as fp32."""
    return vals.float() * scales


def plain_fused_sgd0(vals, scales, lr) -> torch.Tensor:
    """``_xla_fused_sgd`` without momentum: ``delta = −lr·g``."""
    h = _h(vals, lr)
    return -h[0] * plain_dequantize(vals, scales)


def plain_fused_sgd(vals, scales, mom, lr, momentum
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_xla_fused_sgd`` with momentum (optax's trace): ``t = g + μ·t_prev``,
    ``delta = −lr·t`` → ``(delta, t)``."""
    h = _h(vals, lr, momentum)
    m = plain_dequantize(vals, scales) + h[1] * mom
    return -h[0] * m, m


def plain_fused_adam(vals, scales, m, v, lr, b1, b2, eps, bc1, bc2
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_xla_fused_adam``: the Adam moments and
    ``delta = −lr·(m/bc1)/(sqrt(v/bc2) + eps)`` → ``(delta, m, v)``."""
    h = _h(vals, lr, b1, b2, eps, bc1, bc2)
    g = plain_dequantize(vals, scales)
    m = h[1] * m + (1.0 - h[1]) * g
    v = h[2] * v + (1.0 - h[2]) * g * g
    delta = -h[0] * (m / h[4]) / (torch.sqrt(v / h[5]) + h[3])
    return delta, m, v


# -- argument checks ----------------------------------------------------------

def _on_cpu(name: str, *ts: Optional[torch.Tensor]) -> bool:
    """True when every operand lies on the CPU (the plain version), False
    when all lie on one CUDA device (the kernel); anything else raises."""
    devs = {t.device for t in ts if t is not None}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"{name} takes its operands on the CPU or on one CUDA "
                     f"device, got {sorted(map(str, devs))}")


def _check_blocks(name: str, x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{name} takes [n_blocks, block] operands with "
                         f"block >= 1, got {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _check_scales(name: str, vals: torch.Tensor, scales: torch.Tensor
                  ) -> Tuple[int, int]:
    n, block = _check_blocks(name, vals)
    if scales.shape != (n, 1):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} do not match "
                         f"codes {tuple(vals.shape)} as [n_blocks, 1]")
    return n, block


def _check_like(name: str, what: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} {tuple(t.shape)} does not match "
                         f"{tuple(shape)}")


def _check_kernel_operands(name: str, **operands: torch.Tensor) -> None:
    """What the CUDA kernels take: codes int8, scales and state fp32, all
    contiguous. (The quantizers' input dtype is checked by the caller.)"""
    for what, t in operands.items():
        want = torch.int8 if what == "vals" else torch.float32
        if what != "blocks" and t.dtype != want:
            raise TypeError(f"{name} takes {what} as {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous {what}, got strides "
                             f"{t.stride()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- the kernels' launchers (CUDA tensors) ------------------------------------

def _quantizer_cuda(entry: str, blocks: torch.Tensor):
    n, block = _check_blocks(entry, blocks)
    if blocks.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{entry} takes fp32 or bf16 blocks, got "
                        f"{blocks.dtype}")
    _check_kernel_operands(entry, blocks=blocks)
    dev = blocks.device
    vals = torch.empty((n, block), dtype=torch.int8, device=dev)
    scales = torch.empty((n, 1), dtype=torch.float32, device=dev)
    res = None
    if entry == "quantize_ef":
        res = torch.empty((n, block), dtype=torch.float32, device=dev)
    if n == 0:
        return vals, scales, res, False
    lib = _build.library("quantize")
    args = [blocks.data_ptr(), vals.data_ptr(), scales.data_ptr()]
    if res is not None:
        args.append(res.data_ptr())
    err = getattr(lib, entry)(*args, n, block, _KERNEL_DTYPES[blocks.dtype],
                              dev.index, _stream(blocks))
    _build.check(lib, entry, err)
    return vals, scales, res, True


def quantize_cuda(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``quantize`` (``csrc/quantize.cu``), which replaces
    ``_quantize_kernel`` (``horovod_tpu/ops/pallas_quantize.py``). Counts
    its launches in ``quantize_cuda.launches``."""
    vals, scales, _, launched = _quantizer_cuda("quantize", blocks)
    if launched:
        quantize_cuda.launches += 1
    return vals, scales


def quantize_ef_cuda(blocks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``quantize_ef``, which replaces ``_quantize_ef_kernel``: the
    codes, scales and residual in one pass. Counts in
    ``quantize_ef_cuda.launches``."""
    vals, scales, res, launched = _quantizer_cuda("quantize_ef", blocks)
    if launched:
        quantize_ef_cuda.launches += 1
    return vals, scales, res


def dequantize_cuda(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Launch ``dequantize``, which replaces ``_dequantize_kernel``. Counts
    in ``dequantize_cuda.launches``."""
    n, block = _check_scales("dequantize", vals, scales)
    _check_kernel_operands("dequantize", vals=vals, scales=scales)
    out = torch.empty((n, block), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    lib = _build.library("quantize")
    err = lib.dequantize(vals.data_ptr(), scales.data_ptr(), out.data_ptr(),
                         n, block, vals.device.index, _stream(vals))
    _build.check(lib, "dequantize", err)
    dequantize_cuda.launches += 1
    return out


def fused_sgd0_cuda(vals, scales, lr) -> torch.Tensor:
    """Launch ``fused_sgd0``, which replaces ``_fused_sgd0_kernel``. Counts
    in ``fused_sgd0_cuda.launches``."""
    n, block = _check_scales("fused_sgd0", vals, scales)
    _check_kernel_operands("fused_sgd0", vals=vals, scales=scales)
    delta = torch.empty((n, block), dtype=torch.float32, device=vals.device)
    if n == 0:
        return delta
    lib = _build.library("quantize")
    err = lib.fused_sgd0(vals.data_ptr(), scales.data_ptr(), delta.data_ptr(),
                         float(lr), n, block, vals.device.index, _stream(vals))
    _build.check(lib, "fused_sgd0", err)
    fused_sgd0_cuda.launches += 1
    return delta


def fused_sgd_cuda(vals, scales, mom, lr, momentum
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fused_sgd``, which replaces ``_fused_sgd_kernel``. Counts
    in ``fused_sgd_cuda.launches``."""
    n, block = _check_scales("fused_sgd", vals, scales)
    _check_like("fused_sgd", "mom", mom, (n, block))
    _check_kernel_operands("fused_sgd", vals=vals, scales=scales, mom=mom)
    delta = torch.empty((n, block), dtype=torch.float32, device=vals.device)
    new_mom = torch.empty_like(delta)
    if n == 0:
        return delta, new_mom
    lib = _build.library("quantize")
    err = lib.fused_sgd(vals.data_ptr(), scales.data_ptr(), mom.data_ptr(),
                        delta.data_ptr(), new_mom.data_ptr(), float(lr),
                        float(momentum), n, block, vals.device.index,
                        _stream(vals))
    _build.check(lib, "fused_sgd", err)
    fused_sgd_cuda.launches += 1
    return delta, new_mom


def fused_adam_cuda(vals, scales, m, v, lr, b1, b2, eps, bc1, bc2
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``fused_adam``, which replaces ``_fused_adam_kernel``. Counts
    in ``fused_adam_cuda.launches``."""
    n, block = _check_scales("fused_adam", vals, scales)
    _check_like("fused_adam", "m", m, (n, block))
    _check_like("fused_adam", "v", v, (n, block))
    _check_kernel_operands("fused_adam", vals=vals, scales=scales, m=m, v=v)
    delta = torch.empty((n, block), dtype=torch.float32, device=vals.device)
    new_m, new_v = torch.empty_like(delta), torch.empty_like(delta)
    if n == 0:
        return delta, new_m, new_v
    lib = _build.library("quantize")
    err = lib.fused_adam(vals.data_ptr(), scales.data_ptr(), m.data_ptr(),
                         v.data_ptr(), delta.data_ptr(), new_m.data_ptr(),
                         new_v.data_ptr(), float(lr), float(b1), float(b2),
                         float(eps), float(bc1), float(bc2), n, block,
                         vals.device.index, _stream(vals))
    _build.check(lib, "fused_adam", err)
    fused_adam_cuda.launches += 1
    return delta, new_m, new_v


LAUNCHERS = (quantize_cuda, quantize_ef_cuda, dequantize_cuda,
             fused_sgd0_cuda, fused_sgd_cuda, fused_adam_cuda)
for _fn in LAUNCHERS:
    _fn.launches = 0


# -- the wrappers: the JAX package's functions ---------------------------------

def block_quantize(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[n_blocks, block]`` floats → ``(int8 codes [n_blocks, block],
    fp32 scales [n_blocks, 1])`` with per-row scale ``absmax/127``."""
    _check_blocks("block_quantize", blocks)
    if _on_cpu("block_quantize", blocks):
        return plain_quantize(blocks)
    return quantize_cuda(blocks)


def block_quantize_ef(blocks: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[n_blocks, block]`` floats → ``(codes, scales, fp32 residual)``,
    ``residual = blocks − dequantize(codes, scales)``, the error-feedback
    carry, from the same pass as the codes."""
    _check_blocks("block_quantize_ef", blocks)
    if _on_cpu("block_quantize_ef", blocks):
        return plain_quantize_ef(blocks)
    return quantize_ef_cuda(blocks)


def block_dequantize(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`block_quantize`: ``codes·scale`` per row, fp32
    ``[n_blocks, block]``."""
    _check_scales("block_dequantize", vals, scales)
    if _on_cpu("block_dequantize", vals, scales):
        return plain_dequantize(vals, scales)
    return dequantize_cuda(vals, scales)


def fused_sgd_apply(vals: torch.Tensor, scales: torch.Tensor,
                    mom: Optional[torch.Tensor], lr, momentum):
    """int8 codes + scales (+ momentum blocks) → ``(delta, new_mom)``:
    dequantize and the optax ``sgd(lr, momentum)`` update in one pass.
    ``mom=None`` selects the momentum-free kernel (``new_mom`` is None)."""
    n, block = _check_scales("fused_sgd_apply", vals, scales)
    if mom is not None:
        _check_like("fused_sgd_apply", "mom", mom, (n, block))
    if _on_cpu("fused_sgd_apply", vals, scales, mom):
        if mom is None:
            return plain_fused_sgd0(vals, scales, lr), None
        return plain_fused_sgd(vals, scales, mom, lr, momentum)
    if mom is None:
        return fused_sgd0_cuda(vals, scales, lr), None
    return fused_sgd_cuda(vals, scales, mom, lr, momentum)


def fused_adam_apply(vals: torch.Tensor, scales: torch.Tensor,
                     m: torch.Tensor, v: torch.Tensor, lr, b1, b2, eps, bc1,
                     bc2):
    """int8 codes + scales + Adam moments → ``(delta, new_m, new_v)`` with
    optax.adam numerics; ``bc1``/``bc2`` are the caller's fp32 bias
    corrections ``1 − βₖᵗ``."""
    n, block = _check_scales("fused_adam_apply", vals, scales)
    _check_like("fused_adam_apply", "m", m, (n, block))
    _check_like("fused_adam_apply", "v", v, (n, block))
    if _on_cpu("fused_adam_apply", vals, scales, m, v):
        return plain_fused_adam(vals, scales, m, v, lr, b1, b2, eps, bc1,
                                bc2)
    return fused_adam_cuda(vals, scales, m, v, lr, b1, b2, eps, bc1, bc2)
