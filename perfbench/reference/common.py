"""What the plain references share: their precision modes and the two
optimizers, written out by hand from their published update rules.

A reference runs in one of two modes:

* ``"fp32"``: every operation in float32, with TF32 switched off for
  matrix products and convolutions (:func:`strict_fp32`). This is the
  yardstick the benchmark holds the program against.
* ``"fp8"``: the control. The operands and the result of every matrix
  product and convolution are rounded to 8-bit floats (E4M3 forward, E5M2
  for the gradients flowing back, each tensor scaled by its own absolute
  maximum, as FP8 training recipes do), the product taken in bfloat16;
  all else stays float32. It is the precision one step below the
  bfloat16 the configurations state for the products and the
  activations they make, which a later change might be tempted to take.
  It has to come out as not correct.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch

MODES = ("fp32", "fp8")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def strict_fp32() -> None:
    """Float32 products as float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the 8-bit float ``dtype`` under a per-tensor scale
    that maps its absolute maximum to ``top``; returned in bfloat16."""
    if t.numel() == 0:
        return t.to(torch.bfloat16)
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / top
    q = (t.float() / scale).to(dtype).float() * scale
    return q.to(torch.bfloat16)


class _Fp8Operand(torch.autograd.Function):
    """E4M3 forward, E5M2 for the cotangent."""

    @staticmethod
    def forward(ctx, t):
        ctx.dtype = t.dtype
        return _round8(t, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, _E5M2_MAX).to(ctx.dtype)


def operand(t: torch.Tensor, mode: str) -> torch.Tensor:
    """A matrix product's or convolution's operand as ``mode`` computes it."""
    if mode == "fp32":
        return t.float()
    if mode == "fp8":
        return _Fp8Operand.apply(t)
    raise ValueError(f"unknown precision mode {mode!r}; expected {MODES}")


def result(t: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's result as ``mode`` keeps it, in float32 for everything
    that follows."""
    if mode == "fp8":
        t = _Fp8Operand.apply(t)
    return t.float()


class SGDMomentum:
    """Heavy-ball SGD as PyTorch states it: ``b ← μ·b + g`` (``b ← g`` at
    the first step), ``p ← p − lr·b``; no dampening, no weight decay."""

    def __init__(self, lr: float, momentum: float):
        self.lr, self.momentum = lr, momentum
        self.buf: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, g in grads.items():
                if k in self.buf:
                    self.buf[k].mul_(self.momentum).add_(g)
                else:
                    self.buf[k] = g.clone()
                params[k].sub_(self.lr * self.buf[k])


class AdamW:
    """AdamW (Loshchilov and Hutter, arXiv:1711.05101) as PyTorch states
    it: decoupled decay ``p ← p·(1 − lr·wd)``, then the bias-corrected
    Adam step ``p ← p − lr·m̂ / (√v̂ + eps)``."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m.setdefault(k, torch.zeros_like(g))
                v = self.v.setdefault(k, torch.zeros_like(g))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p = params[k]
                p.mul_(1 - self.lr * self.wd)
                denom = (v / c2).sqrt_().add_(self.eps)
                p.addcdiv_(m / c1, denom, value=-self.lr)


def make_optimizer(spec: dict):
    """The reference optimizer a configuration's ``optimizer`` entry
    names."""
    kind = spec["kind"]
    if kind == "sgd_momentum":
        return SGDMomentum(spec["lr"], spec["momentum"])
    if kind == "adamw":
        return AdamW(spec["lr"], tuple(spec["betas"]), spec["eps"],
                     spec["weight_decay"])
    raise ValueError(f"unknown optimizer {kind!r}")
