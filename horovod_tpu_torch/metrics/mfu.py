"""MFU accounting: the card's peak FLOPs and a step's FLOP count.

Mirrors ``horovod_tpu/metrics/mfu.py`` (``peak_flops``,
``device_peak_flops``, ``mfu``), shared by the train-loop telemetry
(:class:`horovod_tpu_torch.train.callbacks.TelemetryCallback`). The JAX
package counts a step's FLOPs from the compiled HLO's cost analysis
(``hlo_flops_per_device``); eager PyTorch has no compiled program, so
:func:`flops_per_step` runs the step once under
``torch.utils.flop_counter.FlopCounterMode``, which counts the products
(matmul-class ops, 2 FLOPs a multiply-add) that reach the dispatcher.

The hand-written kernels do not reach it: they are launched through
``ctypes``, not as aten ops, so the counter would see nothing of them on
the card, and on the CPU it would see their plain versions' ops instead
(attention as two full-square batched products, where the causal kernel
computes half). So each kernel's FLOPs are a formula kept beside its
wrapper, added on every call while a count is open
(:func:`count_kernel_flops`), and its plain version runs uncounted
(:func:`uncounted`): the same step counts the same on both devices.

:func:`analytic_flops` is the fallback when a step cannot be run to count
it: bench.py's ``6·N·T`` rule plus attention's products.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

# Peak dense bf16 tensor-core FLOP/s by CUDA device-name substring, from
# NVIDIA's H100 Tensor Core GPU datasheet (BF16 Tensor Core: 1,979
# TFLOPS for SXM and 1,513 for PCIe, both quoted with sparsity; dense is
# half). Checked in order: the PCIe card's name also contains "H100".
PEAK_BF16_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989e12),     # the SXM5 card's device name
    ("h100 sxm", 989e12),
)

_TLS = threading.local()


def peak_flops(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a CUDA device name
    (``torch.cuda.get_device_name()``), or None when the card is not in
    the table — no peak is made up."""
    name = device_name.lower()
    for sub, peak in PEAK_BF16_FLOPS:
        if sub in name:
            return peak
    return None


def device_peak_flops() -> Optional[float]:
    """Peak FLOP/s of the current CUDA device (None on the CPU)."""
    import torch
    if not torch.cuda.is_available():
        return None
    return peak_flops(torch.cuda.get_device_name())


def count_kernel_flops(flops: int) -> None:
    """Add a hand-written kernel's FLOPs to the count open on this thread
    (no-op outside :func:`flops_per_step`)."""
    acc = getattr(_TLS, "acc", None)
    if acc is not None:
        acc[0] += flops


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Hide the ops run inside from an open count: a kernel's plain
    version, whose FLOPs its formula already counted."""
    if getattr(_TLS, "acc", None) is None:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield


def flops_per_step(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call ``fn(*args, **kwargs)``: it is run once under
    ``FlopCounterMode``, with the hand-written kernels counted by their
    formulas. Pass a function without side effects (a forward and
    backward such as ``models.make_grad_fn(cfg)``: the optimizer adds no
    products). Returns None when nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode
    if getattr(_TLS, "acc", None) is not None:
        raise RuntimeError("flops_per_step does not nest")
    _TLS.acc = [0]
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        total = counter.get_total_flops() + _TLS.acc[0]
    finally:
        _TLS.acc = None
    return float(total) or None


def analytic_flops(n_params: int, tokens: int, n_layers: int = 0,
                   seq: int = 0, d_model: int = 0,
                   causal: bool = True) -> float:
    """Training FLOPs of a dense transformer step over ``tokens`` tokens:
    ``6·N·T`` (forward 2, backward 4 FLOPs per parameter and token, the
    rule bench.py uses) plus attention's products, forward ``4·d_model``
    FLOPs per (query, key) pair a layer and the backward twice that;
    causal attention keeps ``(seq + 1) / 2`` pairs a token."""
    pairs = (seq + 1) / 2 if causal else seq
    return 6.0 * n_params * tokens + 12.0 * n_layers * d_model * pairs * tokens


def mfu(flops_per_device_per_step: float, step_seconds: float,
        peak: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilization for one step; None when the peak is
    unknown or inputs are degenerate."""
    if peak is None:
        peak = device_peak_flops()
    if not peak or not flops_per_device_per_step or step_seconds <= 0:
        return None
    return flops_per_device_per_step / step_seconds / peak
