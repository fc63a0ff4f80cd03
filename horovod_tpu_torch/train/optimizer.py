"""``DistributedOptimizer`` for one process, with gradient compression.

Mirrors ``horovod_tpu/train/optimizer.py`` (``DistributedOptimizer`` and
the single-process path of ``DistributedGradTransform``) with the
reference Horovod torch API: ``hvd.DistributedOptimizer(optimizer,
named_parameters=..., compression=...)``.

* A ``torch.optim.Optimizer`` comes back wrapped: an instance of a
  subclass of its own class that shares its parameter groups and state,
  whose ``step()`` first replaces each gradient by its synchronized value
  and then runs the optimizer's own step. In one process the sync is the
  identity; with ``compression=ErrorFeedback(codec)`` the gradient is
  ``qdq(grad + residual)`` and the per-parameter fp32 residual carries the
  error (for ``Compression.int8`` that is the quantize and dequantize
  kernels), and pre-/postscale factors apply after it, as in
  ``_traced_allreduce_tree``. A bare codec without the EF wrapper leaves
  gradients untouched here: it compresses the multi-process wire only.
* A :class:`~horovod_tpu_torch.train.fused_apply.FusedOptSpec`
  (``fused_sgd``/``fused_adam``) with the parameters comes back as a
  :class:`~horovod_tpu_torch.train.fused_apply.FusedOptimizer`.

Multi-process data parallelism (NCCL, buckets, overlap) and
``backward_passes_per_step > 1`` arrive with the data-parallel slice.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.compression import Compression, Compressor
from horovod_tpu_torch.compression.error_feedback import (ErrorFeedback,
                                                          ef_apply_one)
from horovod_tpu_torch.ops.reduce_op import Average, ReduceOp
from horovod_tpu_torch.train.fused_apply import FusedOptimizer, FusedOptSpec


class _DistributedMixin:
    """The ``step`` of a wrapped torch optimizer (see the module doc)."""

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.synchronize()
        super().step()
        return loss

    @torch.no_grad()
    def synchronize(self) -> None:
        """Replace every gradient by its synchronized value: the EF round
        trip through the codec, then the pre-/postscale factors (the sync
        itself is the identity in one process)."""
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad
                if g is None:
                    continue
                if self._hvd_ef and g.is_floating_point():
                    r = self._hvd_residual.get(p)
                    if r is None:
                        r = torch.zeros(g.shape, dtype=torch.float32,
                                        device=g.device)
                    g, self._hvd_residual[p] = ef_apply_one(
                        self._hvd_codec, g, r)
                if self._hvd_prescale != 1.0:
                    g = g * self._hvd_prescale
                if self._hvd_postscale != 1.0:
                    g = g * self._hvd_postscale
                p.grad = g


def _wrap(optimizer: torch.optim.Optimizer, compression, prescale: float,
          postscale: float) -> torch.optim.Optimizer:
    cls = type(optimizer)
    sub = type(cls.__name__, (_DistributedMixin, cls), {})
    out = sub.__new__(sub)
    out.__dict__.update(optimizer.__dict__)    # shares groups and state
    ef = isinstance(compression, ErrorFeedback)
    out._hvd_ef = ef
    out._hvd_codec = compression.inner if ef else compression
    out._hvd_residual = {}
    out._hvd_prescale = float(prescale)
    out._hvd_postscale = float(postscale)
    return out


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression: Compressor = Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0):
    """Wrap a torch optimizer with gradient synchronization, or build the
    fused int8 optimizer from ``fused_sgd``/``fused_adam`` and
    ``named_parameters`` (the parameters, named or not). See the module
    docstring; the same combinations raise as in the JAX package."""
    if isinstance(optimizer, FusedOptSpec):
        if op == ReduceOp.ADASUM:
            raise ValueError("fused_sgd/fused_adam have no Adasum path")
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "fused apply does not take pre/postscale factors; fold "
                "them into the learning rate")
        if named_parameters is None:
            raise ValueError(
                "fused_sgd/fused_adam need the parameters: "
                "DistributedOptimizer(spec, model.named_parameters(), "
                "compression=...)")
        out = FusedOptimizer(named_parameters, optimizer,
                             compression=compression, op=op)
    else:
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"DistributedOptimizer wraps a torch.optim."
                            f"Optimizer or a FusedOptSpec, got "
                            f"{type(optimizer).__name__}")
        if op == ReduceOp.ADASUM:
            if compression is not Compression.none:
                raise ValueError(
                    "op=Adasum has no compression seam (the scaled-add tree "
                    "needs exact contributions); drop compression= or use a "
                    "different op")
            raise NotImplementedError(
                "op=Adasum arrives with the eager-collectives slice of the "
                "port")
        out = _wrap(optimizer, compression, prescale_factor,
                    postscale_factor)
    if backward_passes_per_step > 1:
        raise NotImplementedError(
            "backward_passes_per_step > 1 (local gradient accumulation) "
            "arrives with the data-parallel slice of the port")
    return out
