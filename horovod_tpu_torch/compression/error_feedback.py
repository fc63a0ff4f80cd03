"""Error feedback (EF) for lossy gradient compression, on torch tensors.

Mirrors ``horovod_tpu/compression/error_feedback.py``. A lossy codec
biases SGD: what it rounds away this step is lost. EF carries the error
into the next step::

    acc        = grad + residual     # re-inject last step's error
    compressed = C(acc)              # what the wire moves
    residual   = acc - compressed    # carried to the next step

Residuals are fp32 whatever the gradient's dtype; non-floating leaves pass
through. The JAX package threads pytrees; here a tree is a dict of
tensors (``None`` residual = pass through), e.g. keyed by parameter name.
:class:`~horovod_tpu_torch.train.optimizer.DistributedOptimizer` with
``compression=ErrorFeedback(codec)`` keeps one residual per parameter.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from horovod_tpu_torch.compression.base import Compressor
from horovod_tpu_torch.compression.quantizers import Quantizer


class ErrorFeedback:
    """Marker wrapper for the ``compression=`` seam: ``inner`` is the
    codec; the consumer owns the residual state."""

    def __init__(self, inner: Compressor):
        if isinstance(inner, ErrorFeedback):
            raise ValueError("ErrorFeedback cannot wrap ErrorFeedback")
        self.inner = inner

    def __repr__(self):
        return f"ErrorFeedback({self.inner!r})"


def init_residual(params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """fp32 zeros for every floating leaf, None for the rest."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if p.is_floating_point() else None for k, p in params.items()}


def _qdq(comp: Compressor, x: torch.Tensor) -> torch.Tensor:
    """quantize∘dequantize through whichever interface ``comp`` has."""
    if isinstance(comp, Quantizer):
        return comp.qdq(x)
    payload, ctx = comp.compress(x)
    return comp.decompress(payload, ctx)


def ef_apply_one(comp: Compressor, u: torch.Tensor,
                 r: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One leaf of :func:`ef_apply`: ``(compressed, new_residual)``."""
    if r is None:
        return u, None
    acc = u.float() + r
    out = _qdq(comp, acc).to(u.dtype)
    # the residual measures the error of what the caller gets, including
    # the cast back to the gradient's dtype
    return out, acc - out.float()


def ef_apply(comp: Compressor, updates: Mapping[str, torch.Tensor],
             residual: Mapping[str, Optional[torch.Tensor]]):
    """One EF round over a dict of leaves: ``(compressed_updates,
    new_residual)``. Leaves with a None residual pass through."""
    if set(updates) != set(residual):
        raise ValueError(f"updates and residual differ in keys: "
                         f"{sorted(set(updates) ^ set(residual))}")
    pairs = {k: ef_apply_one(comp, u, residual[k]) for k, u in updates.items()}
    return ({k: p[0] for k, p in pairs.items()},
            {k: p[1] for k, p in pairs.items()})
