"""The port's operators: each wraps a hand-written CUDA kernel and keeps its
plain PyTorch version beside it (for CPU tensors and for the checks)."""

from horovod_tpu_torch.ops.attention import (  # noqa: F401
    attend,
    flash_attention,
    flash_attention_with_lse,
)
from horovod_tpu_torch.ops.xent import fused_softmax_xent  # noqa: F401
