"""The port's operators: each wraps a hand-written CUDA kernel and keeps its
plain PyTorch version beside it (for CPU tensors and for the checks)."""

from horovod_tpu_torch.ops.attention import (  # noqa: F401
    attend,
    flash_attention,
    flash_attention_with_lse,
)
from horovod_tpu_torch.ops.xent import fused_softmax_xent  # noqa: F401
from horovod_tpu_torch.ops.quantize import (  # noqa: F401
    block_dequantize,
    block_quantize,
    block_quantize_ef,
    fused_adam_apply,
    fused_sgd_apply,
)
from horovod_tpu_torch.ops.reduce_op import ReduceOp  # noqa: F401
