"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``, for NVIDIA
Hopper cards.

It imports ``torch`` and numpy, never ``jax`` nor anything of
``horovod_tpu``. So far it runs the flagship dense transformer's training
step on one card, with hand-written CUDA kernels for flash attention and
the fused softmax cross-entropy, and int8 error-feedback gradient
compression (``DistributedOptimizer`` with ``ErrorFeedback(Compression.int8)``,
or the fused ``fused_sgd``/``fused_adam``) with hand-written kernels for
the block-int8 codec and the fused dequantize + optimizer apply (see
``ops/`` and ``csrc/``).
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    NotInitializedError,
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.compression import (  # noqa: F401
    Compression,
    ErrorFeedback,
)
from horovod_tpu_torch.ops.reduce_op import (  # noqa: F401
    Adasum,
    Average,
    ReduceOp,
    Sum,
)
from horovod_tpu_torch.train import (  # noqa: F401
    DistributedOptimizer,
    fused_adam,
    fused_sgd,
)
