"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``, for NVIDIA
Hopper cards.

It imports ``torch`` and numpy, never ``jax`` nor anything of
``horovod_tpu``. So far it runs the flagship dense transformer's training
step on one card, with hand-written CUDA kernels for flash attention and
the fused softmax cross-entropy (see ``ops/`` and ``csrc/``).
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
