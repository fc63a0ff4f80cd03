"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``, for NVIDIA
Hopper cards.

It imports ``torch`` and numpy, never ``jax`` nor anything of
``horovod_tpu``. It runs the flagship dense transformer's training step
data-parallel over ``torch.distributed`` (NCCL on the card, gloo on the
CPU): ``init`` starts the process group, ``build_mesh`` arranges the ranks,
and the gradients are synchronized by the model's ``make_train_step``, by
the bucketed overlap engine (``make_overlap_train_step``, collectives
launched from the backward pass) or by ``DistributedOptimizer``, with
int8 quantization on the wire and error feedback
(``ErrorFeedback(Compression.int8)``, or the fused ``fused_sgd``/
``fused_adam``). Hand-written CUDA kernels carry flash attention, the fused
softmax cross-entropy, the block-int8 codec and the fused dequantize +
optimizer apply (see ``ops/`` and ``csrc/``).

The train loop is observed by ``TelemetryCallback`` (step time, tokens/s,
MFU against the card's peak, the goodput ledger, the step time series,
anomaly detectors, ``torch.profiler`` captures); ``metrics_snapshot()``
returns the registry all of it writes to.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    NotInitializedError,
    cross_rank,
    cross_size,
    device,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    metrics_snapshot,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    ProcessSet,
    global_process_set,
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
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    build_mesh,
    mesh_axis_size,
    shard_batch,
)
from horovod_tpu_torch.train import (  # noqa: F401
    DistributedOptimizer,
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    bucketed_grad_sync,
    distributed_grad,
    fused_adam,
    fused_sgd,
    make_overlap_train_step,
    pipelined_accumulate,
)
from horovod_tpu_torch.train.callbacks import (  # noqa: F401
    StepTimer,
    TelemetryCallback,
)
