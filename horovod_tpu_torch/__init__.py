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

The flagship runs over any ``{dp, pp, tp, sp, ep}`` mesh: the layers split
into pipeline stages over pp (GPipe), tensor, sequence (ring or Ulysses)
and expert parallelism inside each stage. ``make_pipeline_train_step``
trains a layer-major model dp x pp under a ``ParallelPlan`` (GPipe, 1F1B
or interleaved 1F1B), and ``autotune=`` searches the plan (or the
communication plan of ``make_overlap_train_step``) by measured step time,
with a persistent plan cache.

The train loop is observed by ``TelemetryCallback`` (step time, tokens/s,
MFU against the card's peak, the goodput ledger, the step time series,
anomaly detectors, ``torch.profiler`` captures); ``metrics_snapshot()``
returns the registry all of it writes to. ``init`` brings up the live
half: the per-worker exporter (``HVD_TPU_METRICS_PORT``: ``/metrics``,
``/healthz``, ``/debug/*``, the fleet fan-in tree), the hang watchdog
whose autopsy bundle names which rank is stuck in what, and per-rank
timeline shards merged across ranks (``python -m
horovod_tpu_torch.diagnostics``, ``python -m horovod_tpu_torch.metrics``). A run saves asynchronously and
resumes through ``ShardedCheckpointer`` (the JAX package's on-disk format,
read both ways) and ``callbacks.CheckpointCallback``, with its data
position from ``data.ShardedDataset``'s cursor; ``ReplicaCanary`` and
``param_digest`` compare the replicas. ``serving`` serves the weights:
a continuous-batching decode engine over a paged KV pool (each step
function captured once in a CUDA graph), replicas with hot swap from the
checkpoint store, a hedging router and a healing fleet.
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
    start_timeline,
    stop_timeline,
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
    dp_pp_mesh,
    mesh_axis_size,
    shard_batch,
)
from horovod_tpu_torch.parallel.plan import (  # noqa: F401
    ParallelPlan,
    compile_step_with_plan,
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
from horovod_tpu_torch.train.autotune import (  # noqa: F401
    AutotuneOptions,
    Plan as AutotunePlan,
    make_parallel_train_step,
    parallel_candidate_plans,
)
from horovod_tpu_torch.train.guard import (  # noqa: F401
    GuardSpec,
    ReplicaCanary,
    param_digest,
)
from horovod_tpu_torch.train.pipeline import (  # noqa: F401
    make_pipeline_train_step,
)
from horovod_tpu_torch.train.callbacks import (  # noqa: F401
    StepTimer,
    TelemetryCallback,
)
# Durable sharded checkpoints (Checkpointer is the same class, as in the
# JAX package) and the training-loop callbacks module
from horovod_tpu_torch.checkpoint import (  # noqa: F401
    CheckpointError,
    ShardedCheckpointer,
)
from horovod_tpu_torch.train.checkpoint import Checkpointer  # noqa: F401
from horovod_tpu_torch.train import callbacks  # noqa: F401
