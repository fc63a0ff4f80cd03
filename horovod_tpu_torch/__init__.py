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

The eager collectives (``allreduce``, ``grouped_allreduce``,
``allgather``, ``broadcast``, ``alltoall``, ``reducescatter``, their
``*_async`` handles with ``poll``/``synchronize``, ``join``, ``barrier``,
process sets registered at run time, Adasum) run on the C++ negotiating
core built from ``cpp/`` (or ``torch.distributed`` with
``HVD_TPU_EAGER_BACKEND=dist``); ``horovod_tpu_torch.torch`` is the
reference's ``horovod.torch`` surface over them, with its hook-based
``DistributedOptimizer``.

``python -m horovod_tpu_torch.runner.launch`` (``hvdrun``) launches a job,
static or under the elastic driver (``runner/elastic/``: discovery, the
write-ahead journal, in-place recovery, growth and shrink); a worker's
``elastic.run`` loop with a ``torch.elastic.TorchState`` re-meshes in
place when a peer dies or the world changes.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    NotInitializedError,
    ccl_built,
    counters,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    device,
    engine_state,
    global_device_count,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    metrics_snapshot,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    num_devices,
    rank,
    rocm_built,
    shutdown,
    size,
    start_timeline,
    stop_timeline,
    stragglers,
    sycl_built,
    tcp_core_built,
)
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    ProcessSet,
    add_process_set,
    get_process_set_by_id,
    global_process_set,
    process_set_ids,
    remove_process_set,
)
# the eager collectives (reference: horovod/torch/mpi_ops.py)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    grouped_allreduce,
    grouped_allreduce_async,
    join,
    poll,
    quantized_allreduce,
    quantized_allreduce_async,
    quantized_grouped_allreduce,
    quantized_grouped_allreduce_async,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from horovod_tpu_torch.compression import (  # noqa: F401
    Compression,
    Compressor,
    ErrorFeedback,
)
from horovod_tpu_torch.ops.reduce_op import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
)
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
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
from horovod_tpu_torch.train.buckets import (  # noqa: F401
    BucketPlan,
    plan_buckets,
)
from horovod_tpu_torch.common.topology import (  # noqa: F401
    MeshTopology,
    detect_topology,
)
from horovod_tpu_torch.train.sync_batch_norm import SyncBatchNorm  # noqa: F401
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
# Elastic worker API (reference: horovod.elastic)
from horovod_tpu_torch import elastic  # noqa: F401
# the metrics, diagnostics and serving planes
from horovod_tpu_torch import metrics  # noqa: F401
from horovod_tpu_torch import diagnostics  # noqa: F401
from horovod_tpu_torch import serving  # noqa: F401
