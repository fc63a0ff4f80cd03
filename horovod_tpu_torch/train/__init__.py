"""Training API: ``DistributedOptimizer``, the fused int8 optimizers, the
bucket planner, the overlap engine and the numeric guard."""

from horovod_tpu_torch.train.fused_apply import (  # noqa: F401
    FusedOptimizer,
    FusedOptSpec,
    fused_adam,
    fused_sgd,
)
from horovod_tpu_torch.train.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    distributed_grad,
)
from horovod_tpu_torch.train.overlap import (  # noqa: F401
    bucketed_grad_sync,
    make_overlap_train_step,
    pipelined_accumulate,
)
