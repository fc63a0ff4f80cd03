"""Training API: ``DistributedOptimizer`` and the fused int8 optimizers."""

from horovod_tpu_torch.train.fused_apply import (  # noqa: F401
    FusedOptimizer,
    FusedOptSpec,
    fused_adam,
    fused_sgd,
)
from horovod_tpu_torch.train.optimizer import DistributedOptimizer  # noqa: F401
