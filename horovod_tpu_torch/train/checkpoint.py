"""``Checkpointer``: the native sharded store under its training-API name.

Mirrors ``horovod_tpu/train/checkpoint.py``, whose ``Checkpointer`` is
:class:`~horovod_tpu_torch.checkpoint.ShardedCheckpointer`. Its optional
orbax wrapper (``OrbaxCheckpointer``) has no torch counterpart here.
"""

from horovod_tpu_torch.checkpoint import CheckpointError  # noqa: F401
from horovod_tpu_torch.checkpoint import ShardedCheckpointer

# The native store is the default checkpointer.
Checkpointer = ShardedCheckpointer
