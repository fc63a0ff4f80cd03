"""Durable sharded checkpoints of torch state.

Mirrors ``horovod_tpu/checkpoint/`` with the same on-disk format, so a
checkpoint written by either package restores in the other:

* :class:`ShardedCheckpointer` — async two-phase-commit store: each rank
  writes only its shards (npz + sha256 marker), rank 0 writes the
  manifest and atomically renames ``step_N.tmp`` → ``step_N``; restore
  reassembles global leaves and places them on the *current* layout.
* :mod:`~horovod_tpu_torch.checkpoint.format` — the on-disk contract
  (spec version, manifests, shard markers, GC helpers).
* :mod:`~horovod_tpu_torch.checkpoint.metrics` — save/restore bytes and
  duration histograms + inflight gauge on the port's metrics registry.
* :mod:`~horovod_tpu_torch.checkpoint.state` — the torch state a run saves
  (``model_state``, ``optimizer_state``, ``init_optimizer_state``) and
  :class:`Shard`, a rank's block of a leaf split over a mesh.

``train.callbacks.CheckpointCallback`` wires the store into a training
loop. The elastic ``ObjectState`` commits durably through the same store
(:mod:`horovod_tpu_torch.elastic`, ``ObjectState(durable=True)`` or the
``HVD_TPU_ELASTIC_DURABLE`` knob).
"""

from horovod_tpu_torch.checkpoint.format import CheckpointError  # noqa: F401
from horovod_tpu_torch.checkpoint.state import (  # noqa: F401
    Shard,
    init_optimizer_state,
    load_model_state,
    mesh_shard,
    model_state,
    optimizer_state,
)
from horovod_tpu_torch.checkpoint.store import (  # noqa: F401
    ShardedCheckpointer,
)

__all__ = ["CheckpointError", "ShardedCheckpointer", "Shard",
           "init_optimizer_state", "load_model_state", "mesh_shard",
           "model_state", "optimizer_state"]
