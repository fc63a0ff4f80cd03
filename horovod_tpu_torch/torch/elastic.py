"""Elastic data sampling and state for torch training.

A copy of ``horovod_tpu/torch/elastic.py`` (reference:
``horovod/torch/elastic/sampler.py`` ElasticSampler and
``horovod/torch/elastic/state.py`` TorchState handlers). The sampler
partitions a dataset across the current world and — unlike a plain
DistributedSampler — tracks which indices were already processed this
epoch, so that after an elastic reset the *remaining* work is repartitioned
over the new world instead of being replayed: the same indices as the JAX
package's sampler for the same seed, epoch and recorded batches.
"""

from __future__ import annotations

import math
import random
from typing import Iterator, List, Sequence

from horovod_tpu_torch.common.basics import rank, size
from horovod_tpu_torch.elastic import ObjectState, run  # noqa: F401 (re-export)


class ElasticSampler:
    """Rank-partitioning sampler with processed-index tracking.

    Usage contract (reference docstring, ``sampler.py:24-43``):

    1. include the sampler in the elastic ``State`` (its ``state_dict`` /
       ``load_state_dict`` round-trips through commit/restore),
    2. call :meth:`record_batch` (or :meth:`record_indices`) after each
       processed batch,
    3. call :meth:`set_epoch` at the END of each epoch to clear the
       processed set — calling it at the start would replay partial epochs.
    """

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0) -> None:
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed

        self.epoch = 0
        self.processed_indices: set = set()

        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices: List[int] = []
        self.num_samples = 0
        self.total_size = 0
        self.indices: List[int] = []

        self.reset()

    # -- epoch / progress tracking ------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        self.record_indices(self.get_indices(batch_idx, batch_size))

    def record_indices(self, indices: Sequence[int]) -> None:
        self.processed_indices.update(indices)

    def get_indices(self, batch_idx: int, batch_size: int) -> List[int]:
        start = batch_idx * batch_size
        end = min(start + batch_size, len(self.indices))
        return self.indices[start:end]

    # -- elastic state ------------------------------------------------------
    def state_dict(self) -> dict:
        return dict(epoch=self.epoch,
                    processed_indices=set(self.processed_indices))

    def load_state_dict(self, state_dict: dict) -> None:
        self.epoch = state_dict["epoch"]
        self.processed_indices = set(state_dict["processed_indices"])
        self.reset()

    def reset(self) -> None:
        """Repartition the unprocessed indices over the CURRENT world
        (called after every elastic re-init)."""
        self.num_replicas = size()
        self.rank = rank()
        self.remaining_indices = [i for i in range(len(self.dataset))
                                  if i not in self.processed_indices]
        self.num_samples = int(
            math.ceil(len(self.remaining_indices) / max(self.num_replicas, 1)))
        self.total_size = self.num_samples * self.num_replicas

    # -- sampling -----------------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        self.indices = list(self.remaining_indices)
        if self.shuffle:
            # identical ordering on every rank (seed shared by contract)
            random.Random(self.seed + self.epoch).shuffle(self.indices)
        # pad to a multiple of the world size, then round-robin subsample.
        # Repeat as needed: with fewer remaining indices than ranks (late
        # elastic resume) a single self-copy is not enough — the reference
        # sampler crashes on its length assert here.
        if self.indices:
            while len(self.indices) < self.total_size:
                self.indices += self.indices[:(self.total_size
                                               - len(self.indices))]
        assert len(self.indices) == self.total_size
        self.indices = self.indices[self.rank:self.total_size:self.num_replicas]
        assert len(self.indices) == self.num_samples
        return iter(self.indices)

    def __len__(self) -> int:
        return self.num_samples


class TorchState(ObjectState):
    """Elastic state for torch training (reference:
    ``torch/elastic/state.py`` TorchState with Model/Optimizer/Sampler
    handlers): snapshots model + optimizer ``state_dict``s and sampler
    progress TOGETHER with the scalar attributes — one consistent unit for
    commit/restore, rank-0 broadcast sync (the samplers' processed indices
    are the union over every rank), and (under the elastic driver)
    generation-restart persistence. ``name`` distinguishes concurrent
    states sharing a checkpoint dir.
    """

    def __init__(self, model=None, optimizer=None,
                 name: str = "torch_state", **kwargs) -> None:
        self._model = model
        self._optimizer = optimizer
        self._samplers = {k: v for k, v in kwargs.items()
                          if isinstance(v, ElasticSampler)}
        scalars = {k: v for k, v in kwargs.items()
                   if not isinstance(v, ElasticSampler)}
        super().__init__(name=name, torch_snaps=self._capture(), **scalars)
        # a prior generation's commit was loaded from the driver-managed
        # checkpoint — apply it to the live objects
        self._apply(self.torch_snaps)

    def _capture(self) -> dict:
        import copy
        # state_dict() aliases the live tensors — snapshot deep copies
        return dict(
            model={k: v.detach().clone() if hasattr(v, "detach")
                   else copy.deepcopy(v)
                   for k, v in self._model.state_dict().items()}
            if self._model is not None else None,
            optimizer=copy.deepcopy(self._optimizer.state_dict())
            if self._optimizer is not None else None,
            samplers={k: s.state_dict()
                      for k, s in self._samplers.items()})

    def _apply(self, snaps: dict) -> None:
        if self._model is not None and snaps.get("model"):
            self._model.load_state_dict(snaps["model"])
        if self._optimizer is not None and snaps.get("optimizer"):
            self._optimizer.load_state_dict(snaps["optimizer"])
        for k, s in self._samplers.items():
            snap = snaps.get("samplers", {}).get(k)
            if snap is not None:
                s.load_state_dict(snap)

    def save(self) -> None:
        self.torch_snaps = self._capture()
        super().save()

    def restore(self) -> None:
        super().restore()
        self._apply(self.torch_snaps)

    def sync(self) -> None:
        # rank 0's LIVE model and optimizer are the source of truth;
        # ObjectState.sync broadcasts the snapshot dict with the scalars
        # in one object. Sampler progress is every rank's: the processed
        # indices are unioned over the world first (reference:
        # SamplerStateHandler.sync), so no rank's rows are drawn again.
        # The JAX package keeps rank 0's indices only.
        self.torch_snaps = self._capture()
        if self._samplers and size() > 1:
            from horovod_tpu_torch.train.optimizer import allgather_object
            mine = {k: s.processed_indices for k, s in self._samplers.items()}
            world = allgather_object(mine, name=f"elastic.{self._name}.idx")
            for k in self._samplers:
                self.torch_snaps["samplers"][k]["processed_indices"] = \
                    set().union(*(w[k] for w in world))
        super().sync()
        self._apply(self.torch_snaps)

    def on_reset(self) -> None:
        for s in self._samplers.values():
            s.reset()
        super().on_reset()
