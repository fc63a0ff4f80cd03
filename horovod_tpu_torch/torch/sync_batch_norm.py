"""Synchronous BatchNorm of the ``horovod.torch`` surface.

Mirrors ``horovod_tpu/torch/sync_batch_norm.py`` (reference:
``horovod/torch/sync_batch_norm.py:40-218``): a ``torch.nn`` batch norm
(``weight``, ``bias``, ``running_mean``, ``running_var``, torch's
``momentum``, ``None`` for the cumulative average) whose training-mode
statistics span the global batch of the process set's ranks. The math is
the port's :func:`~horovod_tpu_torch.train.sync_batch_norm.batch_norm_train`
over the set seen as an axis: the forward all-reduces ``[Σx, Σx², n]``
(fp32, fp64 for fp64 inputs), the backward the two sums the input
gradient needs. ``weight``'s and ``bias``'s gradients stay this rank's
own sums, as in the reference: the optimizer's gradient averaging reduces
them. The running variance takes the unbiased ``n/(n-1)`` over the global
count.
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.train.sync_batch_norm import batch_norm_train


class SyncBatchNorm(_BatchNorm):
    """Drop-in for the reference's ``hvd.SyncBatchNorm``; eval mode uses
    the running estimates as plain batch norm does."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum=0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 process_set=global_process_set, device=None, dtype=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device=device, dtype=dtype)
        self.process_set = process_set

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input):
        self._check_input_dim(input)
        if self.training and self.track_running_stats \
                and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
        # momentum=None is the cumulative moving average (_BatchNorm's
        # contract): factor 1/num_batches_tracked
        if self.momentum is None:
            factor = 1.0 / float(max(int(self.num_batches_tracked or 1), 1))
        else:
            factor = self.momentum
        if not (self.training or not self.track_running_stats):
            return torch.nn.functional.batch_norm(
                input, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        from horovod_tpu_torch.train.optimizer import _set_axis
        axis = _set_axis(self.process_set)
        c = input.shape[1]
        weight = self.weight if self.weight is not None else \
            input.new_ones(c, dtype=torch.float32)
        bias = self.bias if self.bias is not None else \
            input.new_zeros(c, dtype=torch.float32)
        running = None
        if self.track_running_stats and self.running_mean is not None:
            running = bn.Running(self.running_mean, self.running_var,
                                 1 - factor, factor, True)
        return batch_norm_train(input, weight, bias, (axis,), self.eps, 1,
                                input.dtype, running)[0]
