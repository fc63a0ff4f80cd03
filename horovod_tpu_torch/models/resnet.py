"""ResNet-50/101 (v1.5), the reference's headline benchmark family.

Mirrors ``horovod_tpu/models/resnet.py``: ``BottleneckBlock`` (the last
BN's scale initialised to zero, a projection where the width or the
stride changes), ``space_to_depth`` in the JAX channel order, ``ResNet``
with the textbook 7x7/s2 stem or the MLPerf space-to-depth stem, the
3x3/s2 max-pool padded with −inf, ``remat`` per block, ``ResNet50``,
``ResNet101``, ``create_resnet_state`` and ``make_resnet_train_step``.

The port runs NCHW (``channels_last`` memory on the card) with flax's
layer semantics (:mod:`horovod_tpu_torch.models._flax`: SAME padding with
the odd pixel at the end, bf16 compute with fp32 BN statistics and an fp32
head), and names every submodule as flax does, so a ``state_dict`` key is
the flax path (``BottleneckBlock_3.Conv_1.kernel``) and :func:`from_flax`
carries a JAX model's params and ``batch_stats`` across.

The JAX step takes the whole batch sharded over ``dp`` under GSPMD, so its
BN moments are the GLOBAL batch's. Here each rank holds its block
(``hvd.shard_batch(images, labels, mesh)``, the JAX ``batch_sharding``),
and a model built with the ``mesh`` reduces its BN moments over the data
axes (:class:`~horovod_tpu_torch.train.sync_batch_norm.SyncBatchNorm`
with flax's biased running variance): the same global statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models._flax import (BatchNorm, Conv, Dense, Named,
                                            data_axes, from_flax,  # noqa: F401
                                            init_state, make_classifier_step,
                                            remat)


class BottleneckBlock(Named):
    """1x1, 3x3 (the stride), 1x1 x4 convs, each with BN; a projection of
    the residual where the width or the stride changes."""

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1), dtype=torch.bfloat16,
                 axes=(), device=None):
        super().__init__()
        self.needs_proj = (in_features != filters * 4
                           or tuple(strides) != (1, 1))

        def conv(i, o, k, s=(1, 1)):
            return self.child(Conv(i, o, k, s, use_bias=False, dtype=dtype,
                                   device=device))

        def bn(c, scale_init=1.0):
            return self.child(BatchNorm(c, 1e-5, dtype, axes, device,
                                        scale_init))

        conv(in_features, filters, (1, 1))
        bn(filters)
        conv(filters, filters, (3, 3), strides)
        bn(filters)
        conv(filters, filters * 4, (1, 1))
        bn(filters * 4, scale_init=0.0)
        if self.needs_proj:
            conv(in_features, filters * 4, (1, 1), strides)
            bn(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.needs_proj else x
        return F.relu(y + residual)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``[B, C, H, W] -> [B, C·b·b, H/b, W/b]`` with output channel
    ``(i·b + j)·C + c`` for pixel ``(i, j)`` of a block, the JAX order over
    NHWC (``F.pixel_unshuffle`` gives ``c·b² + i·b + j``)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // block, block, W // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        B, C * block * block, H // block, W // block)


class ResNet(Named):
    """``stage_sizes`` bottleneck stages of widths 64·2^i; ``stem="conv"``
    (7x7/s2, pad 3) or ``"s2d"`` (space-to-depth(2), then a 4x4/s1 SAME
    conv over 12 channels: the same receptive field and output shape).
    ``forward(images [B, 3, H, W]) -> logits [B, num_classes]`` (fp32).

    ``device=None`` puts it on this process's card (``channels_last``) and
    raises when there is none; ``mesh`` makes its BN layers reduce their
    moments over the mesh's data axes. Parameters are allocated
    uninitialised: :func:`create_resnet_state` draws them, or load a
    :func:`from_flax` ``state_dict``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype=torch.bfloat16, stem: str = "conv",
                 remat: bool = False, device=None, mesh=None):
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(
                f"unknown stem {stem!r}; expected 'conv' or 's2d'")
        dev = resolve_device(device)
        self.stage_sizes, self.num_classes = list(stage_sizes), num_classes
        self.dtype, self.stem, self.remat, self.mesh = dtype, stem, remat, mesh
        axes = data_axes(mesh)
        if stem == "s2d":
            self.child(Conv(12, 64, (4, 4), (1, 1), "SAME", use_bias=False,
                            dtype=dtype, device=dev))
        else:
            self.child(Conv(3, 64, (7, 7), (2, 2), [(3, 3), (3, 3)],
                            use_bias=False, dtype=dtype, device=dev))
        self.child(BatchNorm(64, 1e-5, dtype, axes, dev))
        width, idx = 64, 0
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                self.child(BottleneckBlock(width, 64 * 2 ** i, strides, dtype,
                                           axes, dev),
                           name=f"BottleneckBlock_{idx}")
                width, idx = 64 * 2 ** i * 4, idx + 1
        self.n_blocks = idx
        self.child(Dense(width, num_classes, dtype=torch.float32, device=dev))
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.n_blocks):
            block = getattr(self, f"BottleneckBlock_{i}")
            x = remat(block, x) if self.remat and torch.is_grad_enabled() \
                else block(x)
        x = x.mean((2, 3), dtype=torch.float32).to(x.dtype)
        return self.Dense_0(x)


def ResNet50(num_classes: int = 1000, dtype=torch.bfloat16,
             stem: str = "conv", remat: bool = False, device=None,
             mesh=None) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes, dtype, stem, remat, device, mesh)


def ResNet101(num_classes: int = 1000, dtype=torch.bfloat16,
              stem: str = "conv", remat: bool = False, device=None,
              mesh=None) -> ResNet:
    return ResNet([3, 4, 23, 3], num_classes, dtype, stem, remat, device,
                  mesh)


def create_resnet_state(model: ResNet,
                        seed: Union[int, torch.Generator] = 0) -> ResNet:
    """Draw the parameters with flax's initializers (JAX's shapes, not its
    values) and reset the BN statistics (mean 0, var 1), in place."""
    return init_state(model, seed)


def make_resnet_train_step(model: ResNet, mesh=None, scan_steps: int = 1):
    """``step(model, optimizer, images, labels) -> (model, optimizer,
    loss)``: the forward in train mode on this rank's block, fp32
    ``softmax_cross_entropy(...).mean()`` over the global batch, the
    gradient synced over the data axes (bucketed) when there is a mesh,
    one optimizer step; parameters, BN buffers and optimizer state update
    in place. ``model`` must be built with ``mesh``. ``scan_steps > 1``
    chains that many steps on the SAME batch; the loss is the last one's.
    The JAX step's SGD-momentum is ``torch.optim.SGD(lr, momentum)``."""
    return make_classifier_step(model, mesh, scan_steps)
