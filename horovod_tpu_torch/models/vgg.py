"""VGG-16, the gradient-bandwidth stress case of the reference's benchmark
table (~138M parameters, two 4096-wide FC layers).

Mirrors ``horovod_tpu/models/vgg.py``: ``VGG`` (SAME 3x3 convs with bias,
2x2 max-pools, two 4096 FC layers with dropout, an fp32 head),
``VGG16_STAGES``, ``VGG16``, ``create_vgg_state`` and
``make_vgg_train_step``, over NCHW with flax's layer semantics and names
(:mod:`horovod_tpu_torch.models._flax`).

The flatten: the JAX model flattens NHWC, so the first FC kernel's rows
are in ``(h, w, c)`` order. The port flattens ``x.permute(0, 2, 3, 1)``,
the same order, so :func:`from_flax` copies that kernel as it is (only
transposed to ``[out, in]``). flax infers that layer's input width from
its first call; the port needs ``image_size`` to build it.

Dropout draws from a ``torch.Generator`` seeded with ``fold_in``
``(dropout_seed, step_idx)`` and this rank's data block: fresh masks each
step and repeatable from the seed, but not JAX's masks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models._flax import (Conv, Dense, Named, data_axes,
                                            dropout, from_flax,  # noqa: F401
                                            init_state, make_classifier_step)

# (convs per stage, channels): the classic "D" configuration
VGG16_STAGES: Sequence = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class VGG(Named):
    """``forward(images [B, 3, H, W], generator=None) -> logits``;
    ``Conv_0..``, ``Dense_0..2`` as flax names them. ``device`` and
    ``mesh`` as :class:`~horovod_tpu_torch.models.resnet.ResNet` (VGG has
    no BN; the mesh is the train step's)."""

    def __init__(self, stages: Sequence = VGG16_STAGES,
                 num_classes: int = 1000, dtype=torch.bfloat16,
                 dropout: float = 0.5, image_size: int = 224, device=None,
                 mesh=None):
        super().__init__()
        dev = resolve_device(device)
        data_axes(mesh)
        self.stages, self.num_classes = tuple(stages), num_classes
        self.dtype, self.dropout, self.mesh = dtype, dropout, mesh
        ch, size = 3, image_size
        for n_convs, width in self.stages:
            for _ in range(n_convs):
                self.child(Conv(ch, width, (3, 3), dtype=dtype, device=dev))
                ch = width
            size //= 2
        width = ch * size * size
        for _ in range(2):
            self.child(Dense(width, 4096, dtype=dtype, device=dev))
            width = 4096
        self.child(Dense(width, num_classes, dtype=torch.float32, device=dev))
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        i = 0
        for n_convs, _ in self.stages:
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for k in range(2):
            x = F.relu(getattr(self, f"Dense_{k}")(x))
            x = dropout(x, self.dropout, self.training, generator)
        return self.Dense_2(x)


def VGG16(num_classes: int = 1000, dtype=torch.bfloat16, device=None,
          mesh=None, image_size: int = 224) -> VGG:
    return VGG(VGG16_STAGES, num_classes, dtype, image_size=image_size,
               device=device, mesh=mesh)


def create_vgg_state(model: VGG, seed: Union[int, torch.Generator] = 0
                     ) -> VGG:
    """Draw the parameters with flax's initializers, in place."""
    return init_state(model, seed)


def make_vgg_train_step(model: VGG, mesh=None, dropout_seed: int = 0,
                        scan_steps: int = 1):
    """``step(model, optimizer, images, labels, step_idx=0) -> (model,
    optimizer, loss)``, as ``make_resnet_train_step``; ``step_idx`` is
    folded into the dropout generator, so every step draws a fresh mask
    (pass an incrementing value), and chained step ``i`` of
    ``scan_steps`` uses ``step_idx * scan_steps + i``."""
    return make_classifier_step(model, mesh, scan_steps, dropout_seed)
