"""Inception V3, the last of the reference's published benchmark table.

Mirrors ``horovod_tpu/models/inception.py``: ``ConvBN`` (BN epsilon 1e-3),
the blocks ``InceptionA/B/C`` and ``ReductionA/B`` with their VALID/SAME
mix (1x7 and 7x1 included), the 3x3/s1 SAME average pool that counts the
zero padding (flax divides by 9), the VALID max-pools, dropout before the
fp32 head (no auxiliary head, as the JAX model), ``InceptionV3``,
``create_inception_state`` and ``make_inception_train_step``, over NCHW
with flax's layer semantics (:mod:`horovod_tpu_torch.models._flax`).

Names follow flax's ``nn.compact`` creation order, in which a nested call
``c(a)(c(b)(x))`` creates the OUTER conv first: each block below lists its
``ConvBN``s in that order (``_SPECS``) and its branches as chains of those
indices, applied from the last. BN moments are reduced over the mesh's
data axes, as in :mod:`~horovod_tpu_torch.models.resnet`; dropout as in
:mod:`~horovod_tpu_torch.models.vgg`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models._flax import (BatchNorm, Conv, Dense, Named,
                                            data_axes, dropout,
                                            from_flax,  # noqa: F401
                                            init_state, make_classifier_step)


class ConvBN(Named):
    """conv (no bias) + BN (epsilon 1e-3) + relu."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides=(1, 1), padding="SAME",
                 dtype=torch.bfloat16, axes=(), device=None):
        super().__init__()
        self.child(Conv(in_features, features, kernel, strides, padding,
                        use_bias=False, dtype=dtype, device=device))
        self.child(BatchNorm(features, 1e-3, dtype, axes, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


# Each block's ConvBNs in flax's creation order: (input, features, kernel,
# strides, padding), with "in" the block's input width and "p" its
# parameter (pool features or c7). Then its branches, concatenated in
# order: a chain of ConvBN indices (applied last index first), on the
# input or on the block's pool ("avg" before the chain, "max" alone).
_SPECS = {
    "InceptionA": (
        [("in", 64, (1, 1)), (48, 64, (5, 5)), ("in", 48, (1, 1)),
         (96, 96, (3, 3)), (64, 96, (3, 3)), ("in", 64, (1, 1)),
         ("in", "p", (1, 1))],
        [((0,), None), ((1, 2), None), ((3, 4, 5), None), ((6,), "avg")]),
    "ReductionA": (
        [("in", 384, (3, 3), (2, 2), "VALID"),
         (96, 96, (3, 3), (2, 2), "VALID"), (64, 96, (3, 3)),
         ("in", 64, (1, 1))],
        [((0,), None), ((1, 2, 3), None), ((), "max")]),
    "InceptionB": (
        [("in", 192, (1, 1)), ("p", 192, (7, 1)), ("p", "p", (1, 7)),
         ("in", "p", (1, 1)), ("p", 192, (1, 7)), ("p", "p", (7, 1)),
         ("p", "p", (1, 7)), ("p", "p", (7, 1)), ("in", "p", (1, 1)),
         ("in", 192, (1, 1))],
        [((0,), None), ((1, 2, 3), None), ((4, 5, 6, 7, 8), None),
         ((9,), "avg")]),
    "ReductionB": (
        [(192, 320, (3, 3), (2, 2), "VALID"), ("in", 192, (1, 1)),
         (192, 192, (3, 3), (2, 2), "VALID"), (192, 192, (7, 1)),
         (192, 192, (1, 7)), ("in", 192, (1, 1))],
        [((0, 1), None), ((2, 3, 4, 5), None), ((), "max")]),
}


class _Block(Named):
    """A block of ``_SPECS``: its ConvBNs, then its branches."""

    def __init__(self, in_features: int, param: int = 0,
                 dtype=torch.bfloat16, axes=(), device=None):
        super().__init__()
        convs, self.branches = _SPECS[type(self).__name__]
        self.out_features = 0
        width = {"in": in_features, "p": param}
        for spec in convs:
            i, o, k, *rest = spec
            self.child(ConvBN(width.get(i, i), width.get(o, o), k, *rest,
                              dtype=dtype, axes=axes, device=device))
        for chain, pool in self.branches:
            if chain:
                self.out_features += self.convbn(chain[0]).Conv_0.kernel \
                    .shape[0]
            else:
                self.out_features += in_features

    def convbn(self, k: int) -> ConvBN:
        return getattr(self, f"ConvBN_{k}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for chain, pool in self.branches:
            y = _avg_pool_same(x) if pool == "avg" else \
                _max_pool(x) if pool == "max" else x
            for k in reversed(chain):
                y = self.convbn(k)(y)
            outs.append(y)
        return torch.cat(outs, 1)


class InceptionA(_Block):
    """35x35 blocks: 1x1, 5x5, double 3x3 and pooled branches."""


class ReductionA(_Block):
    """35x35 → 17x17."""


class InceptionB(_Block):
    """17x17 blocks with factorized 7x7 convolutions."""


class ReductionB(_Block):
    """17x17 → 8x8."""


class InceptionC(Named):
    """8x8 blocks with split 1x3/3x1 branches."""

    def __init__(self, in_features: int, dtype=torch.bfloat16, axes=(),
                 device=None):
        super().__init__()
        for i, o, k in ((in_features, 320, (1, 1)),
                        (in_features, 384, (1, 1)), (384, 384, (1, 3)),
                        (384, 384, (3, 1)), (448, 384, (3, 3)),
                        (in_features, 448, (1, 1)), (384, 384, (1, 3)),
                        (384, 384, (3, 1)), (in_features, 192, (1, 1))):
            self.child(ConvBN(i, o, k, dtype=dtype, axes=axes,
                              device=device))
        self.out_features = 2048

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = [getattr(self, f"ConvBN_{k}") for k in range(9)]
        s = c[1](x)
        d = c[4](c[5](x))
        return torch.cat([c[0](x), c[2](s), c[3](s), c[6](d), c[7](d),
                          c[8](_avg_pool_same(x))], 1)


class InceptionV3(Named):
    """``forward(images [B, 3, H, W], generator=None) -> logits``; 299x299
    is the native size, 95x95 the smallest the VALID stem and the two
    reductions accept. ``device`` and ``mesh`` as
    :class:`~horovod_tpu_torch.models.resnet.ResNet`."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 dropout: float = 0.5, device=None, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes, self.dtype = num_classes, dtype
        self.dropout, self.mesh = dropout, mesh
        kw = dict(dtype=dtype, axes=data_axes(mesh), device=dev)
        for i, o, k, s, p in ((3, 32, (3, 3), (2, 2), "VALID"),
                              (32, 32, (3, 3), (1, 1), "VALID"),
                              (32, 64, (3, 3), (1, 1), "SAME"),
                              (64, 80, (1, 1), (1, 1), "VALID"),
                              (80, 192, (3, 3), (1, 1), "VALID")):
            self.child(ConvBN(i, o, k, s, p, **kw))
        width = 192
        blocks = [InceptionA(width, 32, **kw)]
        blocks.append(InceptionA(blocks[-1].out_features, 64, **kw))
        blocks.append(InceptionA(blocks[-1].out_features, 64, **kw))
        blocks.append(ReductionA(blocks[-1].out_features, **kw))
        for c7 in (128, 160, 160, 192):
            blocks.append(InceptionB(blocks[-1].out_features, c7, **kw))
        blocks.append(ReductionB(blocks[-1].out_features, **kw))
        for _ in range(2):
            blocks.append(InceptionC(blocks[-1].out_features, **kw))
        for b in blocks:
            self.child(b)
        self.block_names = [n for n in self._modules
                            if not n.startswith("ConvBN")]
        self.child(Dense(blocks[-1].out_features, num_classes,
                         dtype=torch.float32, device=dev))
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = _max_pool(x)
        x = _max_pool(self.ConvBN_4(self.ConvBN_3(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean((2, 3), dtype=torch.float32).to(x.dtype)
        x = dropout(x, self.dropout, self.training, generator)
        return self.Dense_0(x)


def create_inception_state(model: InceptionV3,
                           seed: Union[int, torch.Generator] = 0
                           ) -> InceptionV3:
    """Draw the parameters with flax's initializers and reset the BN
    statistics, in place."""
    return init_state(model, seed)


def make_inception_train_step(model: InceptionV3, mesh=None,
                              dropout_seed: int = 0, scan_steps: int = 1):
    """``step(model, optimizer, images, labels, step_idx=0) -> (model,
    optimizer, loss)``: as ``make_resnet_train_step`` (BN buffers update
    in place), with ``step_idx`` folded into the dropout generator as in
    ``make_vgg_train_step``."""
    return make_classifier_step(model, mesh, scan_steps, dropout_seed)
