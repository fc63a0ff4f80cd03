"""flax layers in PyTorch, for the model zoo: the same parameter names,
padding, initializers and numerics as ``flax.linen``, over NCHW.

The JAX zoo is written in flax over NHWC; the port runs NCHW, as PyTorch
takes images (``channels_last`` memory on the card). What that needs:

* :func:`same_pad`: flax's ``"SAME"`` padding puts the odd pixel at the
  END: a 3x3 stride-2 conv on an even input pads (0, 1), not torch's
  (1, 1); a 4x4 stride-1 conv pads (1, 2). :class:`Conv` pads with
  ``F.pad`` where the two sides differ, then convolves unpadded.
* The layers keep flax's parameter names (``kernel``, ``bias``,
  ``scale``, ``embedding``; BN buffers ``mean`` and ``var``), and each
  container names its children as ``nn.compact`` does (:class:`Named`:
  ``Conv_0``, ``BatchNorm_3``, ``BottleneckBlock_7``, ``ConvBN_12``, a
  per-class counter in creation order), so a ``state_dict`` key IS the flax
  path joined with dots, and :func:`from_flax` is a walk, not a table.
* Kernel layouts: a conv's HWIO is stored OIHW, a ``Dense``'s ``[in, out]``
  as ``Linear``'s ``[out, in]``, ``DenseGeneral``'s ``[hidden, heads,
  head_dim]`` and ``[heads, head_dim, hidden]`` as the 2-D ``[out, in]``
  of the same product; ``nn.Partitioned`` boxes are unboxed.
* Initializers: flax's defaults (``lecun_normal`` kernels: a normal
  truncated at two standard deviations, scaled to ``1/fan_in``; zero
  biases), drawn from a seeded ``torch.Generator``: the JAX shapes, not
  the JAX values (values come across through :func:`from_flax`).
* :func:`fold_in`, the dropout key of a step, and :func:`dropout`.
* The classifiers' train step (:func:`make_classifier_step`): the fp32
  cross-entropy over the GLOBAL batch (each rank's share through
  ``mean_from``), the gradient sync over the data axes bucketed through
  :func:`~horovod_tpu_torch.train.overlap.bucketed_grad_sync`, one
  optimizer step; BN buffers update in place.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.tree import flatten_dotted
from horovod_tpu_torch.models.scan_util import multi_step
from horovod_tpu_torch.ops import autograd_collectives as ac
from horovod_tpu_torch.ops.reduce_op import ReduceOp
from horovod_tpu_torch.profiling import train_step
from horovod_tpu_torch.train.overlap import (bucketed_grad_sync,
                                             jax_ordered_parameters)
from horovod_tpu_torch.train.sync_batch_norm import SyncBatchNorm

Padding = Union[str, Sequence[Tuple[int, int]]]

# the data axes a classifier's batch splits over (``shard_batch``'s rows)
DATA_AXES = ("dp", "ep")


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's (and XLA's) ``"SAME"`` padding of one spatial dim: the output
    is ``ceil(size / stride)``, the padding it needs split with the odd
    pixel at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _truncated_normal_(t: torch.Tensor, std: float,
                       generator: torch.Generator) -> None:
    # flax's truncated_normal: a unit normal cut at ±2, then scaled by the
    # std of the variance-scaling initializer over the cut's own std
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(std / 0.87962566103423978)


class Named(nn.Module):
    """A container that names its children as flax ``nn.compact`` does:
    ``<ClassName>_<k>``, k counting that class's children in creation
    order."""

    def child(self, module: nn.Module, name: Optional[str] = None
              ) -> nn.Module:
        if name is None:
            counts = self.__dict__.setdefault("_flax_counts", {})
            cls = type(module).__name__
            name = f"{cls}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
        self.add_module(name, module)
        return module


class Conv(nn.Module):
    """``nn.Conv``: ``kernel`` stored ``[out, in, kh, kw]``, computed in
    ``dtype``; ``padding`` ``"SAME"``, ``"VALID"`` or explicit
    ``[(lo, hi), (lo, hi)]``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int], strides=(1, 1),
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.strides, self.padding, self.dtype = tuple(strides), padding, dtype
        self.kernel = nn.Parameter(torch.empty(
            features, in_features, *kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device)) \
            if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.kernel.shape[1:])
        _truncated_normal_(self.kernel.data, math.sqrt(1.0 / fan_in),
                           generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def _pads(self, x) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        k = self.kernel.shape[2:]
        if self.padding == "SAME":
            return tuple(same_pad(x.shape[2 + i], k[i], self.strides[i])
                         for i in range(2))
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = self._pads(x)
        x = x.to(self.dtype)
        if t == b and l == r:
            pad = (t, l)
        else:
            x, pad = F.pad(x, (l, r, t, b)), 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias, self.strides,
                        pad)


class Dense(nn.Module):
    """``nn.Dense`` (and ``DenseGeneral`` flattened to 2-D): ``kernel``
    stored ``[out, in]``, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, use_bias=True,
                 dtype=torch.float32, device=None, init_std=None):
        super().__init__()
        self.dtype, self.init_std = dtype, init_std
        self.kernel = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device)) \
            if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init_std is None:      # lecun_normal over [in, out]
            _truncated_normal_(self.kernel.data,
                               math.sqrt(1.0 / self.kernel.shape[1]),
                               generator)
        else:                          # nn.initializers.normal(init_std)
            self.kernel.data.normal_(0.0, self.init_std, generator=generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """``bias=False`` leaves the bias out (a tp-partial product adds
        it after the sum over tp)."""
        b = self.bias.to(self.dtype) if bias and self.bias is not None \
            else None
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype), b)


class Embed(nn.Module):
    """``nn.Embed``: ``embedding [num, features]``; a lookup cast to
    ``dtype``. ``init_std`` None is flax's default, a normal of std
    ``1/sqrt(features)``."""

    def __init__(self, num: int, features: int, dtype=torch.float32,
                 device=None, init_std=None):
        super().__init__()
        self.dtype, self.init_std = dtype, init_std
        self.embedding = nn.Parameter(torch.empty(num, features,
                                                  device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.init_std or 1.0 / math.sqrt(self.embedding.shape[1])
        self.embedding.data.normal_(0.0, std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=float32)``: epsilon 1e-6 (torch's default is
    1e-5), fp32 moments as ``E[x²] − E[x]²`` clipped at 0, fp32 output."""

    def __init__(self, features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        return (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) \
            + self.bias


class BatchNorm(SyncBatchNorm):
    """``nn.BatchNorm(momentum=0.9)`` of the zoo over NCHW: fp32 moments
    (reduced over ``axes``, the model's data axes), the BIASED batch
    variance in the running average, output in ``dtype``."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype=torch.float32, axes=(), device=None,
                 scale_init: float = 1.0):
        super().__init__(features, momentum=0.9, epsilon=epsilon,
                         dtype=dtype, axes=axes, channel_dim=1,
                         unbiased_running_var=False, device=device,
                         scale_init=scale_init)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.data.fill_(self.scale_init)
        self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)


def init_state(model: nn.Module, seed: Union[int, torch.Generator] = 0
               ) -> nn.Module:
    """Draw every parameter of ``model`` with flax's initializers (and
    reset the BN running statistics), from ``seed`` or a generator on the
    model's device, in module order. Returns the model."""
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        dev = next(model.parameters()).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if m is not model and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
    return model


# -- flax trees → state_dicts --------------------------------------------------

def _unbox(leaf):
    """An ``nn.Partitioned`` box → its array (flax's ``unbox``)."""
    return leaf.unbox() if hasattr(leaf, "unbox") else leaf


def _flax_leaf(key: str, a: np.ndarray) -> np.ndarray:
    """One flax leaf in the port's layout, from its name and rank alone."""
    name = key.rsplit(".", 1)[-1]
    if name == "kernel":
        if a.ndim == 4:                                   # HWIO → OIHW
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 3 and key.endswith("out.kernel"):    # [h, d, M]
            return a.reshape(-1, a.shape[-1]).T
        if a.ndim == 3:                                   # [M, h, d]
            return a.reshape(a.shape[0], -1).T
        return a.T                                        # [in, out]
    if name == "bias" and a.ndim == 2:                    # [h, d]
        return a.reshape(-1)
    return a


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """A flax variable tree (``params``, and ``batch_stats`` for the BN
    running averages, as numpy arrays or anything ``np.asarray`` takes) →
    the ``state_dict`` of the port's module of the same model: every key
    the flax path joined with dots, every kernel in the port's layout."""
    out = {}
    for tree in (params, batch_stats):
        for key, leaf in flatten_dotted(tree).items():
            a = np.asarray(_unbox(leaf), dtype=np.float32)
            out[key] = torch.from_numpy(np.array(_flax_leaf(key, a)))
    return out


# -- dropout -------------------------------------------------------------------

def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def fold_in(seed: int, index: int) -> int:
    """The port's ``jax.random.fold_in``: a generator seed (63 bits) from a
    ``(seed, index)`` pair; folding again (an index into a folded seed)
    stays in range."""
    return _mix64((_mix64(int(seed) & 0xFFFFFFFFFFFFFFFF) + int(index))
                  & 0xFFFFFFFFFFFFFFFF) >> 1


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``nn.Dropout``: keep with probability ``1 − rate``, kept values
    scaled by ``1/(1 − rate)``. The mask is drawn from ``generator``
    (torch's default one when None)."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# -- remat ---------------------------------------------------------------------

def remat(block: nn.Module, *args):
    """``block(*args)`` under ``torch.utils.checkpoint`` (not reentrant):
    activations recomputed in the backward, the same parameter names. The
    recompute leaves the BN running averages alone: the forward updated
    them once."""
    bns = [m for m in block.modules() if isinstance(m, SyncBatchNorm)]

    @contextlib.contextmanager
    def recompute():
        for m in bns:
            m.recomputing = True
        try:
            yield
        finally:
            for m in bns:
                m.recomputing = False

    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute()))


# -- the classifiers' train step -----------------------------------------------

def data_axes(mesh):
    """The data axes a classifier syncs over: dp, and ep when it is live.
    The zoo's CNNs are data-parallel only."""
    if mesh is None:
        return []
    other = [a for a in ("pp", "sp", "tp") if mesh.shape[a] > 1]
    if other:
        raise ValueError(f"the CNN zoo trains data-parallel over dp (and "
                         f"ep) only; the mesh {mesh} has {other} live")
    return [mesh.axis(a) for a in DATA_AXES
            if a == "dp" or mesh.shape[a] > 1]


def data_index(mesh) -> int:
    """This rank's block of the global batch (``shard_batch``'s order:
    dp outermost)."""
    idx = 0
    for ax in data_axes(mesh):
        idx = idx * ax.size + ax.index
    return idx


def check_model(model: nn.Module, mesh) -> None:
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError(
            f"the model was built with the mesh {getattr(model, 'mesh', None)}"
            f" and the step with {mesh}: build both with one (its BN layers "
            f"reduce their moments over the mesh's data axes)")


def sync_grads(model: nn.Module, axes) -> None:
    """Sum every parameter's gradient over ``axes`` (each rank's backward
    gave its share), bucketed, in the JAX flatten order."""
    if not axes:
        return
    _, params = jax_ordered_parameters(model)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for ax in axes:
        grads = bucketed_grad_sync(grads, ax, op=ReduceOp.SUM)
    for p, g in zip(params, grads):
        p.grad = g


def make_classifier_step(model: nn.Module, mesh, scan_steps: int = 1,
                         dropout_seed: Optional[int] = None) -> Callable:
    """``step(model, optimizer, images, labels[, step_idx]) -> (model,
    optimizer, loss)``: forward in train mode on this rank's block, the
    fp32 ``softmax_cross_entropy(...).mean()`` over the global batch, the
    gradient sync, one optimizer step, each in its span
    (:func:`~horovod_tpu_torch.profiling.train_step`). ``dropout_seed``
    (VGG, Inception) adds ``step_idx``, folded into the dropout generator
    with this rank's data block, and chains indexed (:func:`multi_step`)."""
    axes = data_axes(mesh)
    check_model(model, mesh)
    indexed = dropout_seed is not None

    def one_step(model, optimizer, images, labels, step_idx=0):
        check_model(model, mesh)
        optimizer.zero_grad(set_to_none=True)
        model.train()
        kw = {}
        if indexed:
            gen = torch.Generator(device=images.device)
            gen.manual_seed(fold_in(fold_in(dropout_seed, step_idx),
                                    data_index(mesh)))
            kw["generator"] = gen

        def forward():
            logits = model(images, **kw)
            loss = F.cross_entropy(logits.float(), labels.long())
            for ax in axes:
                loss = ac.mean_from(loss, ax)
            return loss, loss

        loss = train_step(forward, lambda: sync_grads(model, axes),
                          optimizer.step)
        return model, optimizer, loss.detach()

    chain = multi_step(one_step, n_carry=2, scan_steps=scan_steps,
                       indexed=indexed)

    def step(model, optimizer, images, labels, step_idx=0):
        if indexed:
            return chain(model, optimizer, images, labels, step_idx)
        return chain(model, optimizer, images, labels)

    return step
