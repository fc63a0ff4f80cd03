"""Fused dequantize + optimizer apply: the int8 error-feedback gradient tail
in two kernel passes a parameter.

Mirrors ``horovod_tpu/train/fused_apply.py`` (``FusedOptSpec``,
``fused_sgd``, ``fused_adam``, ``FusedOptState``, ``_to_blocks``,
``_from_blocks`` and the ``identity_sync`` regime of
``make_fused_transform``), as a ``torch.optim.Optimizer``. Use it through
:func:`horovod_tpu_torch.DistributedOptimizer`::

    opt = hvd.DistributedOptimizer(hvd.fused_adam(1e-3),
                                   model.named_parameters(),
                                   compression=hvd.ErrorFeedback(
                                       hvd.Compression.int8))

Each step, for every parameter with a gradient: ``block_quantize_ef`` makes
the int8 codes of ``grad + residual`` and the new residual in one pass,
then ``fused_sgd_apply`` or ``fused_adam_apply`` consumes the codes
directly (dequantize, moments and delta in one pass), and the delta is
added to the parameter. That is the ``identity_sync`` regime (one process,
no axis): the codes never leave the card. The JAX package's two
multi-device regimes densify instead, as there: ``block_quantize_ef``, then
``block_dequantize``, then the sync (with ``axis=``, each blocked gradient
reduced along the mesh axis by ``preduce``; with ``size() > 1`` and no
axis, the eager bucketed allreduce of the optimizer module, the codec on
the wire), then the optimizer update on the synced fp32 blocks in plain
PyTorch (``_apply_sgd_blocks``/``_apply_adam_blocks``). The fused
``fused_sgd``/``fused_adam`` kernels run in ``identity_sync`` only, as in
the JAX package. ``backward_passes_per_step > 1`` folds the passes'
gradients into their mean first (``optax.MultiSteps``).

State per parameter, mirroring ``FusedOptState``: ``count`` and, in the
codec's blocked ``[n_blocks, block]`` fp32 layout, ``mom`` (SGD momentum
or Adam's first moment), ``vel`` (Adam's second moment) and ``residual``
(the EF carry); each step replaces them with the kernels' outputs.
Hyperparameters come from the parameter group (``lr``, ``momentum``,
``betas``, ``eps``), so a learning-rate scheduler works as with any torch
optimizer.
"""

from __future__ import annotations

from typing import Any, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.process_sets import (ProcessSet,
                                                   global_process_set)
from horovod_tpu_torch.common.tree import flatten_dotted
from horovod_tpu_torch.compression.error_feedback import ErrorFeedback
from horovod_tpu_torch.compression.quantizers import BlockInt8Quantizer
from horovod_tpu_torch.ops.quantize import (_h, block_dequantize,
                                            block_quantize,
                                            block_quantize_ef,
                                            fused_adam_apply, fused_sgd_apply)
from horovod_tpu_torch.ops.reduce_op import Average, ReduceOp, Sum


class FusedOptSpec(NamedTuple):
    """Descriptor of a fusable optimizer; build it with :func:`fused_sgd`
    or :func:`fused_adam` and hand it to ``DistributedOptimizer``."""

    kind: str  # "sgd" | "adam"
    lr: Any
    momentum: Any = 0.0
    b1: Any = 0.9
    b2: Any = 0.999
    eps: Any = 1e-8

    def to_torch(self, params) -> torch.optim.Optimizer:
        """The unfused torch equivalent (optax's ``sgd``/``adam``)."""
        if self.kind == "sgd":
            return torch.optim.SGD(params, lr=self.lr, momentum=self.momentum)
        return torch.optim.Adam(params, lr=self.lr, betas=(self.b1, self.b2),
                                eps=self.eps)


def fused_sgd(learning_rate, momentum=0.0) -> FusedOptSpec:
    """SGD (+ momentum) through the fused dequantize + apply kernels
    (optax.sgd numerics)."""
    return FusedOptSpec("sgd", learning_rate, momentum=momentum)


def fused_adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8) -> FusedOptSpec:
    """Adam through the fused dequantize + apply kernel (optax.adam
    numerics, bias correction included)."""
    return FusedOptSpec("adam", learning_rate, b1=b1, b2=b2, eps=eps)


def _to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` flattened to fp32 ``[n_blocks, block]``, zero-padded at the end;
    a view of ``x`` when it is contiguous fp32 and fills its blocks."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, block)


def _from_blocks(blocks: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return blocks.reshape(-1)[:leaf.numel()].view(leaf.shape).to(leaf.dtype)


def _bias_corrections(b1, b2, t: int) -> Tuple[float, float]:
    """``1 − βₖᵗ`` in fp32, as the JAX package computes them; a float64
    computed in Python would differ in the last bit."""
    tf = np.float32(t)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** tf),
            float(one - np.float32(b2) ** tf))


def _split_named(params) -> Tuple[list, Optional[list]]:
    """Parameters given as tensors (or groups), or as ``(name, tensor)``
    pairs like ``model.named_parameters()``: ``(params, names or None)``."""
    params = list(params)
    if params and isinstance(params[0], tuple):
        return [p for _, p in params], [n for n, _ in params]
    return params, None


class FusedOptimizer(torch.optim.Optimizer):
    """``fused_sgd``/``fused_adam`` over the block-int8 codec as a torch
    optimizer; :func:`DistributedOptimizer` builds it from a
    :class:`FusedOptSpec`. Raises on the combinations the JAX package
    refuses: a codec that is not block-int8, and ``op`` other than
    Sum/Average. ``axis``/``process_set`` pick the sync regime (module
    doc)."""

    def __init__(self, params, spec: FusedOptSpec, compression=None,
                 op: ReduceOp = Average, axis=None,
                 process_set: ProcessSet = global_process_set,
                 backward_passes_per_step: int = 1):
        from horovod_tpu_torch.train.optimizer import GradAccumulator
        if spec.kind not in ("sgd", "adam"):
            raise ValueError(f"unknown fused optimizer kind {spec.kind!r}")
        ef = isinstance(compression, ErrorFeedback)
        codec = compression.inner if ef else compression
        if not isinstance(codec, BlockInt8Quantizer):
            raise ValueError(
                "fused_sgd/fused_adam need the block-int8 codec whose layout "
                "the kernels consume: pass compression=Compression.int8 (or "
                "ErrorFeedback(Compression.int8)); for other codecs use "
                f"spec.to_torch() with DistributedOptimizer (got {codec!r})")
        if op not in (Sum, ReduceOp.AVERAGE):
            raise ValueError(f"fused apply supports Sum/Average, got {op}")
        params, self.param_names = _split_named(params)
        self.spec, self.codec, self.ef = spec, codec, ef
        self.block = codec.block_size
        self.use_mom = spec.kind == "adam" or spec.momentum != 0.0
        self.op, self.axis, self.process_set = op, axis, process_set
        self._multi = GradAccumulator(backward_passes_per_step)
        super().__init__(params, dict(lr=spec.lr, momentum=spec.momentum,
                                      betas=(spec.b1, spec.b2), eps=spec.eps))

    def _init_state(self, p: torch.Tensor, state: dict) -> None:
        n_blocks = -(-p.numel() // self.block)

        def zeros():
            return torch.zeros((n_blocks, self.block), dtype=torch.float32,
                               device=p.device)

        state["count"] = 0
        if self.use_mom:
            state["mom"] = zeros()
        if self.spec.kind == "adam":
            state["vel"] = zeros()
        if self.ef:
            state["residual"] = zeros()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]]
        if not self._multi.advance(params):
            return loss
        for p in params:
            p.grad = self._multi.mean(p)
        self._multi.reset()
        from horovod_tpu_torch.common.basics import is_initialized, size
        if self.axis is not None or (is_initialized() and size() > 1):
            self._step_synced()
            return loss
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    self._init_state(p, state)
                p.add_(_from_blocks(self._delta(group, p.grad, state), p))
        return loss

    def _step_synced(self) -> None:
        """The two multi-device regimes: quantize with EF, dequantize,
        sync, and the blocked update in plain PyTorch."""
        from horovod_tpu_torch.train.optimizer import (_axis_allreduce,
                                                       _eager_allreduce_tree)
        todo = []   # (group, p, state, qdq blocks)
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    self._init_state(p, state)
                blocks = _to_blocks(p.grad, self.block)
                if self.ef:
                    blocks = blocks + state["residual"]
                vals, scales, res = block_quantize_ef(blocks)
                if self.ef:
                    state["residual"] = res
                todo.append((group, p, state, block_dequantize(vals, scales)))
        if self.axis is not None:
            synced = _axis_allreduce([d for *_, d in todo], self.op,
                                     self.axis, 1.0, 1.0)
        else:
            synced = _eager_allreduce_tree(
                [_from_blocks(d, p) for _, p, _, d in todo], self.op,
                self.process_set, self.codec, 1.0, 1.0)
            synced = [_to_blocks(s, self.block) for s in synced]
        for (group, p, state, _), g in zip(todo, synced):
            t = state["count"] + 1
            if self.spec.kind == "sgd":
                delta, mom = _apply_sgd_blocks(g, state.get("mom"),
                                               group["lr"],
                                               group["momentum"])
                if mom is not None:
                    state["mom"] = mom
            else:
                b1, b2 = group["betas"]
                delta, state["mom"], state["vel"] = _apply_adam_blocks(
                    g, state["mom"], state["vel"], group["lr"], b1, b2,
                    group["eps"], *_bias_corrections(b1, b2, t))
            state["count"] = t
            p.add_(_from_blocks(delta, p))

    def _delta(self, group: dict, grad: torch.Tensor, state: dict
               ) -> torch.Tensor:
        t = state["count"] + 1
        blocks = _to_blocks(grad, self.block)
        if self.ef:
            vals, scales, state["residual"] = block_quantize_ef(
                blocks + state["residual"])
        else:
            vals, scales = block_quantize(blocks)
        if self.spec.kind == "sgd":
            delta, mom = fused_sgd_apply(vals, scales, state.get("mom"),
                                         group["lr"], group["momentum"])
            if mom is not None:
                state["mom"] = mom
        else:
            b1, b2 = group["betas"]
            bc1, bc2 = _bias_corrections(b1, b2, t)
            delta, state["mom"], state["vel"] = fused_adam_apply(
                vals, scales, state["mom"], state["vel"], group["lr"], b1, b2,
                group["eps"], bc1, bc2)
        state["count"] = t
        return delta

    def load_jax_state(self, count, mom=None, vel=None, residual=None,
                       named_parameters: Optional[Iterable] = None) -> None:
        """Take over a JAX ``FusedOptState``: ``count`` and the ``mom``,
        ``vel`` and ``residual`` trees (nested mappings of numpy arrays, as
        ``jax.device_get`` gives them, or ``None``), keyed by the dotted
        paths of ``from_jax_params``. ``named_parameters`` defaults to the
        names this optimizer was built with."""
        if named_parameters is None:
            if self.param_names is None:
                raise ValueError("load_jax_state needs named_parameters: this "
                                 "optimizer was built without names")
            params = [p for g in self.param_groups for p in g["params"]]
            named_parameters = zip(self.param_names, params)
        trees = {"mom": flatten_dotted(mom), "vel": flatten_dotted(vel),
                 "residual": flatten_dotted(residual)}
        for name, p in named_parameters:
            state = self.state[p]
            state.clear()
            self._init_state(p, state)
            state["count"] = int(np.asarray(count))
            for key in ("mom", "vel", "residual"):
                if key not in state:
                    continue
                leaf = trees[key].get(name)
                if leaf is None:
                    raise KeyError(f"the JAX state has no {key} for {name!r}")
                src = torch.from_numpy(np.array(leaf, dtype=np.float32))
                _check_state_shape(name, key, src, state[key])
                state[key].copy_(src)


def _check_state_shape(name: str, key: str, src: torch.Tensor,
                       dst: torch.Tensor) -> None:
    if src.shape != dst.shape:
        raise ValueError(f"{key} of {name!r}: the JAX state is "
                         f"{tuple(src.shape)}, this optimizer's "
                         f"{tuple(dst.shape)} (another block size?)")


def _apply_sgd_blocks(g_blocks, mom, lr, momentum):
    """optax.sgd on already-dequantized fp32 blocks (the multi-device
    regimes, where the reduction had to densify)."""
    h = _h(g_blocks, lr, momentum)
    if mom is None:
        return -h[0] * g_blocks, None
    m = g_blocks + h[1] * mom
    return -h[0] * m, m


def _apply_adam_blocks(g_blocks, m, v, lr, b1, b2, eps, bc1, bc2):
    """optax.adam on already-dequantized fp32 blocks, in fp32 with the
    hyperparameters as fp32 device values (divisions stay IEEE)."""
    h = _h(g_blocks, lr, b1, b2, eps, bc1, bc2)
    m = h[1] * m + (1.0 - h[1]) * g_blocks
    v = h[2] * v + (1.0 - h[2]) * g_blocks * g_blocks
    delta = -h[0] * (m / h[4]) / (torch.sqrt(v / h[5]) + h[3])
    return delta, m, v
