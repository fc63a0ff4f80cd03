"""The torch state a checkpoint holds, and the leaves a rank holds a block of.

The JAX store learns from each ``jax.Array`` whether it is a shard of a
larger array (``addressable_shards``, ``replica_id``). A torch tensor does
not know, so a leaf a rank holds a block of travels as a :class:`Shard`:
the local tensor, the global shape, its index there and whether this rank
is the block's owner (the JAX ``replica_id == 0``: the rank at coordinate
0 on every mesh axis the leaf is replicated over). Every other tensor is
replicated: the same value on every rank, of which rank r writes the r-th
axis-0 slice.

A user's state is a tree of nested dicts, lists and tuples::

    state = {"model": model_state(model),
             "optim": optimizer_state(optimizer, model),
             "data": dataset.state_dict(), "step": step}

A :class:`~horovod_tpu_torch.models.Transformer` built with a mesh gives
its leaves (and the optimizer's per-parameter tensors) as :class:`Shard`
s from ``param_shardings``; without a mesh they are plain tensors. A
restore returns tensors (the current layout's block of a :class:`Shard`
``like`` leaf), which ``load_model_state`` and
``optimizer.load_state_dict`` take.

A torch optimizer makes its state at its first step, where ``optax``
makes it at ``init``: :func:`init_optimizer_state` gives a fresh
optimizer the state's structure, so that it can serve as a restore's
``like``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import torch

from horovod_tpu_torch.common.tree import flatten_dotted, nest_dotted


@dataclasses.dataclass
class Shard:
    """This rank's block ``local`` of a leaf of ``global_shape``, at
    ``index`` (``[start, stop]`` per dim); only the ``owner`` writes it."""

    local: torch.Tensor
    global_shape: tuple
    index: List[List[int]]
    owner: bool

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def mesh_shard(local: torch.Tensor, spec: Mapping[int, str], mesh) -> Shard:
    """``local`` as this rank's block of a leaf split over ``spec``
    (``{dim: axis name}``, as ``param_shardings`` gives it) on ``mesh``:
    the block ``axis.index`` of each split dim; owned by the rank at
    coordinate 0 on every other axis."""
    shape, index = list(local.shape), [[0, int(d)] for d in local.shape]
    for d, a in spec.items():
        ax = mesh.axis(a)
        n = int(local.shape[d])
        shape[d] = n * ax.size
        index[d] = [ax.index * n, (ax.index + 1) * n]
    owner = all(mesh.axis(a).index == 0 for a in mesh.shape
                if a not in spec.values())
    return Shard(local, tuple(shape), index, owner)


def _specs(model) -> Optional[Dict[str, Dict[int, str]]]:
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return None
    return model.shard_specs()


def model_state(model: torch.nn.Module) -> Dict:
    """The model's ``state_dict`` as the JAX package's nested tree
    (``layers.wq`` → ``["layers"]["wq"]``); with a mesh, every leaf a
    :class:`Shard`."""
    sd = model.state_dict()
    specs = _specs(model)
    if specs is not None:
        sd = {k: mesh_shard(t, specs[k], model.mesh) for k, t in sd.items()}
    return nest_dotted(sd)


def load_model_state(model: torch.nn.Module, tree: Mapping) -> None:
    """Load a restored :func:`model_state` tree into ``model``."""
    model.load_state_dict(flatten_dotted(tree))


def optimizer_state(optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module) -> Dict:
    """``optimizer.state_dict()`` of the optimizer over ``model``'s
    parameters. ``model`` is required: where it was built with a mesh, each
    per-parameter tensor shaped as its parameter (the moments) becomes a
    :class:`Shard` of that parameter's split, which only the model knows
    (taken as replicated, each rank's different block would be written as
    slices of one value). The state's inner dicts are copies: the
    optimizer's own are left as they are."""
    sd = optimizer.state_dict()
    sd = dict(sd, state={i: dict(st) for i, st in sd["state"].items()})
    specs = _specs(model)
    if specs is None:
        return sd
    params = [p for g in optimizer.param_groups for p in g["params"]]
    key_of = {id(p): k for k, p in model.named_parameters()}
    for i, st in sd["state"].items():
        p = params[i]
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.dim() > 0 \
                    and v.shape == p.shape:
                st[k] = mesh_shard(v, specs[key_of[id(p)]], model.mesh)
    return sd


@torch.no_grad()
def init_optimizer_state(optimizer: torch.optim.Optimizer
                         ) -> torch.optim.Optimizer:
    """Make ``optimizer``'s state, as its first step would, without moving
    a parameter: one step on zero gradients at learning rate 0 (what
    ``torch.distributed.checkpoint`` does before a load). The values are
    placeholders for a restore to overwrite; an optimizer that already has
    state is left as it is."""
    if optimizer.state:
        return optimizer
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        p.grad = torch.zeros_like(p)
    lrs = [g["lr"] for g in optimizer.param_groups]
    for g in optimizer.param_groups:
        g["lr"] = 0.0
    try:
        optimizer.step()
    finally:
        for g, lr in zip(optimizer.param_groups, lrs):
            g["lr"] = lr
        for p in params:
            p.grad = None
    return optimizer
