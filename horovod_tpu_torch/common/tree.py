"""Nested parameter trees, as the JAX package keeps them, keyed flat, and
their leaves in JAX's flatten order."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple


def flatten_dotted(tree: Optional[Mapping], prefix: str = "") -> Dict[str, Any]:
    """Nested mappings → ``{path.joined.with.dots: leaf}``, the keys of a
    :class:`~horovod_tpu_torch.models.Transformer` ``state_dict``
    (``layers.wq``). ``None`` is an empty tree; leaves are kept as they
    are."""
    out: Dict[str, Any] = {}
    for key, val in (tree or {}).items():
        if isinstance(val, Mapping):
            out.update(flatten_dotted(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


def jax_key(name: str) -> Tuple[str, ...]:
    """Sort key of a dotted path in ``jax.tree_util``'s flatten order: a
    dict flattens by sorted key at every level, so ``embed``,
    ``layers.ln1`` … ``layers.wv``, ``ln_f`` for the flagship (the port's
    ``named_parameters()`` order is ``embed``, ``ln_f``, ``layers.*``)."""
    return tuple(name.split("."))


def tree_flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """``(leaves, unflatten)``: the leaves of nested mappings (in
    :func:`jax_key` order of their keys), lists and tuples, in JAX's
    flatten order, and the function that rebuilds the tree from new
    leaves."""
    if isinstance(tree, Mapping):
        keys = sorted(tree, key=lambda k: jax_key(str(k)))
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    leaves = [leaf for p, _ in parts for leaf in p]
    counts = [len(p) for p, _ in parts]

    def unflatten(new: List[Any]):
        out, i = [], 0
        for (_, rebuild), c in zip(parts, counts):
            out.append(rebuild(new[i:i + c]))
            i += c
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, unflatten
