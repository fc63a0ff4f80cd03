"""Nested parameter trees, as the JAX package keeps them, keyed flat, and
their leaves in JAX's flatten order."""

from __future__ import annotations

import collections
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


def nest_dotted(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`flatten_dotted`: ``{"layers.wq": x}`` →
    ``{"layers": {"wq": x}}`` (a ``state_dict`` as the JAX package's
    parameter tree)."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        *heads, last = key.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = val
    return out


def jax_key(name: str) -> Tuple[str, ...]:
    """Sort key of a dotted path in ``jax.tree_util``'s flatten order: a
    dict flattens by sorted key at every level, so ``embed``,
    ``layers.ln1`` … ``layers.wv``, ``ln_f`` for the flagship (the port's
    ``named_parameters()`` order is ``embed``, ``ln_f``, ``layers.*``)."""
    return tuple(name.split("."))


# -- the one tree walker, ``jax.tree_util``'s ----------------------------------
#
# A path is a tuple of ``("k", dict key)``, ``("i", sequence index)`` or
# ``("a", attribute name)`` entries (JAX's ``DictKey``, ``SequenceKey`` and
# ``GetAttrKey``). Dicts flatten by sorted key, an ``OrderedDict`` in its
# own order, lists and tuples by index, a namedtuple by field, and ``None``
# is an empty subtree; everything else is a leaf. A flat mapping of dotted
# parameter names sorts as its nested tree does (:func:`jax_key`): ``.``
# sorts before every character of an identifier.

def _children(tree) -> Optional[List[Tuple[Tuple[str, Any], Any]]]:
    if isinstance(tree, collections.OrderedDict):
        return [(("k", k), v) for k, v in tree.items()]
    if isinstance(tree, Mapping):
        return [(("k", k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(("a", f), getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(("i", i), v) for i, v in enumerate(tree)]
    if tree is None:
        return []
    return None


def flatten_with_path(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in ``jax.tree_util``'s flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[tuple, Any]] = []
    for entry, child in kids:
        out.extend(flatten_with_path(child, prefix + (entry,)))
    return out


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_with_path(fn: Callable[[tuple, Any], Any], tree, prefix: tuple = ()):
    """The tree with each leaf replaced by ``fn(path, leaf)``, called in
    flatten order; containers keep their type and key order, and ``None``
    stays ``None``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = [map_with_path(fn, child, prefix + (entry,))
           for entry, child in kids]
    if isinstance(tree, Mapping):
        by_key = dict(zip((entry[1] for entry, _ in kids), new))
        return type(tree)((k, by_key[k]) for k in tree) \
            if isinstance(tree, collections.OrderedDict) else \
            {k: by_key[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    return None


def tree_flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """``(leaves, unflatten)``: the leaves in JAX's flatten order, and the
    function that rebuilds the tree from new leaves in that order."""
    leaves = tree_leaves(tree)

    def unflatten(new: List[Any]):
        it = iter(new)
        return map_with_path(lambda _path, _leaf: next(it), tree)

    return leaves, unflatten


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path: ``"['params']['layers'][0]"``."""
    return "".join(f".{v}" if kind == "a" else
                   f"[{v!r}]" if kind == "k" else f"[{v}]"
                   for kind, v in path)


def path_parts(path: tuple) -> List[dict]:
    """The JSON-safe key path the checkpoint manifest records (the JAX
    store's ``_path_parts``): ``{"k": key}``, ``{"i": index}`` or
    ``{"a": name}`` per entry, a key that JSON cannot hold as its repr."""
    out: List[dict] = []
    for kind, v in path:
        if kind == "k" and not isinstance(v, (str, int, float, bool)):
            v = repr(v)
        out.append({kind: int(v) if kind == "i" else v})
    return out
