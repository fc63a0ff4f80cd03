"""Nested parameter trees, as the JAX package keeps them, keyed flat."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional


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
