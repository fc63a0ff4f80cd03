"""Gradient bucket planner: byte-budgeted partitions of a gradient tree.

Mirrors ``horovod_tpu/train/buckets.py`` (``Bucket``, ``BucketPlan``,
``resolve_bucket_bytes``, ``plan_buckets``, ``pack``, ``unpack``). Leaves
are walked in REVERSE order (the output side's gradients come first in
backward) and packed greedily into buckets of at most ``bucket_bytes``;
a leaf larger than the budget is a bucket of its own. The budget is the
64 MiB fusion threshold unless ``HVD_TPU_BUCKET_BYTES`` or an argument
sets it. The order of the leaves is the caller's: give the JAX flatten
order (:func:`horovod_tpu_torch.common.tree.tree_flatten`, or names
sorted by :func:`~horovod_tpu_torch.common.tree.jax_key`) to get the JAX
package's plan, bucket for bucket. Every plan asked for lands on the
``hvd_overlap_bucket_count`` and ``hvd_overlap_bucket_bytes`` gauges
(``record_plan``).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.common.tree import tree_flatten


class Bucket(NamedTuple):
    """One communication unit: ``indices`` are positions in the leaf list
    (ascending within the bucket), ``nbytes`` the payload at the leaves'
    own dtypes."""

    indices: Tuple[int, ...]
    nbytes: int


class BucketPlan(NamedTuple):
    """Buckets in issue order (bucket 0 holds the LAST leaves: the first
    gradients backward produces)."""

    buckets: Tuple[Bucket, ...]
    total_bytes: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def resolve_bucket_bytes(bucket_bytes: Optional[int] = None) -> int:
    """Effective byte budget: explicit argument > ``HVD_TPU_BUCKET_BYTES``
    (``Config.bucket_bytes``) > the fusion threshold."""
    if bucket_bytes is not None:
        return max(1, int(bucket_bytes))
    from horovod_tpu_torch.common.config import get_config
    cfg = get_config()
    if cfg.bucket_bytes > 0:
        return cfg.bucket_bytes
    return max(1, cfg.fusion_threshold_bytes)


def leaf_nbytes(leaf: torch.Tensor) -> int:
    return leaf.numel() * leaf.element_size()


@functools.lru_cache(maxsize=256)
def _plan_cached(sizes: Tuple[int, ...], budget: int,
                 reverse: bool) -> BucketPlan:
    order = range(len(sizes) - 1, -1, -1) if reverse else range(len(sizes))
    buckets = []
    cur: list = []
    cur_bytes = 0
    for i in order:
        nb = sizes[i]
        if cur and cur_bytes + nb > budget:
            buckets.append(Bucket(tuple(sorted(cur)), cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(Bucket(tuple(sorted(cur)), cur_bytes))
    return BucketPlan(tuple(buckets), sum(sizes))


def plan_buckets(tree: Any, bucket_bytes: Optional[int] = None,
                 reverse: bool = True) -> BucketPlan:
    """Partition the leaves of ``tree`` (tensors, in a list or nested
    mappings) into byte-budgeted buckets; only shapes and dtypes are
    read. Cached on the leaf sizes and the budget. Records the plan on
    the overlap gauges."""
    leaves, _ = tree_flatten(tree)
    plan = _plan_cached(tuple(leaf_nbytes(l) for l in leaves),
                        resolve_bucket_bytes(bucket_bytes), bool(reverse))
    record_plan(plan)
    return plan


def record_plan(plan: BucketPlan) -> None:
    """Surface the active plan on the registry: bucket count and total
    payload bytes."""
    from horovod_tpu_torch.metrics.registry import default_registry
    reg = default_registry()
    reg.gauge("hvd_overlap_bucket_count",
              help="gradient buckets in the active overlap plan"
              ).set(plan.num_buckets)
    reg.gauge("hvd_overlap_bucket_bytes",
              help="total gradient payload bytes in the active plan"
              ).set(plan.total_bytes)


def pack_dtype(leaves: Sequence[torch.Tensor], bucket: Bucket) -> torch.dtype:
    """The bucket's widest member dtype (bf16 + fp32 → fp32; all bf16
    stays bf16, the bytes the wire saves)."""
    return functools.reduce(torch.promote_types,
                            (leaves[i].dtype for i in bucket.indices))


def pack(leaves: Sequence[torch.Tensor], bucket: Bucket, pad_to: int = 1
         ) -> torch.Tensor:
    """``bucket``'s leaves concatenated into one flat vector of the
    bucket's widest dtype, zero-padded to a ``pad_to`` multiple (the axis
    size for the quantized path's scatter)."""
    dtype = pack_dtype(leaves, bucket)
    parts = [leaves[i].reshape(-1).to(dtype) for i in bucket.indices]
    n = sum(p.numel() for p in parts)
    pad = (-n) % max(1, pad_to)
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def unpack(vec: torch.Tensor, bucket: Bucket,
           like: Sequence[torch.Tensor]) -> list:
    """Split a packed (possibly padded) vector back into ``bucket``'s
    leaves with the shapes and dtypes of ``like``; in ``bucket.indices``
    order."""
    out = []
    offset = 0
    for i in bucket.indices:
        ref = like[i]
        n = ref.numel()
        out.append(vec[offset:offset + n].view(ref.shape).to(ref.dtype))
        offset += n
    return out
