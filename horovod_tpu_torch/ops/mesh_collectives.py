"""Collectives along one axis of a process mesh, over ``torch.distributed``.

Mirrors the SPMD level of ``horovod_tpu/ops/mesh_collectives.py``:
``preduce``, ``pallgather``, ``preduce_scatter``, ``pbroadcast``,
``palltoall``, ``preduce_quantized``, ``phier_allreduce``, ``pring_shift``
and ``pring_allreduce``. Where a JAX function takes ``axis_name`` inside
``shard_map``, these take an :class:`~horovod_tpu_torch.parallel.mesh.Axis`
(``mesh.axis("dp")``) and this rank's tensor, and return this rank's
result as a new tensor; every rank of the axis calls them in the same
order. The JAX array-level ``device_*`` functions and their jit cache have
no counterpart: eager PyTorch has nothing to compile.

Numerics follow the JAX functions: ``AVERAGE`` is the sum divided by the
axis size (as ``pmean``), ``PRODUCT`` gathers and multiplies, the ring
folds in ring order, and the quantized and hierarchical paths quantize only
already-reduced slices (one quantization error of the exact sum). An axis
of size 1 still runs its collective. With NCCL the collectives run on
NCCL's stream; a result is ready on the caller's stream once its
``wait()`` returned.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.reduce_op import ReduceOp

# torch 2.13 renamed the two tensor collectives; older builds have the old
# names only
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


# Collectives that gloo does not run on CUDA tensors: with ranks sharing a
# card (gloo, since NCCL cannot put two ranks on one card) their tensors
# are copied to the host and back, explicitly. On an H100 with torch
# 2.11.0+cu128, gloo's send/recv wrote from the device pointer and failed
# ("writev: Bad address"); it took CUDA tensors for allreduce, allgather,
# broadcast and all_to_all_single.
GLOO_HOST_STAGED = ("send_recv",)


def _host_staged(op: str, t: torch.Tensor, group) -> bool:
    return (op in GLOO_HOST_STAGED and t.is_cuda
            and dist.get_backend(group) == "gloo")


class Pending:
    """A collective in flight: :meth:`wait` returns its result."""

    def __init__(self, work, finish: Callable[[], torch.Tensor]):
        self._work, self._finish = work, finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._finish()


def _mean(x: torch.Tensor, n: int) -> torch.Tensor:
    return x / n if x.is_floating_point() else torch.div(
        x, n, rounding_mode="trunc")


def start_preduce(x: torch.Tensor, axis, op: ReduceOp = ReduceOp.SUM,
                  inplace: bool = False) -> Pending:
    """:func:`preduce`, issued without waiting; ``inplace`` reduces into
    ``x`` itself (a buffer the caller owns, such as a packed bucket)
    instead of a copy (sum, average, min and max)."""
    n = axis.size
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN, ReduceOp.MAX):
        out = x if inplace else x.clone()
        torch_op = {ReduceOp.MIN: dist.ReduceOp.MIN,
                    ReduceOp.MAX: dist.ReduceOp.MAX}.get(op, dist.ReduceOp.SUM)
        work = dist.all_reduce(out, torch_op, group=axis.group, async_op=True)
        if op == ReduceOp.AVERAGE:
            return Pending(work, lambda: _mean(out, n))
        return Pending(work, lambda: out)
    if op == ReduceOp.PRODUCT:
        # gather and multiply in the input dtype, as the JAX package does
        g = _gathered(x, axis)
        return Pending(None, lambda: torch.prod(g.wait(), dim=0,
                                                dtype=x.dtype))
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "op=Adasum arrives with the eager-collectives slice of the port")
    raise ValueError(f"Unsupported reduce op: {op}")


def preduce(x: torch.Tensor, axis, op: ReduceOp = ReduceOp.SUM
            ) -> torch.Tensor:
    """Reduction of ``x`` across the axis (``psum``/``pmean``/``pmin``/
    ``pmax``, or the product)."""
    return start_preduce(x, axis, op).wait()


def _gathered(x: torch.Tensor, axis) -> Pending:
    """Every rank's ``x``, stacked ``[n, *x.shape]`` in axis order."""
    buf = x.new_empty(axis.size * x.numel())
    work = _all_gather(buf, x.contiguous().reshape(-1), group=axis.group,
                       async_op=True)
    return Pending(work, lambda: buf.view((axis.size,) + tuple(x.shape)))


def pallgather(x: torch.Tensor, axis, dim: int = 0, tiled: bool = True
               ) -> torch.Tensor:
    """All-gather along the axis: ``tiled`` concatenates the ranks' tensors
    along ``dim``, otherwise they are stacked in a new dimension ``dim``
    (``lax.all_gather``)."""
    g = _gathered(x, axis).wait()
    if tiled:
        return torch.cat(g.unbind(0), dim=dim)
    return g.movedim(0, dim)


def start_preduce_scatter(x: torch.Tensor, axis, scatter_dim: int = 0
                          ) -> Pending:
    """:func:`preduce_scatter`, issued without waiting."""
    n = axis.size
    if x.shape[scatter_dim] % n:
        raise ValueError(f"reduce_scatter needs dim {scatter_dim} "
                         f"({x.shape[scatter_dim]}) divisible by the axis "
                         f"size ({n})")
    src = x.movedim(scatter_dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    work = _reduce_scatter(out, src, dist.ReduceOp.SUM, group=axis.group,
                           async_op=True)
    return Pending(work, lambda: out.movedim(0, scatter_dim))


def preduce_scatter(x: torch.Tensor, axis, scatter_dim: int = 0
                    ) -> torch.Tensor:
    """Sum across the axis, of which position ``i`` keeps block ``i`` of
    ``scatter_dim`` (``psum_scatter``, tiled)."""
    return start_preduce_scatter(x, axis, scatter_dim).wait()


def pbroadcast(x: torch.Tensor, axis, root: int = 0) -> torch.Tensor:
    """Axis position ``root``'s tensor, on every rank of the axis."""
    out = x.clone()
    dist.broadcast(out, src=axis.ranks[root], group=axis.group)
    return out


def palltoall(x: torch.Tensor, axis, split_dim: int = 0,
              concat_dim: int = 0) -> torch.Tensor:
    """Uniform all-to-all: block ``j`` of ``split_dim`` goes to axis
    position ``j``; the blocks received are concatenated along
    ``concat_dim`` in position order (``lax.all_to_all``, tiled)."""
    n = axis.size
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all needs dim {split_dim} "
                         f"({x.shape[split_dim]}) divisible by the axis size "
                         f"({n})")
    src = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis.group)
    blocks = out.view((n, src.shape[0] // n) + tuple(src.shape[1:]))
    return torch.cat([b.movedim(0, split_dim) for b in blocks.unbind(0)],
                     dim=concat_dim)


def _check_sum_average(what: str, op: ReduceOp) -> None:
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"{what} supports Sum/Average, got {op}")


def _gather_quantized(part: torch.Tensor, axis, quantizer) -> torch.Tensor:
    """Quantize this rank's reduced slice, all-gather the codes and scales,
    and dequantize every rank's slice: ``[n * part.shape[0], ...]``."""
    from horovod_tpu_torch.compression.quantizers import Quantized
    q, spec = quantizer.quantize(part)
    gv, gs = _gathered(q.values, axis), _gathered(q.scales, axis)
    gv, gs = gv.wait(), gs.wait()
    parts = [quantizer.dequantize(Quantized(v, s), spec)
             for v, s in zip(gv.unbind(0), gs.unbind(0))]
    return torch.cat(parts, 0)


def start_preduce_quantized(x: torch.Tensor, axis, quantizer,
                            op: ReduceOp = ReduceOp.SUM) -> Pending:
    """:func:`preduce_quantized`: the exact reduce_scatter is issued here;
    ``wait()`` quantizes, gathers and dequantizes. The pre/wire bytes go to
    the compression metrics from the shapes, as the JAX
    ``device_allreduce(compression=)`` counts them: this rank's tensor
    before, and the ``n`` quantized slices of the gather on the wire."""
    _check_sum_average("quantized allreduce", op)
    n = axis.size
    if x.dim() == 0:
        raise ValueError(
            "quantized allreduce needs at least a 1-D per-shard tensor "
            "(the scatter splits dim 0); use the exact path for scalars")
    if x.shape[0] % n != 0:
        raise ValueError(
            f"quantized allreduce needs dim 0 ({x.shape[0]}) divisible by "
            f"the axis size ({n}); pad the tensor or use the exact path")
    scatter = start_preduce_scatter(x, axis, 0)
    from horovod_tpu_torch.compression.metrics import record_compression
    record_compression(quantizer.name, x.numel() * x.element_size(),
                       quantizer.wire_bytes(x.numel() // n) * n)

    def finish():
        part = scatter.wait()
        if op == ReduceOp.AVERAGE:
            part = part / n
        return _gather_quantized(part, axis, quantizer).reshape(
            (n * part.shape[0],) + tuple(part.shape[1:])).to(x.dtype)

    return Pending(None, finish)


def preduce_quantized(x: torch.Tensor, axis, quantizer,
                      op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Quantized allreduce along the axis: ``reduce_scatter → quantize →
    all_gather → dequantize`` (EQuARX, arxiv 2506.17615). The reduction
    itself is exact; only the reduced slices travel quantized, so the
    error is one quantization step of the sum. Needs ``x.shape[0]``
    divisible by the axis size; Sum and Average only."""
    return start_preduce_quantized(x, axis, quantizer, op).wait()


def phier_allreduce(x: torch.Tensor, axis, topology,
                    op: ReduceOp = ReduceOp.SUM, inter_codec=None,
                    small_floor: Optional[int] = None) -> torch.Tensor:
    """Hierarchical allreduce along the axis: intra-host reduce_scatter →
    inter-host allreduce on the ``1/local_size`` shard → intra-host
    allgather (the MLPerf TPU-pod decomposition, arxiv 1909.09756).

    ``topology`` (a :class:`~horovod_tpu_torch.common.topology.MeshTopology`)
    must cover the axis. ``inter_codec`` quantizes the inter-host hop only,
    EQuARX-style (exact reduce_scatter, then quantized allgather).
    Payloads under ``small_floor`` bytes, or a flat topology, take one
    :func:`preduce`. Sum and Average only. The intra- and inter-host groups
    are made on first use (collective over the world)."""
    _check_sum_average("hierarchical allreduce", op)
    n = axis.size
    if topology.world != n:
        raise ValueError(
            f"topology {topology.num_hosts}x{topology.local_size} does "
            f"not cover axis {axis.name!r} of size {n}")
    nbytes = x.numel() * x.element_size()
    if not topology.is_hierarchical or \
            (small_floor and nbytes < small_floor):
        return preduce(x, axis, op)

    H, L = topology.num_hosts, topology.local_size
    intra = axis.mesh.split(axis.name, topology.intra_groups())
    inter = axis.mesh.split(axis.name, topology.inter_groups())
    flat = x.reshape(-1)
    size = flat.numel()
    # one pad serves both scatters: intra splits by L, the (quantized)
    # inter hop splits the L-shard by H
    pad = (-size) % (L * H)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    part = preduce_scatter(flat, intra)
    if inter_codec is None:
        part = preduce(part, inter, ReduceOp.SUM)
        if op == ReduceOp.AVERAGE:
            part = part / n
    else:
        sub = preduce_scatter(part, inter)
        if op == ReduceOp.AVERAGE:
            sub = sub / n
        part = _gather_quantized(sub, inter, inter_codec).to(flat.dtype)
    out = pallgather(part, intra)
    if pad:
        out = out[:size]
    return out.reshape(x.shape).to(x.dtype)


def pring_shift(x: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """Ring permute: position ``i`` sends to ``(i + shift) % n`` and
    receives from ``(i - shift) % n`` (``lax.ppermute``)."""
    n, r = axis.size, axis.index
    if shift % n == 0:
        return x.clone()
    out = torch.empty_like(x)
    exchange([(x, axis.ranks[(r + shift) % n])],
             [(out, axis.ranks[(r - shift) % n])], axis.group)
    return out


def exchange(sends, recvs, group) -> None:
    """Point-to-point sends and receives issued together and waited on:
    ``sends`` of ``(tensor, dst)``, ``recvs`` of ``(buffer, src)`` (world
    ranks); each buffer holds its message on return. Two ranks that
    exchange several messages list them in the same order on both sides
    (sends in the sender's order are received in the receiver's). Under
    gloo, CUDA tensors go through the host (``GLOO_HOST_STAGED``)."""
    if not sends and not recvs:
        return
    ops, staged = [], []
    for t, dst in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if _host_staged(
            "send_recv", t, group) else t, dst, group))
    for buf, src in recvs:
        if _host_staged("send_recv", buf, group):
            host = torch.empty_like(buf, device="cpu")
            staged.append((buf, host))
            buf = host
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for buf, host in staged:
        buf.copy_(host)


def pring_allreduce(x: torch.Tensor, axis, op: ReduceOp = ReduceOp.SUM
                    ) -> torch.Tensor:
    """Chunked ring allreduce from point-to-point steps: 2(n−1) sends of
    1/n of the vector, the fold order of the JAX ``pring_allreduce`` (each
    element is the sum of the same n contributions, in ring order). Folds
    in the input dtype. Sum and Average only."""
    _check_sum_average("ring allreduce", op)
    n = axis.size
    if n == 1:
        return x
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1).clone()   # chunk c = slice c of the vector
    r = axis.index
    right, left = axis.ranks[(r + 1) % n], axis.ranks[(r - 1) % n]
    moved = torch.empty_like(chunks[0])
    # reduce-scatter: at step s every rank sends chunk (r−s) mod n to its
    # right neighbour, which folds it into the same chunk index; after n−1
    # steps rank r owns the reduced chunk (r+1) mod n
    for s in range(n - 1):
        exchange([(chunks[(r - s) % n], right)], [(moved, left)], axis.group)
        chunks[(r - s - 1) % n] += moved
    # allgather: pass each completed chunk once around the ring
    for s in range(n - 1):
        exchange([(chunks[(r + 1 - s) % n], right)], [(moved, left)],
                 axis.group)
        chunks[(r - s) % n] = moved
    out = chunks.reshape(-1)
    if pad:
        out = out[:size]
    if op == ReduceOp.AVERAGE:
        out = out / n
    return out.reshape(x.shape).to(x.dtype)
