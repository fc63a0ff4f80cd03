"""Batch normalization in training mode, in four stages: the forward's
statistics and normalization, the backward's sums and input gradient.

A CUDA tensor runs the hand-written kernels of ``csrc/batch_norm.cu`` (two
launches forward, two backward; a dtype other than bf16, fp16, fp32 and
fp64, or another device, raises) and a CPU tensor the plain versions beside
them, which are the PyTorch code the port ran before, stage by stage. The cross-rank all-reduces go between
the stages (``train/sync_batch_norm.py``): ``[Σx, Σx², n]`` between the
forward's two, ``[Σdy, Σdy·x̂]`` between the backward's.

The kernels replace no Pallas kernel: the JAX package's batch norm is jnp
code that XLA fuses. Their bound is bytes (the source says how they
approach it). Their sums are fp64, through the all-reduce too, so a batch
split over ranks gets the statistics one process gets (the plain versions
sum in the statistics' dtype and widen the sums to fp64, so the vectors
the ranks all-reduce are fp64 on every device); mean, variance
(``E[x²] − E[x]²`` clipped at 0) and rstd are fp32 (fp64 for fp64 input),
the output in ``out_dtype`` and the input gradient in ``x``'s dtype. From
the sums rounded to the statistics' dtype, the elementwise formulas are
the plain versions', each operation rounded on its own, so both give the
same bits. The kernels take x, y and dy of one dtype; where ``out_dtype``
(or dy's) is another, a launch runs in the statistics' dtype, which holds
x exactly, and its result is cast, as the plain versions cast theirs. The sums are deterministic: the same call gives the same bits
every time.

Layouts: channels innermost (``channels_last`` NCHW, ``[..., C]``) or
``[N, C, S]`` with S innermost (NCHW-contiguous, ``[N, C, L]``); any
other strides are made contiguous first (:func:`kernel_input`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch

from horovod_tpu_torch.ops import _build

# dtype codes of csrc/batch_norm.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}
THREADS = 256
# CTAs (channel tiles × strips) a launch aims for, per SM: the best of 1, 2,
# 3, 4 and 8 over ResNet-50's layers on the H100, forward and backward
FORWARD_CTAS_PER_SM, BACKWARD_CTAS_PER_SM = 4, 2
MIN_ROWS = 16        # rows a thread walks at least (the kernels unroll 4)


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The statistics' dtype: at least fp32 (flax's promotion: bf16 and
    fp16 compute fp32 moments, fp64 stays fp64)."""
    return torch.promote_types(x.dtype, torch.float32)


class Running(NamedTuple):
    """The running averages a training forward updates in place:
    ``buf ← keep·buf + take·batch`` for the mean and the variance, the
    variance times ``n/(n−1)`` first when ``unbiased``."""
    mean: torch.Tensor
    var: torch.Tensor
    keep: float
    take: float
    unbiased: bool


def _dims(x: torch.Tensor, cd: int):
    dims = [d for d in range(x.dim()) if d != cd]
    bshape = [1] * x.dim()
    bshape[cd] = x.shape[cd]
    return dims, bshape


# -- the plain versions (CPU tensors) ------------------------------------------

def plain_stats(x: torch.Tensor, cd: int) -> torch.Tensor:
    """``[Σx (C), Σx² (C), n]`` over every dim but ``cd``, summed in the
    statistics' dtype and widened to fp64."""
    dims, _ = _dims(x, cd)
    xf = x.to(stat_dtype(x))
    n_local = math.prod(x.shape[d] for d in dims)
    return torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                      xf.new_full((1,), float(n_local))]).to(torch.float64)


def plain_normalize(x: torch.Tensor, stats: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    cd: int, out_dtype: torch.dtype):
    """``y = (x − mean)·rsqrt(var + eps)·scale + bias`` in the statistics'
    dtype, cast to ``out_dtype``, with the moments of the (all-reduced)
    ``stats`` rounded to that dtype: ``(y, mean, var, rstd)``."""
    _, bshape = _dims(x, cd)
    xf = x.to(stat_dtype(x))
    stats = stats.to(xf.dtype)
    C = x.shape[cd]
    n = stats[2 * C]
    mean = stats[:C] / n
    var = torch.clamp_min(stats[C:2 * C] / n - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    mul = (rstd * scale.to(xf.dtype)).view(bshape)
    y = ((xf - mean.view(bshape)) * mul + bias.to(xf.dtype).view(bshape))
    return (y if y.dtype == out_dtype else y.to(out_dtype)), mean, var, rstd


def plain_update_running(run: Running, mean: torch.Tensor, var: torch.Tensor,
                         n: torch.Tensor) -> None:
    """The running averages' update, in place, in their own dtype."""
    if run.unbiased:
        var = var * torch.where(n > 1, n / (n - 1), torch.ones_like(n))
    run.mean.mul_(run.keep).add_(run.take * mean.to(run.mean.dtype))
    run.var.mul_(run.keep).add_(run.take * var.to(run.var.dtype))


def plain_grad_sums(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, cd: int) -> torch.Tensor:
    """``[Σdy (C), Σdy·x̂ (C)]``, ``x̂ = (x − mean)·rstd``, summed in the
    statistics' dtype and widened to fp64."""
    dims, bshape = _dims(x, cd)
    xhat = (x.to(mean.dtype) - mean.view(bshape)) * rstd.view(bshape)
    dyf = dy.to(mean.dtype)
    return torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)]).to(
        torch.float64)


def plain_grad_input(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor, scale: torch.Tensor,
                     glob: torch.Tensor, n: torch.Tensor, cd: int
                     ) -> torch.Tensor:
    """``dx = (dy − Σdy/n − x̂·Σdy·x̂/n)·rstd·scale`` in ``x``'s dtype, from
    the (all-reduced) sums ``glob`` over the global count ``n``, both
    rounded to the statistics' dtype."""
    _, bshape = _dims(x, cd)
    C = mean.numel()
    glob, n = glob.to(mean.dtype), n.to(mean.dtype)
    xhat = (x.to(mean.dtype) - mean.view(bshape)) * rstd.view(bshape)
    dyf = dy.to(mean.dtype)
    sdy, sdyx = (glob[:C] / n).view(bshape), (glob[C:] / n).view(bshape)
    dx = (dyf - sdy - xhat * sdyx) * (rstd * scale.to(rstd.dtype)
                                       ).view(bshape)
    return dx.to(x.dtype)


# -- the kernels' geometry ------------------------------------------------------

class Plan(NamedTuple):
    """A launch's geometry: ``layout`` 0 (channels innermost: ``rows`` M,
    ``S`` 1) or 1 (``[rows = N, C, S]``); ``vec`` 1 for 16-byte accesses;
    ``tx`` threads along C (layout 0) or S (layout 1), ``THREADS // tx``
    along the rows; ``tiles`` × ``strips`` CTAs, ``rps`` rows a strip."""
    layout: int
    rows: int
    C: int
    S: int
    vec: int
    tx: int
    tiles: int
    strips: int
    rps: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def plan(layout: int, rows: int, C: int, S: int, elem_bytes: int, vec: bool,
         ctas: int) -> Plan:
    """The geometry for a layer. Layout 0 gives each thread ``16 //
    elem_bytes`` channels (1 without ``vec``) of a row segment of at most
    128 bytes; layout 1 gives each CTA one channel, its threads along S.
    Then enough strips of rows for about ``ctas`` CTAs, each thread
    walking at least ``MIN_ROWS`` rows where there are so many."""
    v = 16 // elem_bytes if vec else 1
    if layout == 0:
        tx = min(_pow2_at_least(-(-C // v)), max(1, 128 // (v * elem_bytes)))
        tiles = -(-C // (tx * v))
    else:
        tx = min(_pow2_at_least(-(-S // v)), THREADS)
        tiles = C
    strips = -(-ctas // tiles)
    strips = max(1, min(strips, -(-rows // (THREADS // tx * MIN_ROWS))))
    rps = -(-rows // strips)
    if rps:
        strips = -(-rows // rps)
    return Plan(layout, rows, C, S, int(vec), tx, tiles, strips, rps)


# what the host does for a launch is looked up, not recomputed: a
# ResNet-50 step makes 212 of them, and the card waits for the host
_LAYOUTS: Dict[tuple, Optional[int]] = {}
_PLANS: Dict[tuple, tuple] = {}
_SMS: Dict[int, int] = {}
_SCRATCH: Dict[tuple, torch.Tensor] = {}
_ENTRIES: Dict[str, object] = {}


def _layout(t: torch.Tensor, cd: int) -> Optional[int]:
    """0 when the channels are innermost (the other dims dense around
    them), 1 when ``t`` is contiguous, else None."""
    key = (t.shape, t.stride(), cd)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = 0 if t.movedim(cd, -1).is_contiguous() else \
            1 if t.is_contiguous() else None
    return _LAYOUTS[key]


def kernel_input(x: torch.Tensor, cd: int) -> torch.Tensor:
    """``x`` as the kernels read it: itself when its channels are
    innermost or it is contiguous, else a contiguous copy. A CPU tensor is
    returned as it is."""
    if not x.is_cuda or _layout(x, cd) is not None:
        return x
    return x.contiguous()


def _as_layout(t: torch.Tensor, like: torch.Tensor, cd: int) -> torch.Tensor:
    """``t`` in ``like``'s memory layout: itself, or a copy."""
    if t.stride() == like.stride() or _layout(t, cd) == _layout(like, cd):
        return t
    return torch.empty_like(like, dtype=t.dtype).copy_(t)


def _check(x: torch.Tensor, out_dtype: torch.dtype, *others) -> int:
    """Raise on what the kernels do not take; ``x``'s device index."""
    if x.dtype not in _CODES or out_dtype not in _CODES:
        raise TypeError(f"the batch norm kernels take bf16, fp16, fp32 and "
                        f"fp64 tensors; got the dtypes {x.dtype} and "
                        f"{out_dtype}")
    dev = x.get_device()
    for t in others:
        if t.get_device() != dev:
            dev = -1
    if dev < 0:
        raise ValueError("the batch norm kernels take tensors on one CUDA "
                         "device")
    return dev


def _plan_for(x: torch.Tensor, cd: int, aligned: bool, per_sm: int):
    """``(plan, geo)`` for ``x`` (``aligned``: every tensor of its shape the
    launch reads or writes starts on 16 bytes) at ``per_sm`` CTAs an SM;
    ``geo`` is the plan as the kernels' entries take it."""
    key = (x.shape, x.stride(), x.dtype, cd, x.get_device(), aligned, per_sm)
    got = _PLANS.get(key)
    if got is not None:
        return got
    C, layout = x.shape[cd], _layout(x, cd)
    if C == 0:
        raise ValueError("the batch norm kernels take at least one channel")
    if layout is None:
        raise ValueError(f"the batch norm kernels take channels-innermost or "
                         f"contiguous activations (kernel_input), got "
                         f"strides {x.stride()}")
    if layout == 0:
        rows, S = x.numel() // C, 1
    else:
        rows, S = math.prod(x.shape[:cd]), math.prod(x.shape[cd + 1:])
    eb = x.element_size()
    vec = aligned and (C if layout == 0 else S) % (16 // eb) == 0
    dev = x.get_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    p = plan(layout, rows, C, S, eb, vec, per_sm * _SMS[dev])
    geo = (ctypes.c_longlong * 9)(p.rows, p.S, p.rps, p.C, p.tx, p.tiles,
                                  p.strips, p.layout, p.vec)
    got = _PLANS[key] = (p, geo)
    return got


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _scratch(dev: int, stream: int, what: str, nbytes: int) -> int:
    """The address of ``nbytes`` of scratch of one device and stream: the
    counters of the last-CTA handshake (zero between launches: a launch's
    last CTA sets its counter back to 0) or a reduction's partials
    (written and read inside one launch). Launches on one stream run in
    order, so they share the buffers."""
    key = (dev, stream, what)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[key] = torch.zeros(max(nbytes, 1 << 16),
                                          dtype=torch.uint8,
                                          device=torch.device("cuda", dev))
    return buf.data_ptr()


def _acc(t: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous vector of the statistics' dtype."""
    return t if t.dtype == acc and t.is_contiguous() else \
        t.to(acc).contiguous()


def launch_kernel(entry: str, *args) -> None:
    """Launch ``entry`` of ``csrc/batch_norm.cu`` on the arguments given;
    every launch of the four kernels counts in ``launch_kernel.launches``."""
    fn = _ENTRIES.get(entry)
    if fn is None:
        fn = _ENTRIES[entry] = getattr(_build.library("batch_norm"), entry)
    err = fn(*args)
    if err:
        _build.check(_build.library("batch_norm"), entry, err)
    launch_kernel.launches += 1


launch_kernel.launches = 0


# -- the kernels (CUDA tensors) -------------------------------------------------

def stats_cuda(x: torch.Tensor, cd: int) -> torch.Tensor:
    """:func:`plain_stats` by ``bn_stats``: one launch; the sums in fp64."""
    dev = _check(x, x.dtype)
    p, geo = _plan_for(x, cd, _aligned(x), FORWARD_CTAS_PER_SM)
    out = torch.empty(2 * p.C + 1, dtype=torch.float64, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    launch_kernel("bn_stats", x.data_ptr(),
                  _scratch(dev, stream, "part", p.strips * 2 * p.C * 8),
                  _scratch(dev, stream, "counters", 4 * p.tiles),
                  out.data_ptr(), geo, _CODES[x.dtype], dev, stream)
    return out


def normalize_cuda(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float, cd: int,
                   out_dtype: torch.dtype, running: Optional[Running] = None):
    """:func:`plain_normalize` of ``stats`` rounded to the statistics'
    dtype, and the running averages' update, by ``bn_normalize``: one
    launch, which writes mean, var and rstd too."""
    dev = _check(x, out_dtype, stats, scale, bias)
    acc = stat_dtype(x)
    if out_dtype != x.dtype:    # one dtype a launch: the statistics' (exact)
        x = x.to(acc)
    y = torch.empty_like(x)
    p, geo = _plan_for(x, cd, _aligned(x, y), FORWARD_CTAS_PER_SM)
    mvr = torch.empty(3, p.C, dtype=acc, device=x.device)
    st, sc, bi = _acc(stats, torch.float64), _acc(scale, acc), _acc(bias, acc)
    fused = running is not None and all(
        t.dtype == acc and t.is_contiguous() and t.get_device() == dev
        for t in (running.mean, running.var))
    run = (running.mean.data_ptr(), running.var.data_ptr(),
           float(eps), float(running.keep), float(running.take),
           int(running.unbiased)) if fused else (None, None, float(eps),
                                                 0.0, 0.0, 0)
    launch_kernel("bn_normalize", x.data_ptr(), y.data_ptr(), st.data_ptr(),
                  sc.data_ptr(), bi.data_ptr(), mvr.data_ptr(), *run, geo,
                  _CODES[x.dtype], dev, torch._C._cuda_getCurrentRawStream(dev))
    mean, var, rstd = mvr.unbind(0)
    if running is not None and not fused:
        plain_update_running(running, mean, var, st[2 * p.C].to(acc))
    return (y if y.dtype == out_dtype else y.to(out_dtype)), mean, var, rstd


def grad_sums_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, cd: int) -> torch.Tensor:
    """:func:`plain_grad_sums` by ``bn_grad_sums``: one launch; the sums in
    fp64."""
    dev = _check(x, dy.dtype, dy, mean, rstd)
    acc = mean.dtype
    if dy.dtype != x.dtype:     # one dtype a launch: the statistics'
        x, dy = x.to(acc), dy.to(acc)
    dy = _as_layout(dy, x, cd)
    p, geo = _plan_for(x, cd, _aligned(x, dy), BACKWARD_CTAS_PER_SM)
    mean, rstd = _acc(mean, acc), _acc(rstd, acc)
    out = torch.empty(2 * p.C, dtype=torch.float64, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    launch_kernel("bn_grad_sums", x.data_ptr(), dy.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(),
                  _scratch(dev, stream, "part", p.strips * 2 * p.C * 8),
                  _scratch(dev, stream, "counters", 4 * p.tiles),
                  out.data_ptr(), geo, _CODES[x.dtype], dev, stream)
    return out


def grad_input_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, scale: torch.Tensor,
                    glob: torch.Tensor, n: torch.Tensor, cd: int
                    ) -> torch.Tensor:
    """:func:`plain_grad_input` of ``glob`` and ``n`` rounded to the
    statistics' dtype by ``bn_grad_input``: one launch."""
    dev = _check(x, dy.dtype, dy, mean, rstd, scale, glob, n)
    acc, x_dtype = mean.dtype, x.dtype
    if dy.dtype != x_dtype:     # one dtype a launch: the statistics'
        x, dy = x.to(acc), dy.to(acc)
    dy = _as_layout(dy, x, cd)
    dx = torch.empty_like(x)
    p, geo = _plan_for(x, cd, _aligned(x, dy, dx), BACKWARD_CTAS_PER_SM)
    mean, rstd, sc = (_acc(t, acc) for t in (mean, rstd, scale))
    gl, nn = _acc(glob, torch.float64), _acc(n, torch.float64)
    launch_kernel("bn_grad_input", x.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                  sc.data_ptr(), gl.data_ptr(), nn.data_ptr(), geo,
                  _CODES[x.dtype], dev, torch._C._cuda_getCurrentRawStream(dev))
    return dx if dx.dtype == x_dtype else dx.to(x_dtype)


# -- the stages: the kernel for a CUDA tensor, the plain version for a CPU one

def stats(x: torch.Tensor, cd: int) -> torch.Tensor:
    return stats_cuda(x, cd) if x.is_cuda else plain_stats(x, cd)


def normalize(x, stats_, scale, bias, eps, cd, out_dtype, running=None):
    """The forward's normalization ``(y, mean, var, rstd)``; updates
    ``running`` in place when it is given."""
    if x.is_cuda:
        return normalize_cuda(x, stats_, scale, bias, eps, cd, out_dtype,
                              running)
    y, mean, var, rstd = plain_normalize(x, stats_, scale, bias, eps, cd,
                                         out_dtype)
    if running is not None:
        with torch.no_grad():
            plain_update_running(running, mean, var,
                                 stats_[2 * mean.numel()].to(mean.dtype))
    return y, mean, var, rstd


def grad_sums(x, dy, mean, rstd, cd):
    if x.is_cuda:
        return grad_sums_cuda(x, dy, mean, rstd, cd)
    return plain_grad_sums(x, dy, mean, rstd, cd)


def grad_input(x, dy, mean, rstd, scale, glob, n, cd):
    if x.is_cuda:
        return grad_input_cuda(x, dy, mean, rstd, scale, glob, n, cd)
    return plain_grad_input(x, dy, mean, rstd, scale, glob, n, cd)
