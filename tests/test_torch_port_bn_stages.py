"""The batch norm's four stages (``ops/batch_norm``) on the CPU: their plain
versions, composed, give the same bits as the single autograd function
the port ran before them, in both layouts the kernels read and in fp64;
the launch geometry covers every shape; the kernel wrappers refuse what
the kernels do not take. The card tests (``test_torch_port_cuda.py``)
hold the kernels to these plain versions."""

import math

import pytest
import torch

from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.train.sync_batch_norm import (SyncBatchNorm,
                                                     batch_norm_train)


class _Before(torch.autograd.Function):
    """The port's training-mode batch norm before its stages, as it was
    (one process: no axes)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, channel_dim, out_dtype):
        dims = [d for d in range(x.dim()) if d != channel_dim]
        bshape = [1] * x.dim()
        bshape[channel_dim] = x.shape[channel_dim]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n_local = math.prod(x.shape[d] for d in dims)
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), float(n_local))])
        C = x.shape[channel_dim]
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp_min(stats[C:2 * C] / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        mul = (rstd * scale.to(xf.dtype)).view(bshape)
        y = ((xf - mean.view(bshape)) * mul + bias.to(xf.dtype).view(bshape))
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.dims, ctx.bshape, ctx.n = dims, bshape, n
        ctx.bias_dtype = bias.dtype
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(out_dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _mean, _var, _n):
        x, scale, mean, rstd = ctx.saved_tensors
        dims, bshape = ctx.dims, ctx.bshape
        C = mean.numel()
        xhat = (x.to(mean.dtype) - mean.view(bshape)) * rstd.view(bshape)
        dyf = dy.to(mean.dtype)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        sdy, sdyx = (local[:C] / ctx.n).view(bshape), \
            (local[C:] / ctx.n).view(bshape)
        dx = (dyf - sdy - xhat * sdyx) * (rstd * scale.to(rstd.dtype)
                                           ).view(bshape)
        return (dx.to(x.dtype), local[C:].to(scale.dtype),
                local[:C].to(ctx.bias_dtype), None, None, None)


def _before_module_update(m, mean, var, n):
    """The zoo module's running-average update as it was."""
    with torch.no_grad():
        if m.unbiased_running_var:
            var = var * torch.where(n > 1, n / (n - 1), torch.ones_like(n))
        k = m.momentum
        m.mean.mul_(k).add_((1 - k) * mean)
        m.var.mul_(k).add_((1 - k) * var)


# name: (shape, channel dim, memory format); the kernels' two layouts
LAYOUTS = {
    "nchw_channels_last": ((3, 5, 4, 6), 1, torch.channels_last),
    "nchw_contiguous": ((3, 5, 4, 6), 1, torch.contiguous_format),
    "nc": ((7, 5), 1, torch.contiguous_format),
    "ncl": ((3, 5, 9), 1, torch.contiguous_format),
    "rows_c_last": ((2, 7, 5), -1, torch.contiguous_format),
}


def _inputs(shape, cd, fmt, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 1.7 + 0.4)
    x = x.to(dtype).contiguous(memory_format=fmt)
    C = shape[cd]
    scale = torch.rand(C, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(C, generator=g, dtype=torch.float64)
    w = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    return x, scale, bias, w


def _pdtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stages_composed_equal_the_function_before_them(layout, dtype):
    """y, mean, var and n, and the gradients of x, scale and bias, to the
    bit, by the four stages called one after another and by the present
    autograd function."""
    shape, cd, fmt = LAYOUTS[layout]
    cd %= len(shape)
    x, scale, bias, w = _inputs(shape, cd, fmt, dtype)
    scale, bias = scale.to(_pdtype(dtype)), bias.to(_pdtype(dtype))

    xb = x.clone().requires_grad_()
    sb, bb = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    yb, mb, vb, nb = _Before.apply(xb, sb, bb, 1e-5, cd, dtype)
    (yb.to(torch.float64) * w.to(torch.float64)).sum().backward()

    stats = bn.stats(x, cd)
    y, mean, var, rstd = bn.normalize(x, stats, scale, bias, 1e-5, cd, dtype)
    n = stats[2 * mean.numel()]
    dy = w.to(y.dtype)
    local = bn.grad_sums(x, dy, mean, rstd, cd)
    dx = bn.grad_input(x, dy, mean, rstd, scale, local, n, cd)
    C = mean.numel()
    assert stats.dtype == local.dtype == n.dtype == torch.float64
    for got, want in ((y, yb), (mean, mb), (var, vb), (n.to(nb.dtype), nb),
                      (dx, xb.grad), (local[C:].to(scale.dtype), sb.grad),
                      (local[:C].to(bias.dtype), bb.grad)):
        assert got.dtype == want.dtype and torch.equal(got, want)

    # and the autograd function the port runs now
    xn = x.clone().requires_grad_()
    sn, bnn = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    yn, mn, vn, nn_ = batch_norm_train(xn, sn, bnn, (), 1e-5, cd, dtype)
    (yn.to(torch.float64) * w.to(torch.float64)).sum().backward()
    for got, want in ((yn, yb), (mn, mb), (vn, vb), (nn_.to(nb.dtype), nb),
                      (xn.grad, xb.grad), (sn.grad, sb.grad),
                      (bnn.grad, bb.grad)):
        assert torch.equal(got, want)


class _LiveAxis:
    """An axis of two ranks, for ``_axes_live``; the all-reduce over it is
    replaced by the test."""
    size = 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_vectors_cross_the_ranks_in_fp64(monkeypatch, dtype):
    """Over a live axis both all-reduced vectors are fp64, on the CPU as
    from the card's kernels; a sum over one rank then gives the bits of the
    function before, and ``n`` comes back in fp64."""
    from horovod_tpu_torch.train import sync_batch_norm as sbn
    seen = []

    def identity(v, axes):
        seen.append(v.dtype)
        return v.clone()

    monkeypatch.setattr(sbn, "_allreduce", identity)
    shape, cd, fmt = LAYOUTS["nchw_channels_last"]
    x, scale, bias, w = _inputs(shape, cd, fmt, dtype)
    scale, bias = scale.to(_pdtype(dtype)), bias.to(_pdtype(dtype))
    xb, xn = x.clone().requires_grad_(), x.clone().requires_grad_()
    yb, mb, vb, nb = _Before.apply(xb, scale, bias, 1e-5, cd, dtype)
    (yb.to(torch.float64) * w.to(torch.float64)).sum().backward()
    yn, mn, vn, nn_ = batch_norm_train(xn, scale, bias, [_LiveAxis()], 1e-5,
                                       cd, dtype)
    (yn.to(torch.float64) * w.to(torch.float64)).sum().backward()
    assert seen == [torch.float64, torch.float64]
    assert nn_.dtype == torch.float64 and mn.dtype == _pdtype(dtype)
    for got, want in ((yn, yb), (mn, mb), (vn, vb), (nn_.to(nb.dtype), nb),
                      (xn.grad, xb.grad)):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("recomputing", [False, True])
def test_module_running_averages_equal_the_update_before(unbiased,
                                                         recomputing):
    """The module's running averages, now updated by the normalize stage,
    equal the update the module made itself before, and stay as they were
    while a block is recomputed."""
    x, _, _, _ = _inputs((6, 4, 3, 2), 1, torch.channels_last, torch.float32)
    m = SyncBatchNorm(4, momentum=0.8, channel_dim=1,
                      unbiased_running_var=unbiased).train()
    ref = SyncBatchNorm(4, momentum=0.8, channel_dim=1,
                        unbiased_running_var=unbiased)
    with torch.no_grad():
        for mod in (m, ref):
            mod.mean.copy_(torch.linspace(-1, 1, 4))
            mod.var.copy_(torch.linspace(0.5, 2, 4))
    m.recomputing = recomputing
    m(x)
    _, mean, var, n = _Before.apply(x, ref.scale.detach(),
                                    ref.bias.detach(), ref.epsilon, 1,
                                    torch.float32)
    if not recomputing:
        _before_module_update(ref, mean, var, n)
    assert torch.equal(m.mean, ref.mean) and torch.equal(m.var, ref.var)


def test_adapter_running_averages_cast_before_the_update():
    """``Running`` buffers of another dtype than the statistics (the
    ``hvd.torch`` adapter's fp64 buffers over fp32 input) take the batch
    moments cast to their dtype, as the adapter did itself."""
    x, _, _, _ = _inputs((5, 3), 1, torch.contiguous_format, torch.float32)
    rm = torch.linspace(-1, 1, 3, dtype=torch.float64)
    rv = torch.linspace(0.5, 2, 3, dtype=torch.float64)
    want_m, want_v = rm.clone(), rv.clone()
    run = bn.Running(rm, rv, 0.9, 0.1, True)
    stats = bn.stats(x, 1)
    _, mean, var, _ = bn.normalize(x, stats, torch.ones(3), torch.zeros(3),
                                   1e-5, 1, torch.float32, run)
    n = stats[6]
    unbiased = var * torch.where(n > 1, n / (n - 1), torch.ones_like(n))
    want_m.mul_(0.9).add_(0.1 * mean.to(torch.float64))
    want_v.mul_(0.9).add_(0.1 * unbiased.to(torch.float64))
    assert torch.equal(rm, want_m) and torch.equal(rv, want_v)


# ResNet-50's BN inputs at batch 256 (rows = N·H·W, C) and ragged ones
PLAN_SHAPES = [(256 * 112 * 112, 64), (256 * 56 * 56, 256),
               (256 * 28 * 28, 512), (256 * 14 * 14, 1024),
               (256 * 7 * 7, 2048), (256 * 7 * 7, 512), (1, 3), (1, 2048),
               (17, 17), (12545, 3), (0, 5), (3, 1)]


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("elem_bytes,vec", [(2, True), (2, False),
                                            (4, True), (4, False),
                                            (8, True), (8, False)])
@pytest.mark.parametrize("rows,C", PLAN_SHAPES)
def test_plan_covers_every_row_and_channel(rows, C, elem_bytes, vec, layout):
    """Each channel in exactly one tile, each row in exactly one strip, no
    empty strip, at most 256 sums a CTA reduces (the kernels' shared
    memory), and the card filled where the rows allow."""
    S = 1 if layout == 0 else 49
    n = rows if layout == 0 else max(rows // 49, 0)
    p = bn.plan(layout, n, C, S, elem_bytes, vec, ctas=2 * 132)
    v = 16 // elem_bytes if vec else 1
    assert bn.THREADS % p.tx == 0
    if layout == 0:
        assert (p.tiles - 1) * p.tx * v < C <= p.tiles * p.tx * v
        assert 2 * p.tx * v <= bn.THREADS
        assert p.tx * v * elem_bytes <= 128
    else:
        assert p.tiles == C and p.tx * v >= min(S, bn.THREADS * v) / 2
    assert 1 <= p.strips <= 65535
    assert p.strips * p.rps >= n and (n == 0 or (p.strips - 1) * p.rps < n)
    ty = bn.THREADS // p.tx
    if n >= ty * bn.MIN_ROWS * 2 * 132:
        assert p.tiles * p.strips >= 2 * 132 - p.tiles


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """A CPU tensor, or an input or output dtype the kernels have no
    instance for, raises before any build or launch; two float dtypes of
    x and y are taken (a CPU tensor then fails on its device)."""
    x = torch.randn(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        bn.stats_cuda(x, 1)
    with pytest.raises(TypeError, match="dtype"):
        bn.stats_cuda(torch.ones(4, 3, dtype=torch.int32), 1)
    with pytest.raises(TypeError, match="dtype"):
        bn.normalize_cuda(x.double(), torch.zeros(7), torch.ones(3),
                          torch.zeros(3), 1e-5, 1, torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        bn.grad_sums_cuda(x, x.to(torch.complex64), torch.zeros(3),
                          torch.ones(3), 1)
    for xdt, ydt in ((torch.float64, torch.float32),
                     (torch.float32, torch.bfloat16),
                     (torch.float16, torch.bfloat16)):
        with pytest.raises(ValueError, match="CUDA"):
            bn.normalize_cuda(x.to(xdt), torch.zeros(7), torch.ones(3),
                              torch.zeros(3), 1e-5, 1, ydt)
    with pytest.raises(ValueError, match="CUDA"):
        bn.grad_sums_cuda(x, x, torch.zeros(3), torch.ones(3), 1)


def test_cpu_input_is_read_as_it_is():
    """Only CUDA tensors are copied to a layout the kernels read."""
    x = torch.randn(4, 6, 3, 5).transpose(2, 3)
    assert bn.kernel_input(x, 1) is x
