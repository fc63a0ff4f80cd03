"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc and skip without one. They import
nothing of JAX, so on a machine without it they run with the repository's
conftest left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import attention, quantize, xent
from horovod_tpu_torch.ops import batch_norm as bn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


BF = torch.bfloat16


@pytest.mark.parametrize("Sq,Sk,D,dtype,causal,scale,tol", [
    (256, 256, 64, torch.float32, True, None, 1e-4),
    (130, 130, 64, torch.float32, False, None, 1e-4),
    (77, 77, 128, torch.float32, True, None, 1e-4),
    (256, 256, 128, BF, False, None, 2e-2),
    (1, 1, 64, BF, True, None, 2e-2),
    # the bf16 kernel's edges: a ring that wraps many times (S 4096), a q or
    # key tile cut short, Sq != Sk with and without the mask, and a negative
    # scale (the kernel's second softmax form)
    (4096, 4096, 64, BF, True, None, 2e-2),
    (4096, 4096, 128, BF, True, None, 2e-2),
    (65, 65, 128, BF, True, None, 2e-2),
    (200, 200, 64, BF, True, None, 2e-2),
    (200, 200, 128, BF, False, None, 2e-2),
    (64, 200, 64, BF, True, None, 2e-2),
    (64, 200, 128, BF, False, None, 2e-2),
    (200, 70, 64, BF, True, None, 2e-2),
    (130, 77, 128, BF, False, None, 2e-2),
    (130, 130, 64, BF, True, -0.125, 2e-2),
])
def test_flash_kernel_matches_plain(dev, Sq, Sk, D, dtype, causal, scale, tol):
    q = _rand(dev, 2, Sq, 3, D, dtype=dtype, seed=0)
    k, v = (_rand(dev, 2, Sk, 3, D, dtype=dtype, seed=i) for i in (1, 2))
    before = attention.flash_attn_fwd_cuda.launches
    o, lse = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                scale=scale)
    assert attention.flash_attn_fwd_cuda.launches == before + 1
    o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.shape == (2 * 3, Sq)
    assert float((o.float() - o_ref.float()).abs().max()) <= tol
    assert float((lse - lse_ref).abs().max()) <= tol


@pytest.mark.parametrize("S,D,dtype,tol", [(96, 64, torch.float32, 1e-4),
                                           (200, 64, BF, 2e-2),
                                           (200, 128, BF, 2e-2)])
def test_flash_kernel_reads_strided_inputs(dev, S, D, dtype, tol):
    """q/k/v as views of a fused [B, S, 3, H, D] projection: no copy."""
    qkv = _rand(dev, 2, S, 3, 4, D, dtype=dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = attention.flash_attention_with_lse(q, k, v, causal=True)
    o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, True)
    assert float((o.float() - o_ref.float()).abs().max()) <= tol
    assert float((lse - lse_ref).abs().max()) <= tol


def test_flash_rect_keys(dev):
    q = _rand(dev, 1, 64, 2, 64, seed=1)
    k, v = _rand(dev, 1, 200, 2, 64, seed=2), _rand(dev, 1, 200, 2, 64, seed=3)
    for causal in (True, False):
        o, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
        o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal)
        assert float((o - o_ref).abs().max()) <= 1e-4
        assert float((lse - lse_ref).abs().max()) <= 1e-4


def test_flash_grads_on_card_match_cpu(dev):
    q, k, v = (_rand(dev, 1, 128, 2, 64, seed=i) for i in range(3))
    grads = []
    for d in (dev, torch.device("cpu")):
        ts = [x.detach().to(d).requires_grad_() for x in (q, k, v)]
        o, lse = attention.flash_attention_with_lse(*ts, causal=True)
        ((o ** 2).sum() + lse.sum()).backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 2e-4


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float32, 32)])
def test_flash_kernel_refuses_what_it_does_not_take(dev, dtype, D):
    q = _rand(dev, 1, 16, 1, D, dtype=dtype)
    with pytest.raises((TypeError, ValueError)):
        attention.flash_attention(q, q, q)


@pytest.mark.parametrize("Sq,Sk,dtype,causal,tol", [
    (256, 256, torch.float32, True, 1e-4),
    (130, 130, torch.float32, False, 1e-4),
    (77, 200, torch.float32, True, 1e-4),
    (4096, 4096, BF, True, 2e-2),
    (200, 200, BF, True, 2e-2),
    (200, 200, BF, False, 2e-2),
    (65, 65, BF, True, 2e-2),
    (64, 200, BF, False, 2e-2),
    (130, 77, BF, True, 2e-2),
])
def test_flash_mla_instance_matches_plain(dev, Sq, Sk, dtype, causal, tol):
    """The (192, 128) instance of multi-head latent attention: q/k of 192
    dims, v a strided view of the fused [.., 128 + 128] up-projection, at
    the softmax scale DeepSeek-V2 takes with YaRN."""
    scale = 192 ** -0.5 * (0.1 * 0.707 * np.log(40.0) + 1.0) ** 2
    q = _rand(dev, 2, Sq, 3, 192, dtype=dtype, seed=0)
    k = _rand(dev, 2, Sk, 3, 192, dtype=dtype, seed=1)
    kv = _rand(dev, 2, Sk, 3, 256, dtype=dtype, seed=2)
    v = kv[..., 128:]
    assert not v.is_contiguous()
    before = attention.flash_attn_fwd_cuda.launches
    o, lse = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                scale=scale)
    assert attention.flash_attn_fwd_cuda.launches == before + 1
    o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == (2, Sq, 3, 128)
    assert float((o.float() - o_ref.float()).abs().max()) <= tol
    assert float((lse - lse_ref).abs().max()) <= tol


@pytest.mark.parametrize("Dqk,Dv", [(192, 64), (128, 192), (64, 128)])
def test_flash_kernel_refuses_pairs_it_has_no_instance_for(dev, Dqk, Dv):
    q = _rand(dev, 1, 16, 1, Dqk, dtype=BF)
    v = _rand(dev, 1, 16, 1, Dv, dtype=BF)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, v)


def _nan_pools(dev):
    """Fill the caching allocator's free blocks, small and large, with NaN,
    so memory a kernel leaves unwritten reads NaN."""
    junk = [torch.full((1 << 17,), float("nan"), device=dev)
            for _ in range(512)]
    junk.append(torch.full((1 << 28,), float("nan"), device=dev))
    del junk


@pytest.mark.parametrize("first,held", [(0, 8), (2, 4)])
def test_dropless_moe_bf16_matches_a_loop_with_an_idle_expert(dev, first,
                                                               held):
    """The dropless layer's forward and backward in bfloat16 on the card
    against a float32 loop over the held experts, with one held expert
    that no token picks, on memory that held NaN: all 8 experts held (the
    offsets cover every row) and 4 of 8 (the rows of pairs held elsewhere
    trail the groups). The idle expert's weight gradients are zero."""
    from horovod_tpu_torch.parallel import moe
    T, M, F, E, k = 2048, 512, 256, 8, 3
    idle = first + 1
    x = (_rand(dev, T, M, seed=0)).to(BF).requires_grad_()
    logits = _rand(dev, T, E, seed=1)
    logits[:, idle] = -1e4
    logits.requires_grad_()
    wg, wu = (_rand(dev, held, F, M, seed=s).mul_(M ** -0.5)
              .requires_grad_() for s in (2, 3))
    wd = _rand(dev, held, M, F, seed=4).mul_(F ** -0.5).requires_grad_()
    cot = _rand(dev, T, M, seed=5)
    leaves = [x, logits, wg, wu, wd]
    _nan_pools(dev)
    y, routing, pairs = moe.dropless_moe(x, logits, k, first, held, wg, wu,
                                         wd)
    got = torch.autograd.grad((y.float() * cot).sum()
                              + routing.weight.sum(), leaves)
    assert int(pairs.counts[idle - first]) == 0
    scores = torch.softmax(logits, -1)
    weight, index = torch.topk(scores, k, -1)
    xf = x.float()
    want_y = torch.zeros(T, M, device=dev)
    for e in range(held):
        w_e = (weight * (index == first + e)).sum(-1, keepdim=True)
        h = torch.nn.functional.silu(xf @ wg[e].t()) * (xf @ wu[e].t())
        want_y = want_y + w_e * (h @ wd[e].t())
    want = torch.autograd.grad((want_y * cot).sum() + weight.sum(), leaves)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())
    assert y.dtype == BF and rel(y, want_y) <= 2e-2
    for name, a, b in zip(["x", "logits", "gate", "up", "down"], got, want):
        assert bool(torch.isfinite(a).all()), name
        assert rel(a, b) <= 2e-2, name
    for a in got[2:]:
        assert float(a[idle - first].abs().max()) == 0.0


@pytest.mark.parametrize("V,dtype", [(1000, torch.float32),
                                     (1001, torch.bfloat16),
                                     (32000, torch.bfloat16),
                                     (7, torch.float32)])
def test_xent_kernel_matches_plain(dev, V, dtype):
    N = 300
    logits = (_rand(dev, N, V) * 2.0).to(dtype)
    g = torch.Generator(device=dev).manual_seed(4)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::5] = -1
    labels[1::7] = V
    before = xent.xent_fwd_cuda.launches
    loss = xent.fused_softmax_xent(logits, labels)
    assert xent.xent_fwd_cuda.launches == before + 1
    ref, _ = xent.plain_xent(logits, labels)
    torch.cuda.synchronize()
    rel = ((loss - ref).abs() / ref.abs().clamp_min(1e-6)).max()
    assert float(rel) <= 1e-5


def test_xent_kernel_row_stride_and_grad(dev):
    wide = _rand(dev, 64, 1024)
    logits = wide[:, :1000].requires_grad_(False)   # rows 1024 apart
    labels = torch.arange(64, device=dev) * 15
    loss, lse = xent.xent_fwd_cuda(logits, labels)
    ref, ref_lse = xent.plain_xent(logits, labels)
    assert float((loss - ref).abs().max()) <= 1e-4
    lt = logits.clone().requires_grad_()
    xent.fused_softmax_xent(lt, labels).sum().backward()
    lc = logits.cpu().requires_grad_()
    xent.fused_softmax_xent(lc, labels.cpu()).sum().backward()
    assert float((lt.grad.cpu() - lc.grad).abs().max()) <= 1e-5


def test_xent_kernel_refuses_fp16(dev):
    with pytest.raises(TypeError):
        xent.fused_softmax_xent(_rand(dev, 4, 8, dtype=torch.float16),
                                torch.zeros(4, dtype=torch.long, device=dev))


# -- the block-int8 codec and the fused optimizer kernels ----------------------

def _ulps(a, b):
    """ULP distance of two positive fp32 tensors."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


QUANT_SHAPES = [(64000, 256), (33, 128), (7, 100), (5, 1), (3, 1030)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_quantizers_match_plain(dev, shape, dtype):
    x = _rand(dev, *shape, dtype=dtype, seed=5)
    x[shape[0] // 2] = 0.0                       # an all-zero row
    before = (quantize.quantize_cuda.launches,
              quantize.quantize_ef_cuda.launches)
    vals, scales = quantize.block_quantize(x)
    v2, s2, res = quantize.block_quantize_ef(x)
    assert (quantize.quantize_cuda.launches,
            quantize.quantize_ef_cuda.launches) == (before[0] + 1,
                                                    before[1] + 1)
    rv, rs, rres = quantize.plain_quantize_ef(x)
    torch.cuda.synchronize()
    # the kernels do the plain versions' IEEE operations in the same order
    # (rintf, divisions, unfused products): every code and scale is equal
    for v, s in ((vals, scales), (v2, s2)):
        assert int((v != rv).sum()) == 0
        assert _ulps(s, rs) == 0
    assert float((res - rres).abs().max()) <= 1e-6
    assert float(scales[shape[0] // 2]) == 1.0
    assert not vals[shape[0] // 2].any()


@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_optimizer_kernels_match_plain(dev, shape):
    vals, scales = quantize.plain_quantize(_rand(dev, *shape, seed=6))
    mom = _rand(dev, *shape, seed=7)
    m = _rand(dev, *shape, seed=8) * 0.1
    v = _rand(dev, *shape, seed=9).abs() * 0.01
    hp = (1e-3, 0.9, 0.999, 1e-8, 0.271, 0.002997)
    pairs = [
        (quantize.block_dequantize(vals, scales),
         quantize.plain_dequantize(vals, scales)),
        (quantize.fused_sgd_apply(vals, scales, None, 0.5, 0.0)[0],
         quantize.plain_fused_sgd0(vals, scales, 0.5)),
        (quantize.fused_sgd_apply(vals, scales, mom, 0.5, 0.9),
         quantize.plain_fused_sgd(vals, scales, mom, 0.5, 0.9)),
        (quantize.fused_adam_apply(vals, scales, m, v, *hp),
         quantize.plain_fused_adam(vals, scales, m, v, *hp)),
    ]
    torch.cuda.synchronize()
    for got, ref in pairs:
        for g, r in zip(*((got, ref) if isinstance(got, tuple)
                          else ((got,), (ref,)))):
            assert float((g - r).abs().max()) <= 1e-6


def test_optimizer_kernels_leave_their_operands_untouched(dev):
    vals, scales = quantize.plain_quantize(_rand(dev, 40, 256, seed=10))
    m, v = _rand(dev, 40, 256, seed=11), _rand(dev, 40, 256, seed=12).abs()
    before = (m.clone(), v.clone())
    hp = (1e-3, 0.9, 0.999, 1e-8, 0.1, 0.001)
    ref = quantize.plain_fused_adam(vals, scales, m, v, *hp)
    got = quantize.fused_adam_apply(vals, scales, m, v, *hp)
    _, mom = quantize.fused_sgd_apply(vals, scales, m, 0.5, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(m, before[0]) and torch.equal(v, before[1])
    assert not torch.equal(mom, m)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-6


def test_fused_optimizer_step_on_card_matches_cpu(dev):
    from horovod_tpu_torch import DistributedOptimizer, ErrorFeedback, fused_adam
    from horovod_tpu_torch.compression import Compression
    ps = [torch.nn.Parameter(_rand(dev, 300, 7, seed=13)) for _ in range(2)]
    cpu = [torch.nn.Parameter(p.detach().cpu()) for p in ps]
    opts = [DistributedOptimizer(fused_adam(1e-3), group,
                                 compression=ErrorFeedback(Compression.int8))
            for group in (ps, cpu)]
    for step in range(3):
        for group in (ps, cpu):
            for i, p in enumerate(group):
                p.grad = _rand(dev, 300, 7, seed=20 + step + i).to(p.device)
        for o in opts:
            o.step()
    for a, b in zip(ps, cpu):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-6


@pytest.mark.parametrize("call", [
    lambda d: quantize.block_quantize(torch.zeros(4, 256, device=d,
                                                  dtype=torch.float16)),
    lambda d: quantize.block_quantize_ef(torch.zeros(4, 256, device=d,
                                                     dtype=torch.float64)),
    lambda d: quantize.block_dequantize(
        torch.zeros(4, 256, device=d), torch.ones(4, 1, device=d)),
    lambda d: quantize.fused_sgd_apply(
        torch.zeros(4, 256, dtype=torch.int8, device=d),
        torch.ones(4, 1, device=d, dtype=torch.float64), None, 0.1, 0.0),
], ids=["fp16", "fp64", "float_codes", "fp64_scales"])
def test_quantize_kernels_refuse_unsupported_dtypes(dev, call):
    with pytest.raises(TypeError):
        call(dev)


# -- data parallelism over NCCL (a world of one on the card) -------------------

@pytest.fixture
def nccl_mesh(dev):
    """An NCCL process group of world 1 and its dp mesh; an axis of size 1
    still runs its collectives (on NCCL's stream)."""
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    hvd.init()
    yield hvd.build_mesh(dp=1)
    hvd.shutdown()


def test_preduce_quantized_on_nccl_world_of_one(nccl_mesh):
    """reduce_scatter (one slice), the quantize kernel, the gather, one
    dequantize: the codes·scales of the input, equal to the plain
    versions."""
    from horovod_tpu_torch.compression import BlockInt8Quantizer
    from horovod_tpu_torch.ops.mesh_collectives import preduce_quantized
    from horovod_tpu_torch.ops.reduce_op import Average
    x = _rand(torch.device("cuda", 0), 65536 + 300, seed=30)
    before = (quantize.quantize_cuda.launches,
              quantize.dequantize_cuda.launches)
    got = preduce_quantized(x, nccl_mesh.axis("dp"), BlockInt8Quantizer(256),
                            Average)
    assert (quantize.quantize_cuda.launches,
            quantize.dequantize_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)
    ref = BlockInt8Quantizer(256).qdq(x.cpu())
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == x.shape
    assert float((got.cpu() - ref).abs().max()) <= 1e-6


def test_dist_plane_on_nccl_world_of_one(nccl_mesh):
    """The eager ``torch.distributed`` plane over the NCCL group of one,
    on CUDA tensors: every op's result is ``LocalBackend``'s, on the card
    and in the input's dtype, for fp32, bf16 and int64."""
    from horovod_tpu_torch.ops.backend import LocalBackend
    from horovod_tpu_torch.ops.dist_backend import DistBackend
    from horovod_tpu_torch.ops.reduce_op import ReduceOp
    d = torch.device("cuda", 0)
    plane, local = DistBackend(), LocalBackend()
    try:
        for dt in (torch.float32, torch.bfloat16, torch.int64):
            x = (_rand(d, 6, 5, seed=40) * 10).to(dt)
            ops = [ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX]
            if dt.is_floating_point:
                ops.append(ReduceOp.AVERAGE)
            got = [plane.allreduce_async("x", x, op).wait() for op in ops]
            want = [local.allreduce_async("x", x, op).wait() for op in ops]
            got += [plane.grouped_allreduce_async(["a", "b"], [x, x[0]],
                                                  ReduceOp.SUM).wait()[1],
                    plane.allgather_async("g", x).wait(),
                    plane.broadcast_async("b", x, 0).wait(),
                    plane.alltoall_async("t", x, [6]).wait()[0],
                    plane.reducescatter_async("r", x, ReduceOp.SUM).wait()]
            want += [x[0], x, x, x, x]
            for g, w in zip(got, want):
                assert g.is_cuda and g.dtype == dt and torch.equal(g, w)
    finally:
        plane.shutdown()


def _w_eager_nccl():
    """One rank of the NCCL eager plane over two cards: the eager API on
    this rank's card against host references."""
    import horovod_tpu_torch as hvd
    r, n = hvd.rank(), hvd.size()
    d = hvd.device()
    x = torch.arange(12.0, device=d).reshape(3, 4) + r
    out = hvd.allreduce(x, op=hvd.Sum, name="x")
    ag = hvd.allgather(torch.full((r + 1, 2), float(r), device=d), name="ag")
    b = hvd.broadcast(x, root_rank=1, name="b")
    t, recv = hvd.alltoall(torch.arange(float(n * 2), device=d) + 10 * r,
                           name="t")
    grp = hvd.grouped_allreduce([x, x.to(torch.bfloat16)], name="g")
    assert all(o.device == d for o in (out, ag, b, t, *grp))
    return {"out": out.cpu().numpy(), "ag": ag.cpu().numpy(),
            "b": b.cpu().numpy(), "t": t.cpu().numpy(),
            "g0": grp[0].cpu().numpy(), "g1": grp[1].float().cpu().numpy()}


def test_dist_plane_over_nccl_two_cards(tmp_path):
    """Two cards, one NCCL rank each, ``HVD_TPU_EAGER_BACKEND=dist``: the
    eager API keeps CUDA tensors on their card and gives the host
    references."""
    from torch_port_worker import spawn_world
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ranks = spawn_world(__file__, "eager_nccl", 2, tmp_path,
                        {"HOROVOD_TPU_OPERATIONS": "NCCL",
                         "HVD_TPU_EAGER_BACKEND": "dist"}, timeout=300)
    x = [np.arange(12.0).reshape(3, 4) + r for r in range(2)]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["out"], x[0] + x[1])
        np.testing.assert_array_equal(res["ag"], [[0, 0], [1, 1], [1, 1]])
        np.testing.assert_array_equal(res["b"], x[1])
        np.testing.assert_array_equal(res["t"], [2 * r, 2 * r + 1,
                                                 10 + 2 * r, 11 + 2 * r])
        np.testing.assert_array_equal(res["g0"], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(res["g1"], (x[0] + x[1]) / 2)


@pytest.mark.parametrize("compression", [None, "int8"])
def test_bucketed_grad_sync_on_nccl_world_of_one(nccl_mesh, compression):
    """Three buckets of a small tree: dense, the average of one rank is the
    input; int8, each bucket's packed vector quantized once and
    dequantized once (blocks cross leaf edges, as in the JAX plan)."""
    from horovod_tpu_torch.compression import BlockInt8Quantizer
    from horovod_tpu_torch.train import buckets
    from horovod_tpu_torch.train.overlap import bucketed_grad_sync
    d = torch.device("cuda", 0)
    tree = {"a": _rand(d, 300, 7, seed=31), "b": _rand(d, 1000, seed=32),
            "c": _rand(d, 64, 64, seed=33)}
    codec = BlockInt8Quantizer(256) if compression else None
    plan = buckets.plan_buckets(tree, 9000)
    before = (quantize.quantize_cuda.launches,
              quantize.dequantize_cuda.launches)
    out = bucketed_grad_sync(tree, nccl_mesh.axis("dp"), bucket_bytes=9000,
                             compression=codec)
    n = plan.num_buckets if compression else 0
    assert plan.num_buckets == 3
    assert (quantize.quantize_cuda.launches,
            quantize.dequantize_cuda.launches) == (before[0] + n,
                                                   before[1] + n)
    leaves = [tree[k] for k in sorted(tree)]
    for bucket in plan.buckets:
        vec = buckets.pack([t.cpu() for t in leaves], bucket)
        if codec is not None:
            vec = codec.qdq(vec)
        for i, want in zip(bucket.indices, buckets.unpack(
                vec, bucket, [t.cpu() for t in leaves])):
            got = out[sorted(tree)[i]]
            assert got.is_cuda
            assert float((got.cpu() - want).abs().max()) <= 1e-6


def test_overlap_engine_on_the_card_matches_the_cpu(nccl_mesh):
    """The hooks launch each bucket from the backward pass on the card and
    the next microbatch runs while it is in flight; the synced gradients
    equal the mean of the same model's microbatch gradients on the
    CPU."""
    from horovod_tpu_torch.train.overlap import pipelined_accumulate
    torch.manual_seed(0)
    cpu = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(),
                              torch.nn.Linear(256, 64))
    card = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(),
                               torch.nn.Linear(256, 64)).cuda()
    card.load_state_dict(cpu.state_dict())
    x, y = torch.randn(32, 64), torch.randn(32, 64)

    def loss_fn(m, b):
        return ((m(b[0]) - b[1]) ** 2).mean()

    micro = tuple(t.reshape(4, 8, 64) for t in (x, y))
    _, got = pipelined_accumulate(loss_fn, card,
                                  tuple(t.cuda() for t in micro),
                                  axis=nccl_mesh.axis("dp"), bucket_bytes=4096)
    want = dict(zip([n for n, _ in cpu.named_parameters()],
                    [torch.zeros_like(p) for p in cpu.parameters()]))
    for k in range(4):
        gs = torch.autograd.grad(loss_fn(cpu, (x[8 * k:8 * k + 8],
                                               y[8 * k:8 * k + 8])),
                                 list(cpu.parameters()))
        for (n, _), g in zip(cpu.named_parameters(), gs):
            want[n] += g / 4
    torch.cuda.synchronize()
    for n, g in got.items():
        assert g.is_cuda
        assert float((g.cpu() - want[n]).abs().max()) <= 1e-5, n


# -- the observability plane on the card ---------------------------------------

def test_eager_sync_exposed_seconds_on_nccl_world_of_one(nccl_mesh):
    """The eager bucketed sync over NCCL: the seconds blocked on the wire
    are positive (the host waits for the collectives to end on the card,
    not for their queueing) and no more than the sync's wall seconds; the
    int8 bytes are each leaf's codes and scales."""
    from horovod_tpu_torch.common.process_sets import global_process_set
    from horovod_tpu_torch.compression import BlockInt8Quantizer, Compression
    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.ops.reduce_op import Average
    from horovod_tpu_torch.train.optimizer import _eager_allreduce_tree
    d = torch.device("cuda", 0)
    reg = default_registry()
    grads = {"a": _rand(d, 4096, 1024, seed=40), "b": _rand(d, 3000, seed=41)}
    for codec in (Compression.none, BlockInt8Quantizer(256)):
        out = _eager_allreduce_tree(grads, Average, global_process_set, codec,
                                    1.0, 1.0, bucket_bytes=1 << 20)
        exposed = reg.get("hvd_overlap_exposed_comm_seconds").value
        sync = reg.get("hvd_overlap_sync_seconds").value
        assert 0.0 < exposed <= sync
        assert reg.get("hvd_overlap_bucket_count").value == 2
        for k, g in grads.items():
            want = g if codec is Compression.none else codec.qdq(g)
            assert float((out[k] - want).abs().max()) <= 1e-6, k
    pre = reg.get("hvd_compression_pre_bytes_total", {"codec": "int8"})
    wire = reg.get("hvd_compression_wire_bytes_total", {"codec": "int8"})
    assert pre.value >= 4 * (4096 * 1024 + 3000)
    assert wire.value >= 4096 * 1024 // 256 * 260 + 12 * 260


def test_profile_capture_names_the_hand_written_kernels(dev, tmp_path,
                                                        monkeypatch):
    """A one-step capture window around the flagship's two forward kernels:
    its Chrome trace names both as device kernels."""
    import json
    import os

    from horovod_tpu_torch.profiling.manager import ProfileManager
    monkeypatch.setenv("HVD_TPU_PROFILE_DIR", str(tmp_path))
    mgr = ProfileManager()
    plan = mgr.request_capture(steps=1, reason="test")
    q, k, v = (_rand(dev, 2, 256, 8, 64, dtype=BF, seed=s) for s in (1, 2, 3))
    logits = _rand(dev, 512, 32000, dtype=BF, seed=4)
    labels = torch.randint(0, 32000, (512,), device=dev)
    mgr.on_step_begin(1)
    attention.flash_attn_fwd_cuda(q, k, v, True, 0.125)
    xent.xent_fwd_cuda(logits, labels)
    mgr.on_step_end(1)
    rec = mgr.recent_captures()[-1]
    assert rec["path"] == plan["path"] and rec["bytes"] > 0
    with open(os.path.join(rec["path"], "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert any("flash_fwd_kernel" in n for n in names), sorted(names)[:20]
    assert any("xent_fwd_kernel" in n for n in names), sorted(names)[:20]


def test_memory_gauges_read_the_card(dev):
    """The sampler's stats are the card's allocator under the JAX
    package's keys."""
    from horovod_tpu_torch.profiling import memory
    x = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    (st,) = memory.device_stats()
    assert st["bytes_in_use"] >= x.numel()
    assert 0 < st["peak_bytes_in_use"] <= st["bytes_limit"]
    assert st["bytes_limit"] == torch.cuda.mem_get_info(dev)[1]


# -- ring attention over a gloo world of two ranks on the card ------------------

RING_SHAPE = (2, 512, 4, 64)     # [B, S, H, D] bf16, S split over sp = 2


def _w_ring():
    """One rank of the ``ring`` world (``cuda:0``, gloo): its block of the
    ring with the kernel and of the plain ring (the online algebra, no
    kernel) on the same bf16 inputs, causal and not, the kernel's launches,
    and both paths' gradients of ``sum(o * w)``."""
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.ring_attention import ring_attention_spmd
    dev = torch.device("cuda", 0)
    sp = hvd.build_mesh(sp=2).axis("sp")
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(*RING_SHAPE, generator=g, device=dev).to(BF)
               for _ in range(3))
    w = torch.randn(*RING_SHAPE, generator=g, device=dev)
    n = RING_SHAPE[1] // 2
    blk = slice(sp.index * n, (sp.index + 1) * n)
    out = {"sp_index": np.array(sp.index)}
    for causal in (True, False):
        for flash in (True, False):
            xs = [x[:, blk].clone().requires_grad_() for x in (q, k, v)]
            before = attention.flash_attn_fwd_cuda.launches
            o = ring_attention_spmd(*xs, sp, causal, use_flash=flash)
            out[f"launches_{causal}_{flash}"] = np.array(
                attention.flash_attn_fwd_cuda.launches - before)
            (o.float() * w[:, blk]).sum().backward()
            tag = f"{causal}_{flash}"
            out[f"o_{tag}"] = o.detach().float().cpu().numpy()
            for c, x in zip("qkv", xs):
                out[f"d{c}_{tag}"] = x.grad.float().cpu().numpy()
    return out


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_kernel_matches_plain_ring_on_gloo(dev, tmp_path,
                                                          causal):
    """At sp = 2, two gloo ranks sharing the card (gloo's send/recv cannot
    take CUDA tensors, so the ring's exchanges go through the host): the
    ring through ``flash_attn_fwd`` equals the plain ring within the
    kernel's bf16 tolerance (2e-2), and so do the gradients (rel L2); the
    kernel runs once on sp rank 0 and twice on rank 1 when causal (the
    later block is skipped), twice on both otherwise."""
    import numpy as np
    from torch_port_worker import spawn_world
    ranks = spawn_world(__file__, "ring", 2, tmp_path,
                        {"HOROVOD_TPU_OPERATIONS": "GLOO",
                         "HVD_TPU_LOCAL_RANK": "0",
                         "HVD_TPU_LOCAL_SIZE": "1"}, timeout=300)
    for r in ranks:
        i = int(r["sp_index"])
        got, ref = f"{causal}_True", f"{causal}_False"
        assert float(np.abs(r[f"o_{got}"] - r[f"o_{ref}"]).max()) <= 2e-2
        for c in "qkv":
            a, b = r[f"d{c}_{got}"], r[f"d{c}_{ref}"]
            assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2e-2, c
        assert int(r[f"launches_{got}"]) == (i + 1 if causal else 2)
        assert int(r[f"launches_{ref}"]) == 0


# -- a 1F1B pipeline over NCCL, one rank a card ---------------------------------

PP_L, PP_D, PP_STEPS = 4, 64, 3


def _pp_inputs():
    import numpy as np
    rng = np.random.RandomState(0)
    w = (rng.randn(PP_L, PP_D, PP_D) * 0.3).astype(np.float32)
    x = rng.randn(16, PP_D).astype(np.float32)
    t = rng.randn(16, PP_D).astype(np.float32)
    return w, x, t


def _w_pp_nccl():
    """One rank of the ``pp_nccl`` world: ``make_pipeline_train_step`` with
    the 1F1B schedule over {pp:2}, NCCL, this rank's card; three SGD steps'
    losses and the gathered final weights."""
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.train.pipeline import make_pipeline_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = hvd.device()
    w, x, t = _pp_inputs()
    step = make_pipeline_train_step(
        lambda lp, h: torch.tanh(h @ lp["w"]),
        lambda y, tgt: ((y - tgt) ** 2).mean(), n_layers=PP_L,
        mesh=hvd.dp_pp_mesh(pp=2), schedule="1f1b", pp=2, n_micro=4)
    p = step.prepare_params({"w": w})
    opt = torch.optim.SGD(p.parameters(), lr=0.1)
    batch = (torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev))
    losses = [float(step(p, opt, batch)[2]) for _ in range(PP_STEPS)]
    return {"losses": np.array(losses),
            "w": step.restore_params(p)["w"].cpu().numpy()}


def test_pipeline_1f1b_over_nccl_matches_one_process(tmp_path):
    """Two cards, one NCCL rank each: the 1F1B step's three losses and
    final weights equal plain SGD on the sequential model in fp32 on the
    CPU (1e-5 relative, the order of sums aside)."""
    import numpy as np
    from torch_port_worker import spawn_world
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ranks = spawn_world(__file__, "pp_nccl", 2, tmp_path,
                        {"HOROVOD_TPU_OPERATIONS": "NCCL"}, timeout=300)
    w, x, t = _pp_inputs()
    wt = torch.from_numpy(w).requires_grad_()
    opt = torch.optim.SGD([wt], lr=0.1)
    ref = []
    for _ in range(PP_STEPS):
        opt.zero_grad()
        h = torch.from_numpy(x)
        for i in range(PP_L):
            h = torch.tanh(h @ wt[i])
        loss = ((h - torch.from_numpy(t)) ** 2).mean()
        loss.backward()
        opt.step()
        ref.append(float(loss))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref, rtol=1e-5)
        np.testing.assert_allclose(r["w"], wt.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)



# -- checkpoints and the data path on the card ------------------------------

def test_checkpoint_cut_is_the_state_at_save_on_the_card(dev, tmp_path):
    """Tensors updated in place on the current stream right after
    ``save`` returns (the copies to the host still queued): the commit
    holds the values at the call, bf16 and fp32, to the bit."""
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    big = _rand(dev, 4096, 1024, seed=5)
    state = {"w": big, "b": _rand(dev, 3000, dtype=BF, seed=6),
             "step": torch.ones((), device=dev)}
    want = {k: v.cpu() for k, v in state.items()}
    ck = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    torch.cuda._sleep(50_000_000)   # the copies queue behind a busy stream
    ck.save(1, state)
    for t in state.values():
        t.mul_(-3.0).add_(1.0)
    ck.wait()
    out = ck.restore(1, like=state)
    for k, v in out.items():
        assert v.device == state[k].device and v.dtype == state[k].dtype
        assert torch.equal(v.cpu().view(torch.int16) if v.dtype == BF
                           else v.cpu(),
                           want[k].view(torch.int16) if v.dtype == BF
                           else want[k]), k


def test_checkpoint_bf16_leaf_roundtrips_to_the_bit(dev, tmp_path):
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.checkpoint import format as fmt
    x = _rand(dev, 513, 7, dtype=BF, seed=7)
    ck = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    ck.save(2, {"x": x}, wait=True)
    (leaf,) = fmt.read_manifest(str(tmp_path), 2)["leaves"]
    assert leaf["dtype"] == "bfloat16"
    got = ck.restore(2, like={"x": x})["x"]
    assert got.is_cuda and got.dtype == BF
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))
    host = ck.restore(2)["x"]
    assert not host.is_cuda and torch.equal(host.view(torch.int16),
                                            x.cpu().view(torch.int16))


def test_device_prefetch_side_stream_equal_batches_no_reuse(dev):
    """Batches copied on the side stream arrive equal, in order, while
    the consumer's stream is busy; a consumed batch's memory is not handed
    to a later batch while a kernel reading it may still run."""
    import numpy as np

    from horovod_tpu_torch.data import device_prefetch
    rng = np.random.RandomState(0)
    batches = [{"x": rng.randn(1024, 1024).astype(np.float32),
                "i": np.full((8,), i, np.int64)} for i in range(8)]
    pf = device_prefetch(iter(batches), buffer_size=2, device=dev)
    assert pf._stream is not None and \
        pf._stream != torch.cuda.current_stream(dev)
    sums = []
    for i, b in enumerate(pf):
        torch.cuda._sleep(20_000_000)         # the consumer is busy
        sums.append(b["x"].double().sum())
        assert b["x"].device == dev and int(b["i"][0]) == i
        del b
    for s, b in zip(sums, batches):
        assert float(s) == pytest.approx(float(b["x"].astype(np.float64)
                                               .sum()), rel=1e-12)



# -- the model zoo and sync-BN (no kernel of their own: cuDNN and cuBLAS) ---

ZOO_SMALL = [("resnet50", {"stem": "conv"}, 64),
             ("resnet50", {"stem": "s2d"}, 64), ("resnet101", {}, 64),
             ("vgg16", {"image_size": 64}, 64), ("inception3", {}, 299)]


@pytest.mark.parametrize("name,kw,size", ZOO_SMALL)
def test_zoo_bf16_forward_on_card_matches_fp32_on_cpu(dev, name, kw, size):
    """Full width, batch 4, train mode (batch statistics), a small input
    (Inception at its own 299: at 95 its 1x1 last blocks normalize over 4
    values): the card's bf16 loss within 2e-2 of the CPU's fp32 one
    (PERF.md §2), the card's fp32 logits within 5e-2 of the CPU's largest
    (chip_smoke's bound; a deep random conv-BN-ReLU stack multiplies
    rounding differences, see ZOO_LOGITS_PRINTED there)."""
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models._flax import init_state
    torch.backends.cudnn.allow_tf32 = False
    ref = get_model(name, dtype=torch.float32, device="cpu", **kw)
    init_state(ref, 0)
    sd = ref.state_dict()
    g = torch.Generator().manual_seed(1)
    x = torch.rand(4, 3, size, size, generator=g)
    y = torch.randint(0, 1000, (4,), generator=g)
    out = {}
    for tag, d, dtype in (("cpu", "cpu", torch.float32),
                          ("fp32", dev, torch.float32),
                          ("bf16", dev, torch.bfloat16)):
        m = get_model(name, dtype=dtype, device=d, **kw)
        m.load_state_dict(sd)
        m.train()
        if hasattr(m, "dropout"):
            m.dropout = 0.0
        with torch.no_grad():
            logits = m(x.to(d)).float().cpu()
        loss = torch.nn.functional.cross_entropy(logits, y)
        out[tag] = (logits, float(loss))
    scale = float(out["cpu"][0].abs().max())
    assert float((out["fp32"][0] - out["cpu"][0]).abs().max()) <= 5e-2 * scale
    assert abs(out["bf16"][1] - out["cpu"][1]) <= 2e-2 * abs(out["cpu"][1])


@pytest.mark.parametrize("name", ["bert_base", "bert_large"])
def test_bert_bf16_forward_on_card_matches_fp32_on_cpu(dev, name):
    """Two layers at full width, B 4, S 32: the card's bf16 MLM logits
    within 5e-2 of the largest fp32 logit on the CPU, the loss within
    2e-2."""
    import dataclasses
    from horovod_tpu_torch.models import bert
    cfg = dataclasses.replace(getattr(bert, name)(torch.float32),
                              num_layers=2)
    ref = bert.Bert(cfg, "cpu")
    bert.init_bert(ref, 0)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    b = {"input_ids": ids, "token_type_ids": torch.zeros_like(ids),
         "attention_mask": torch.ones_like(ids, dtype=torch.bool),
         "mlm_labels": torch.randint(0, cfg.vocab_size, (4, 32), generator=g),
         "mlm_mask": (torch.rand(4, 32, generator=g) < 0.15).float(),
         "nsp_labels": torch.randint(0, 2, (4,), generator=g)}
    out = {}
    for tag, d, dtype in (("cpu", "cpu", torch.float32),
                          ("bf16", dev, torch.bfloat16)):
        m = bert.Bert(dataclasses.replace(cfg, dtype=dtype), d)
        m.load_state_dict(ref.state_dict())
        bd = {k: v.to(d) for k, v in b.items()}
        with torch.no_grad():
            mlm, nsp = m(bd["input_ids"], bd["token_type_ids"],
                         bd["attention_mask"])
            loss = bert.pretrain_loss(mlm, nsp, bd["mlm_labels"],
                                      bd["mlm_mask"], bd["nsp_labels"])
        out[tag] = (mlm.float().cpu(), float(loss))
    scale = float(out["cpu"][0].abs().max())
    assert float((out["bf16"][0] - out["cpu"][0]).abs().max()) <= 5e-2 * scale
    assert abs(out["bf16"][1] - out["cpu"][1]) <= 2e-2 * abs(out["cpu"][1])


def test_sync_batch_norm_over_nccl_world_of_one(nccl_mesh):
    """SyncBatchNorm with the dp axis of an NCCL world of one (an axis of
    size 1 reduces nothing): value, gradients and the unbiased running
    variance equal the CPU's."""
    from horovod_tpu_torch.train.sync_batch_norm import SyncBatchNorm
    g = torch.Generator().manual_seed(3)
    x = torch.randn(16, 6, generator=g) * 2 + 1
    w = torch.randn(16, 6, generator=g)
    out = {}
    for d in ("cpu", "cuda"):
        m = SyncBatchNorm(6, axes=[nccl_mesh.axis("dp")], device=d).train()
        xs = x.to(d).clone().requires_grad_()
        y = m(xs)
        (y * w.to(d)).sum().backward()
        out[d] = [t.detach().cpu() for t in (y, xs.grad, m.scale.grad,
                                             m.bias.grad, m.mean, m.var)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-5


# -- the batch norm kernels (csrc/batch_norm.cu) ------------------------------

# (x, y) dtypes: the kernels' own (one dtype) and pairs they run in the
# statistics' dtype; (shape, channels innermost): ResNet-50's stem and stage
# 4 at a smaller batch in both layouts, and ragged ones (C 3, 17 and 2048;
# M 1 and odd row counts; [N, C] and [N, C, L])
BN_PAIRS = [(BF, BF), (torch.float16, torch.float16),
            (torch.float32, torch.float32), (torch.float64, torch.float64),
            (BF, torch.float32), (torch.float16, torch.float32),
            (torch.float32, BF), (torch.float16, BF),
            (torch.float64, torch.float32)]
BN_SHAPES = [((16, 64, 112, 112), True), ((16, 64, 112, 112), False),
             ((64, 2048, 7, 7), True), ((64, 2048, 7, 7), False),
             ((5, 3, 9, 11), True), ((5, 3, 9, 11), False),
             ((1, 17, 3, 5), True), ((7, 17), False), ((1, 2048), False),
             ((3, 17, 33), False), ((3, 2048, 1, 1), True)]


def _bn_case(dev, shape, inner, xdt, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    fmt = torch.channels_last if inner and len(shape) == 4 else \
        torch.contiguous_format
    x = (torch.randn(shape, generator=g, device=dev, dtype=torch.float64)
         * 1.5 + 0.3).to(xdt).contiguous(memory_format=fmt)
    dy = torch.randn(shape, generator=g, device=dev,
                     dtype=torch.float64).to(xdt).contiguous(
                         memory_format=fmt)
    acc = bn.stat_dtype(x)
    C = shape[1]
    scale = (torch.rand(C, generator=g, device=dev, dtype=torch.float64)
             + 0.5).to(acc)
    bias = torch.randn(C, generator=g, device=dev, dtype=torch.float64
                       ).to(acc)
    return x, dy, scale, bias


def _sums_close(got, want, scale, tol):
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max()) <= tol


@pytest.mark.parametrize("shape,inner", BN_SHAPES)
@pytest.mark.parametrize("xdt,ydt", BN_PAIRS)
def test_bn_kernels_match_plain(dev, shape, inner, xdt, ydt):
    """Each stage against its plain version on the card: the kernels' fp64
    sums within the plain sums' rounding (fp32 sums 1e-5 of Σ|.|, fp64
    1e-12), and from the same sums rounded to the statistics' dtype y, mean,
    var, rstd, the running averages and dx to the bit."""
    x, dy, scale, bias = _bn_case(dev, shape, inner, xdt)
    dy = dy.to(ydt)
    cd, C = 1, shape[1]
    tol = 1e-12 if xdt == torch.float64 else 1e-5
    xa = x.to(bn.stat_dtype(x))
    before = bn.launch_kernel.launches
    st = bn.stats_cuda(x, cd)
    st_ref = bn.plain_stats(x, cd)
    ab = bn.plain_stats(xa.abs(), cd)
    assert _sums_close(st[:C], st_ref[:C], ab[:C], tol)
    assert _sums_close(st[C:], st_ref[C:], ab[C:], tol)
    assert float(st[2 * C]) == float(st_ref[2 * C])

    acc = bn.stat_dtype(x)
    for unbiased in (False, True):
        runs = [bn.Running(torch.linspace(-1, 1, C, device=dev, dtype=acc),
                           torch.linspace(0.5, 2, C, device=dev, dtype=acc),
                           0.9, 0.1, unbiased) for _ in range(2)]
        y, mean, var, rstd = bn.normalize_cuda(x, st, scale, bias, 1e-5, cd,
                                               ydt, runs[0])
        ref = bn.plain_normalize(x, st.to(acc), scale, bias, 1e-5, cd, ydt)
        bn.plain_update_running(runs[1], ref[1], ref[2], st[2 * C].to(acc))
        assert y.dtype == ydt and y.stride() == x.stride()
        for a, b in zip((y, mean, var, rstd, runs[0].mean, runs[0].var),
                        (*ref, runs[1].mean, runs[1].var)):
            assert torch.equal(a, b)

    sums = bn.grad_sums_cuda(x, dy, mean, rstd, cd)
    sums_ref = bn.plain_grad_sums(x, dy, mean, rstd, cd)
    abs_ref = bn.plain_grad_sums(x.abs(), dy.abs(), torch.zeros_like(mean),
                                 rstd, cd)
    assert _sums_close(sums[:C], sums_ref[:C], abs_ref[:C], tol)
    # Σ|dy|·|x − mean|·rstd bounds the cancellation in Σdy·x̂
    abs_dyx = bn.plain_grad_sums((x.to(mean.dtype) - mean.view(1, C, *[1] * (
        x.dim() - 2))).abs(), dy.abs(), torch.zeros_like(mean), rstd, cd)
    assert _sums_close(sums[C:], sums_ref[C:], abs_dyx[C:], tol)
    dx = bn.grad_input_cuda(x, dy, mean, rstd, scale, sums, st[2 * C], cd)
    dx_ref = bn.plain_grad_input(x, dy, mean, rstd, scale, sums.to(acc),
                                 st[2 * C].to(acc), cd)
    torch.cuda.synchronize()
    assert dx.dtype == xdt and dx.stride() == x.stride()
    assert torch.equal(dx, dx_ref)
    assert bn.launch_kernel.launches == before + 5


@pytest.mark.parametrize("shape,inner", [((16, 64, 112, 112), True),
                                         ((64, 2048, 7, 7), False),
                                         ((7, 17), False)])
def test_bn_kernels_give_the_same_bits_twice(dev, shape, inner):
    """The sums take no float atomics: two calls, the same bits."""
    x, dy, scale, bias = _bn_case(dev, shape, inner, BF)
    outs = []
    for _ in range(2):
        st = bn.stats_cuda(x, 1)
        y, mean, var, rstd = bn.normalize_cuda(x, st, scale, bias, 1e-5, 1,
                                               BF)
        sums = bn.grad_sums_cuda(x, dy, mean, rstd, 1)
        outs.append((st, y, sums, bn.grad_input_cuda(
            x, dy, mean, rstd, scale, sums, st[2 * shape[1]], 1)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_bn_kernels_refuse_what_they_do_not_take(dev):
    x = torch.randn(8, 4, device=dev)
    with pytest.raises(TypeError):
        bn.stats_cuda(x.to(torch.int32), 1)
    with pytest.raises(TypeError):
        bn.normalize_cuda(x, torch.zeros(9, device=dev),
                          torch.ones(4, device=dev),
                          torch.zeros(4, device=dev), 1e-5, 1, torch.int32)
    with pytest.raises(ValueError):
        bn.stats_cuda(x.cpu(), 1)
    with pytest.raises(ValueError):
        bn.normalize_cuda(x, bn.stats_cuda(x, 1), torch.ones(4),
                          torch.zeros(4), 1e-5, 1, torch.float32)


def test_bn_kernels_take_other_strides_and_running_dtypes(dev):
    """Activations of neither layout are copied to a contiguous one, a
    cotangent of another layout than x to x's, and running averages of
    another dtype than the statistics (an fp64 adapter over fp32 input)
    are updated after the launch: the same values as the plain stages."""
    from horovod_tpu_torch.train.sync_batch_norm import batch_norm_train
    base, dy, scale, bias = _bn_case(dev, (6, 12, 5, 7), False,
                                     torch.float32)
    x = base.transpose(2, 3)                  # NCWH strides: neither layout
    assert bn.kernel_input(x, 1) is not x
    dy = dy.transpose(2, 3).contiguous(memory_format=torch.channels_last)
    runs = [bn.Running(torch.zeros(12, device=dev, dtype=torch.float64),
                       torch.ones(12, device=dev, dtype=torch.float64), 0.9,
                       0.1, True) for _ in range(2)]
    xs = x.clone().requires_grad_()
    y, mean, var, n = batch_norm_train(xs, scale, bias, (), 1e-5, 1,
                                       torch.float32, runs[0])
    y.backward(dy)
    st = bn.plain_stats(x, 1)
    y_ref, m_ref, v_ref, r_ref = bn.plain_normalize(x, st, scale, bias, 1e-5,
                                                    1, torch.float32)
    bn.plain_update_running(runs[1], m_ref, v_ref, st[24])
    sums = bn.plain_grad_sums(x, dy, m_ref, r_ref, 1)
    dx_ref = bn.plain_grad_input(x, dy, m_ref, r_ref, scale, sums, st[24], 1)
    torch.cuda.synchronize()
    for a, b in ((y, y_ref), (xs.grad, dx_ref), (runs[0].mean, runs[1].mean),
                 (runs[0].var, runs[1].var)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("recomputing", [False, True])
def test_zoo_bn_layer_runs_the_kernels_and_its_running_averages(dev,
                                                                 recomputing):
    """The zoo's layer on the card: two launches forward, two backward; the
    running averages updated by the forward's second kernel as the plain
    update would, and left alone while the block is recomputed."""
    from horovod_tpu_torch.models._flax import BatchNorm
    x, dy, _, _ = _bn_case(dev, (8, 32, 14, 14), True, BF)
    m = BatchNorm(32, dtype=BF, device=dev)
    m.recomputing = recomputing
    mean0, var0 = m.mean.clone(), m.var.clone()
    before = bn.launch_kernel.launches
    xs = x.clone().requires_grad_()
    m(xs).backward(dy)
    torch.cuda.synchronize()
    assert bn.launch_kernel.launches == before + 4
    if recomputing:
        assert torch.equal(m.mean, mean0) and torch.equal(m.var, var0)
        return
    st = bn.stats_cuda(x, 1).float()
    want = bn.Running(mean0, var0, 0.9, 1 - 0.9, False)
    _, mean, var, _ = bn.plain_normalize(x, st, m.scale.detach(),
                                         m.bias.detach(), 1e-5, 1, BF)
    bn.plain_update_running(want, mean, var, st[64])
    assert torch.equal(m.mean, want.mean) and torch.equal(m.var, want.var)


@pytest.mark.parametrize("xdt,ydt", [(torch.float32, BF), (BF, torch.float32),
                                     (torch.float16, BF),
                                     (torch.float64, torch.float32)])
def test_bn_layer_takes_x_and_y_of_two_dtypes(dev, xdt, ydt):
    """The zoo layer with an output dtype other than its input's (flax's
    ``nn.BatchNorm(dtype=...)``) runs the four kernels, in the statistics'
    dtype, and gives y and dx in their dtypes with the bits of the plain
    stages fed its kernels' sums."""
    from horovod_tpu_torch.models._flax import BatchNorm
    x, dy, scale, bias = _bn_case(dev, (8, 24, 9, 7), True, xdt)
    m = BatchNorm(24, dtype=ydt, device=dev)
    with torch.no_grad():
        m.scale.copy_(scale)
        m.bias.copy_(bias)
    before = bn.launch_kernel.launches
    xs = x.clone().requires_grad_()
    y = m(xs)
    y.backward(dy.to(ydt))
    torch.cuda.synchronize()
    assert bn.launch_kernel.launches == before + 4
    acc = bn.stat_dtype(x)
    st = bn.stats_cuda(x, 1)
    y_ref, mean, _, rstd = bn.plain_normalize(x, st, m.scale.detach(),
                                              m.bias.detach(), 1e-5, 1, ydt)
    sums = bn.grad_sums_cuda(x, dy.to(ydt), mean, rstd, 1)
    dx_ref = bn.plain_grad_input(x, dy.to(ydt), mean, rstd,
                                 m.scale.detach(), sums, st[48], 1)
    assert y.dtype == ydt and xs.grad.dtype == xdt and mean.dtype == acc
    assert torch.equal(y, y_ref) and torch.equal(xs.grad, dx_ref)


def test_resnet50_step_launches_four_bn_kernels_a_layer(dev):
    """One ResNet-50 training step on the card (bf16, batch 2 at 64x64):
    every one of its 53 batch norms runs two kernels forward and two
    backward, and nothing else launches them."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models._flax import BatchNorm, init_state
    m = resnet.ResNet50(10, device=dev)
    init_state(m, 0)
    assert sum(isinstance(b, BatchNorm) for b in m.modules()) == 53
    opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand(2, 3, 64, 64, generator=g, device=dev)
    y = torch.randint(0, 10, (2,), generator=g, device=dev)
    step = resnet.make_resnet_train_step(m)
    before = bn.launch_kernel.launches
    _, _, loss = step(m, opt, x, y)
    torch.cuda.synchronize()
    assert bn.launch_kernel.launches - before == 4 * 53
    assert torch.isfinite(loss)


SBN_ROWS, SBN_C = 4, 32      # a rank's images, channels


def _sbn_batch():
    rng = np.random.RandomState(7)
    x = (rng.randn(2 * SBN_ROWS, SBN_C, 6, 5) * 1.3 + 0.2).astype(np.float32)
    w = rng.randn(2 * SBN_ROWS, SBN_C, 6, 5).astype(np.float32)
    return x, w, np.linspace(0.5, 1.5, SBN_C, dtype=np.float32), \
        np.linspace(-1, 1, SBN_C, dtype=np.float32)


def _sbn_run(d, x, w, scale, bias, axes=()):
    from horovod_tpu_torch.models._flax import BatchNorm
    m = BatchNorm(SBN_C, dtype=torch.float32, axes=axes, device=d)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    xs = torch.from_numpy(x).to(d).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    before = bn.launch_kernel.launches
    y = m(xs)
    (y * torch.from_numpy(w).to(d)).sum().backward()
    torch.cuda.synchronize()
    return {"y": y.detach().cpu().numpy(), "dx": xs.grad.cpu().numpy(),
            "dscale": m.scale.grad.cpu().numpy(),
            "dbias": m.bias.grad.cpu().numpy(), "mean": m.mean.cpu().numpy(),
            "var": m.var.cpu().numpy(),
            "launches": np.array(bn.launch_kernel.launches - before)}


def _w_sbn_nccl():
    """One rank of the zoo's sync-BN over NCCL on two cards: its block of
    the batch through the kernels, the moments all-reduced between them."""
    import horovod_tpu_torch as hvd
    mesh = hvd.build_mesh(dp=2)
    r = hvd.rank()
    x, w, scale, bias = _sbn_batch()
    blk = slice(r * SBN_ROWS, (r + 1) * SBN_ROWS)
    return _sbn_run(hvd.device(), x[blk], w[blk], scale, bias,
                    [mesh.axis("dp")])


def test_sync_batch_norm_kernels_over_nccl_two_cards(dev, tmp_path):
    """Two cards, one NCCL rank each: y, dx and the running averages equal
    one process's over the concatenated batch, and the ranks' scale and
    bias gradients sum to its."""
    from torch_port_worker import spawn_world
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ranks = spawn_world(__file__, "sbn_nccl", 2, tmp_path,
                        {"HOROVOD_TPU_OPERATIONS": "NCCL"}, timeout=300)
    one = _sbn_run(dev, *_sbn_batch())
    assert int(one["launches"]) == 4
    for r, res in enumerate(ranks):
        blk = slice(r * SBN_ROWS, (r + 1) * SBN_ROWS)
        assert int(res["launches"]) == 4
        np.testing.assert_allclose(res["y"], one["y"][blk], atol=1e-5)
        np.testing.assert_allclose(res["dx"], one["dx"][blk], atol=1e-5)
        np.testing.assert_allclose(res["mean"], one["mean"], atol=1e-6)
        np.testing.assert_allclose(res["var"], one["var"], rtol=1e-5)
    for k in ("dscale", "dbias"):
        np.testing.assert_allclose(ranks[0][k] + ranks[1][k], one[k],
                                   rtol=1e-4, atol=1e-3)


def test_resnet_step_on_nccl_world_of_one_matches_cpu(nccl_mesh):
    """``make_resnet_train_step`` on the dp mesh of an NCCL world of one
    (its gradient sync runs) against the same step on the CPU without a
    mesh, in fp64 (as the CPU tests against JAX: in fp32 a ReLU input
    within rounding of zero may land on either side): loss, parameters
    and BN statistics."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models._flax import init_state
    g = torch.Generator().manual_seed(4)
    x = torch.rand(8, 3, 64, 64, generator=g, dtype=torch.float64)
    y = torch.randint(0, 10, (8,), generator=g)
    init = init_state(resnet.ResNet([1, 1, 1, 1], 10, device="cpu"),
                      0).state_dict()
    res = {}
    for d, mesh in (("cpu", None), ("cuda", nccl_mesh)):
        m = resnet.ResNet([1, 1, 1, 1], 10, torch.float64, device=d,
                          mesh=mesh)
        m.load_state_dict(init)
        m.double()
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        _, _, loss = resnet.make_resnet_train_step(m, mesh)(
            m, opt, x.to(d), y.to(d))
        res[d] = (float(loss), {k: v.cpu() for k, v in m.state_dict().items()})
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-6)
    for k, v in res["cpu"][1].items():
        assert float((res["cuda"][1][k] - v).abs().max()) <= \
            1e-6 * max(1.0, float(v.abs().max())), k

# -- the launcher and elastic training on the card ------------------------------

def test_elastic_recover_on_the_card_at_small_depth(dev, tmp_path):
    """chip_smoke's [elastic_recover] at depth 1: three gloo ranks of the
    flagship on cuda:0 under the port's driver; rank 2 dies after its
    commit of step 2, one replacement boots, the survivors keep their
    PIDs and book the six re-mesh phases, the replicas end equal, and
    both kernels ran on every rank."""
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.hosts import HostInfo
    _build.build_all()
    out = str(tmp_path)
    cmd = worker.command(out, "--device", "cuda:0", "--layers", 1,
                         "--steps", 4, "--rows", 2, "--kill", "2:2")
    rc, _, _ = worker.run_driver(FixedHosts([HostInfo("localhost", 3)]),
                                 cmd, out, reset_limit=3, timeout=240,
                                 env={"HVD_TPU_GLOO_TIMEOUT_SECONDS": "60"})
    evs = worker.events(out)
    assert rc == 0, evs
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = [e for e in evs if e["kind"] == "done"]
    assert sorted(b["rank"] for b in boots) == [0, 1, 2, 2]
    pid = {b["rank"]: b["pid"] for b in boots if b["rank"] < 2}
    phases = {"failure_detect", "drain", "rendezvous", "rebuild", "restore",
              "first_step"}
    for d in dones:
        assert d["size"] == 3 and d["step"] == 4
        assert d["launches"]["flash_attention_fwd"] > 0
        assert d["launches"]["xent_fwd"] > 0
        if d["rank"] < 2:
            assert d["pid"] == pid[d["rank"]]
            assert set(d["remesh"]["phases"]) >= phases
    assert len({d["digest"] for d in dones}) == 1


def _w_nccl_peer_dies():
    """Rank 1 leaves after one allreduce; rank 0 waits until it is gone,
    then times its shutdown (``HVD_TEST_FORCE``: forced, or negotiated
    with a short grace)."""
    import time

    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    out = os.environ["TEST_OUT"]
    t = torch.ones(4, device=hvd.device())
    dist.all_reduce(t)
    torch.cuda.synchronize()
    if hvd.rank() == 1:
        np.savez(os.path.join(out, "nccl_peer_dies.rank1.npz"),
                 ok=np.array(1))
        os._exit(0)
    while not os.path.exists(os.path.join(out, "nccl_peer_dies.rank1.npz")):
        time.sleep(0.05)
    time.sleep(1.0)
    t0 = time.monotonic()
    hvd.shutdown(force=os.environ["HVD_TEST_FORCE"] == "1")
    np.savez(os.path.join(out, "nccl_peer_dies.rank0.npz"),
             shutdown_s=np.array(time.monotonic() - t0),
             initialized=np.array(dist.is_initialized()))
    os._exit(0)


@pytest.mark.parametrize("force", [True, False])
def test_nccl_shutdown_returns_when_its_peer_was_killed(tmp_path, force):
    """Two cards, one NCCL rank each: after rank 1 dies, rank 0's
    shutdown aborts the communicator instead of hanging in
    ``destroy_process_group`` (forced at once; negotiated after the
    barrier's grace)."""
    from torch_port_worker import spawn_world
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ranks = spawn_world(__file__, "nccl_peer_dies", 2, tmp_path,
                        {"HOROVOD_TPU_OPERATIONS": "NCCL",
                         "TEST_OUT": str(tmp_path),
                         "HVD_TEST_FORCE": "1" if force else "0",
                         "HVD_TPU_SHUTDOWN_GRACE_S": "3"}, timeout=120)
    assert not bool(ranks[0]["initialized"])
    assert float(ranks[0]["shutdown_s"]) < (5.0 if force else 10.0)


if __name__ == "__main__":
    import sys
    from torch_port_worker import worker_main
    sys.exit(worker_main({"ring": _w_ring, "pp_nccl": _w_pp_nccl,
                          "nccl_peer_dies": _w_nccl_peer_dies,
                          "eager_nccl": _w_eager_nccl,
                          "sbn_nccl": _w_sbn_nccl},
                         sys.argv[1:]))


# -- the serving engine: one CUDA graph capture per step function --------------
GEN_TIE_REL = 1e-4   # a near tie: top-two logit margin under this x max|logit|


def _gen_done(engine, reqs):
    from horovod_tpu_torch.serving.generate.scheduler import DONE
    n = 0
    while any(r.state != DONE for r in reqs):
        engine.step_once()
        n += 1
        assert n < 100_000


def _churned(engine, n_reqs, seed, vocab, steps):
    """Submit ``n_reqs`` mixed requests and step until some have finished,
    some decode and some wait or prefill: a churned slot state."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n_reqs):
        plen = int(rng.randint(1, 40))
        reqs.append(engine.submit(f"c{i}", rng.randint(0, vocab, plen),
                                  int(rng.randint(1, 12))))
    for _ in range(steps):
        engine.step_once()
    return reqs


def test_gen_step_functions_capture_once_under_churn(dev):
    """Sequences joining and leaving every few steps change only buffer
    contents: each step function is captured exactly once, and every
    stream equals the card's oracle up to its first near tie."""
    from horovod_tpu_torch.models import reference_greedy_decode
    from horovod_tpu_torch.profiling import compile_watch
    from horovod_tpu_torch.serving.generate import (GenerateEngine,
                                                    demo_gen_setup)
    params, cfg = demo_gen_setup(d_model=64, n_heads=4, vocab=256,
                                 max_seq=128, device=dev)
    compile_watch.reset_counts()
    eng = GenerateEngine(params, cfg, n_slots=3, page_bytes=4096,
                         prefill_chunk=8, device=dev)
    reqs = _churned(eng, 12, 0, cfg.vocab_size, 0)
    _gen_done(eng, reqs)
    counts = compile_watch.per_function_compiles()
    assert counts.get("gen_decode_step") == 1, counts
    assert counts.get("gen_prefill_chunk") == 1, counts
    assert eng.captures == {"gen_decode_step": 1, "gen_prefill_chunk": 1}
    for r in reqs[:4]:
        ref, margins = reference_greedy_decode(
            params, cfg, r.prompt, r.max_new, return_margins=True)
        tie = next((i for i, (m, mx) in enumerate(margins)
                    if m < GEN_TIE_REL * mx), len(ref))
        assert r.tokens[:tie] == ref[:tie], (r.id, tie)


def test_replayed_decode_step_equals_eager_bit_for_bit(dev):
    """On a churned slot state the graph replay gives the eager step's
    tokens and pools to the bit (the scratch page aside: masked lanes
    write it in no fixed order)."""
    from horovod_tpu_torch.serving.generate import (GenerateEngine,
                                                    demo_gen_setup)
    params, cfg = demo_gen_setup(d_model=64, n_heads=4, vocab=256,
                                 max_seq=128, device=dev)
    eng = GenerateEngine(params, cfg, n_slots=4, page_bytes=4096,
                         prefill_chunk=8, device=dev)
    reqs = _churned(eng, 10, 1, cfg.vocab_size, 14)
    assert 0 < len(eng.scheduler.decoding()) and any(
        r.state == "done" for r in reqs)
    k0, v0 = eng._k_pages.clone(), eng._v_pages.clone()
    replayed = eng.decode_step_now()
    k1, v1 = eng._k_pages.clone(), eng._v_pages.clone()
    eng._k_pages.copy_(k0)
    eng._v_pages.copy_(v0)
    eager = eng.decode_step_now(eager=True)
    np.testing.assert_array_equal(replayed, eager)
    assert torch.equal(k1[:, :-1], eng._k_pages[:, :-1])
    assert torch.equal(v1[:, :-1], eng._v_pages[:, :-1])
    assert not torch.equal(k1[:, :-1], k0[:, :-1])   # the step wrote K
    _gen_done(eng, reqs)


def test_flagship_engine_matches_card_oracle(dev):
    """The flagship at full width (fp32, 8 slots): continuous tokens
    equal the card's ``reference_greedy_decode`` up to the first near
    tie, and a lone rerun of each request equals its continuous run."""
    from horovod_tpu_torch.models import reference_greedy_decode
    from horovod_tpu_torch.serving.generate import (GenerateEngine,
                                                    flagship_gen_setup)
    params, cfg = flagship_gen_setup(device=dev)
    eng = GenerateEngine(params, cfg, n_slots=8, prefill_chunk=32,
                         device=dev)
    assert (eng.plan.page_tokens, eng.plan.pages_per_slot) == (4, 64)
    rng = np.random.RandomState(2)
    jobs = [(rng.randint(0, cfg.vocab_size, int(rng.randint(8, 120))),
             int(rng.randint(8, 24))) for _ in range(6)]
    reqs = [eng.submit(f"f{i}", p, m) for i, (p, m) in enumerate(jobs)]
    _gen_done(eng, reqs)
    for i, r in enumerate(reqs[:4]):
        ref, margins = reference_greedy_decode(
            params, cfg, r.prompt, r.max_new, return_margins=True)
        tie = next((j for j, (m, mx) in enumerate(margins)
                    if m < GEN_TIE_REL * mx), len(ref))
        assert r.tokens[:tie] == ref[:tie], (i, tie)
        lone = eng.submit(f"l{i}", r.prompt, r.max_new)
        _gen_done(eng, [lone])
        assert lone.tokens == r.tokens


def test_exporter_serves_metrics_during_a_card_training_run(dev,
                                                            monkeypatch):
    """``init`` on an NCCL world of one starts the exporter; a scraper
    thread reads ``/metrics`` while flagship steps (one layer) run on the
    card, a scrape between steps counts each step, and the last scrape
    counts every step."""
    import dataclasses
    import threading
    import time
    import urllib.request

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import _state
    from horovod_tpu_torch.diagnostics import watchdog
    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.metrics.__main__ import parse_prometheus
    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          make_train_step)
    from torch_port_worker import reserve_ports
    port, held = reserve_ports(1)
    monkeypatch.setenv("HVD_TPU_METRICS_PORT", str(port))
    monkeypatch.setenv("HVD_TPU_WATCHDOG_SECONDS", "60")
    default_registry().clear()
    watchdog.reset()
    hvd.shutdown()
    hvd.init()
    held[0].close()
    scrapes, stop = [], threading.Event()

    def scrape():
        while not stop.wait(0.05):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                scrapes.append(parse_prometheus(r.read().decode()))

    try:
        assert _state.metrics_exporter.port == port
        cfg = dataclasses.replace(_flagship_cfg(), n_layers=1)
        model = Transformer(cfg)
        opt = init_opt_state(adamw, model)
        step = make_train_step(cfg)
        g = torch.Generator().manual_seed(0)
        tok = torch.randint(0, cfg.vocab_size, (2, 256), generator=g).to(dev)
        tgt = torch.randint(0, cfg.vocab_size, (2, 256), generator=g).to(dev)
        cb = hvd.TelemetryCallback(units_per_step=tok.numel(),
                                   unit="tokens")
        assert cb.watchdog is not None and cb.watchdog.armed
        before = attention.flash_attn_fwd_cuda.launches
        t = threading.Thread(target=scrape, daemon=True)
        t.start()
        seen = []
        for i in range(6):
            cb.on_step_begin()
            float(step(model, opt, tok, tgt)[2])
            cb.on_step_end()
            # the scraper, not the step, sets the pace: wait for a scrape
            # that counts this step before taking the next one
            deadline = time.monotonic() + 10
            while (not scrapes or scrapes[-1].get("hvd_steps_total") != i + 1
                   ) and time.monotonic() < deadline:
                time.sleep(0.01)
            seen.append(scrapes[-1].get("hvd_steps_total") if scrapes
                        else None)
        stop.set()
        t.join(timeout=10)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            last = parse_prometheus(r.read().decode())
        assert attention.flash_attn_fwd_cuda.launches - before == 6
        assert seen == [1, 2, 3, 4, 5, 6]
        assert last["hvd_steps_total"] == 6
        assert last["hvd_step_time_seconds_count"] == 6
        assert cb.watchdog.trigger_count == 0
        cb.on_train_end()
    finally:
        stop.set()
        hvd.shutdown()
        watchdog.reset()


def test_watchdog_fires_while_blocked_in_cuda_synchronize(dev, tmp_path):
    """The main thread waits in ``torch.cuda.synchronize()`` behind a
    ``torch.cuda._sleep`` spin of about 3 s: the watchdog (0.5 s) fires
    once and writes its bundle, and ``/debug/stacks`` answers from the
    exporter's thread meanwhile, naming the blocked frame."""
    import json
    import threading
    import time
    import urllib.request

    from horovod_tpu_torch.diagnostics.watchdog import Watchdog
    from horovod_tpu_torch.metrics.exporter import MetricsExporter
    from horovod_tpu_torch.metrics.registry import Registry
    exp = MetricsExporter(registry=Registry(), port=0)
    exp.start()
    wd = Watchdog(timeout_s=0.5, autopsy_dir=str(tmp_path / "bundle"),
                  check_interval_s=0.1)
    got = {}

    def fetch():
        time.sleep(1.5)
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exp.port}/debug/stacks",
                timeout=10) as r:
            got["stacks"] = r.read().decode()
        got["seconds"] = time.perf_counter() - t0
        got["at"] = time.perf_counter()

    try:
        torch.cuda.synchronize()
        wd.start()
        t = threading.Thread(target=fetch, daemon=True)
        t.start()
        # ~1 s a call at the card's clock (H100: about 1.7-2 GHz)
        for _ in range(3):
            torch.cuda._sleep(2_000_000_000)
        torch.cuda.synchronize()
        done = time.perf_counter()
        t.join(timeout=10)
        wd.stop()
        assert got["at"] < done, "stacks answered only after the sync"
        assert "test_watchdog_fires_while_blocked_in_cuda_synchronize" in \
            got["stacks"]
        assert wd.trigger_count == 1
        bundle = tmp_path / "bundle"
        files = set(os.listdir(bundle))
        assert {"stacks_rank0.txt", "flight_rank0.json",
                "summary_rank0.json"} <= files
        with open(bundle / "flight_rank0.json") as f:
            kinds = [e["kind"] for e in json.load(f)["events"]]
        assert "watchdog_trigger" in kinds
    finally:
        wd.stop()
        exp.stop()


def test_transformer_example_runs_its_kernels_on_the_card(dev):
    """``horovod_tpu_torch/examples/native/transformer_5d_parallel.py``, as
    a user runs it on the card (a world of one, bf16): its ten ``step <i>:
    loss`` lines with the loss falling, every layer's attention through
    ``flash_attn_fwd`` and every step's loss through ``xent_fwd``."""
    import re
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "horovod_tpu_torch", "examples", "native",
                          "transformer_5d_parallel.py")
    code = ("import runpy, sys\n"
            "from horovod_tpu_torch.ops import attention, xent\n"
            f"sys.argv = [{script!r}]\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n"
            "print('launches', attention.flash_attn_fwd_cuda.launches,\n"
            "      xent.xent_fwd_cuda.launches)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    losses = [float(x) for x in
              re.findall(r"^step \d+: loss (\S+) aux", r.stdout, re.M)]
    assert len(losses) == 10 and losses[-1] < losses[0], losses
    flash, xent_n = map(int, re.search(r"^launches (\d+) (\d+)$", r.stdout,
                                       re.M).groups())
    assert flash >= 4 * 10 and xent_n >= 10, (flash, xent_n)
