"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc and skip without one. They import
nothing of JAX, so on a machine without it they run with the repository's
conftest left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import pytest
import torch

from horovod_tpu_torch.ops import attention, xent

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


@pytest.mark.parametrize("S,D,dtype,causal,tol", [
    (256, 64, torch.float32, True, 1e-4),
    (130, 64, torch.float32, False, 1e-4),
    (77, 128, torch.float32, True, 1e-4),
    (256, 128, torch.bfloat16, False, 2e-2),
    (1, 64, torch.bfloat16, True, 2e-2),
])
def test_flash_kernel_matches_plain(dev, S, D, dtype, causal, tol):
    q, k, v = (_rand(dev, 2, S, 3, D, dtype=dtype, seed=i) for i in range(3))
    before = attention.flash_attn_fwd_cuda.launches
    o, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
    assert attention.flash_attn_fwd_cuda.launches == before + 1
    o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.shape == (2 * 3, S)
    assert float((o.float() - o_ref.float()).abs().max()) <= tol
    assert float((lse - lse_ref).abs().max()) <= tol


def test_flash_kernel_reads_strided_inputs(dev):
    """q/k/v as views of a fused [B, S, 3, H, D] projection: no copy."""
    qkv = _rand(dev, 2, 96, 3, 4, 64)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = attention.flash_attention_with_lse(q, k, v, causal=True)
    o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, True)
    assert float((o - o_ref).abs().max()) <= 1e-4
    assert float((lse - lse_ref).abs().max()) <= 1e-4


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
