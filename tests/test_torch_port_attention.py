"""Port attention vs the JAX package: the plain (o, lse) against the Pallas
kernel in interpret mode, the ported blockwise backward against jax.grad
through that kernel, and ``attend`` against ``_plain_attention``. The
tolerances are those of tests/test_pallas_attention.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from horovod_tpu.ops.pallas_attention import flash_attention_with_lse
from horovod_tpu.parallel.ring_attention import _plain_attention

from horovod_tpu_torch.ops import attention as tatt


def _qkv(B=2, S=256, H=2, D=128, seed=0, Sk=None):
    rng = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    q = (rng.randn(B, S, H, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, Sk, H, D) * 0.3).astype(np.float32)
    v = (rng.randn(B, Sk, H, D) * 0.3).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
def test_plain_o_lse_match_pallas_kernel(causal):
    q, k, v = _qkv()
    o_j, lse_j = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True)
    o_t, lse_t = tatt.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert lse_t.shape == (2 * 2, 256) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_grad_with_lse_cotangent(causal):
    """Cotangents on both o and lse: the lse one enters through the row
    term adj = rowsum(do·o) − dlse."""
    q, k, v = _qkv(B=1)
    rng = np.random.RandomState(7)
    wo = rng.randn(*q.shape).astype(np.float32)
    wl = rng.randn(1 * 2, 256).astype(np.float32)

    def f_jax(q, k, v):
        o, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                          interpret=True)
        return jnp.sum(o * jnp.cos(o) * wo) + jnp.sum(lse * wl)

    g_j = jax.grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tatt.flash_attention_with_lse(qt, kt, vt, causal=causal)
    loss = (o * torch.cos(o) * torch.from_numpy(wo)).sum() + \
        (lse * torch.from_numpy(wl)).sum()
    loss.backward()
    for gt, gj, name in zip((qt.grad, kt.grad, vt.grad), g_j, "qkv"):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_backward_with_output_cotangent_only_and_rect_keys():
    """Only o used (dlse absent, as in the model), Sq != Sk, and a key count
    that is not a multiple of the backward's block."""
    q, k, v = _qkv(B=1, S=64, Sk=200, D=64, seed=3)

    def f_jax(q, k, v):
        return jnp.sum(_plain_attention(q, k, v, causal=False) ** 2)

    g_j = jax.grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tatt.flash_attention(qt, kt, vt, causal=False) ** 2).sum().backward()
    for gt, gj, name in zip((qt.grad, kt.grad, vt.grad), g_j, "qkv"):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_attend_on_cpu_matches_plain_attention(causal):
    q, k, v = _qkv(S=16, D=8)
    out = tatt.attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), causal=causal)
    ref = _plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_cpu_tensor_never_counts_a_kernel_launch():
    before = tatt.flash_attn_fwd_cuda.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(S=16, D=8))
    tatt.attend(q, k, v)
    assert tatt.flash_attn_fwd_cuda.launches == before
