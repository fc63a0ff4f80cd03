"""Port fused softmax-xent vs the JAX package's Pallas kernel in interpret
mode: loss (including a vocab that is not a multiple of the kernel's 512
block and out-of-range labels), gradients and bf16 logits. The tolerances
are those of tests/test_pallas_xent.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from horovod_tpu.ops.pallas_xent import _xla_xent
from horovod_tpu.ops.pallas_xent import fused_softmax_xent as jax_xent

from horovod_tpu_torch.ops import xent as txent


def _case(n=256, v=1024, seed=0, out_of_range=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, v) * 2.0).astype(np.float32)
    labels = rng.randint(0, v, (n,)).astype(np.int32)
    if out_of_range:
        # past the Pallas wrapper's NEG_INF padding too: a label in
        # [V, V padded to 512) picks a pad column there (loss ~ 1e30)
        labels[::7] = -1
        labels[3::11] = v + 4096
    return logits, labels


@pytest.mark.parametrize("v,oor", [(1024, False), (1000, False),
                                   (1000, True), (512, True)])
def test_loss_matches_pallas_kernel(v, oor):
    logits, labels = _case(v=v, out_of_range=oor)
    ref = jax_xent(jnp.asarray(logits), jnp.asarray(labels), interpret=True)
    out = txent.fused_softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_out_of_range_label_gives_lse_as_xla_xent():
    logits, labels = _case(n=8, v=100)
    labels[:4] = [-1, 100, 1000, -5]
    loss, lse = txent.plain_xent(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    np.testing.assert_array_equal(loss[:4].numpy(), lse[:4].numpy())
    ref = _xla_xent(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("v,oor", [(1024, False), (1000, True)])
def test_grads_match_pallas_kernel(v, oor):
    logits, labels = _case(n=128, v=v, out_of_range=oor)
    rng = np.random.RandomState(5)
    w = rng.randn(128).astype(np.float32)

    def f(lg):
        return jnp.sum(jax_xent(lg, jnp.asarray(labels), interpret=True) * w)

    g_ref = jax.grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    (txent.fused_softmax_xent(lt, torch.from_numpy(labels))
     * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(lt.grad).all()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-6)


def test_leading_shape_and_bf16():
    logits, labels = _case(n=256, v=512)
    ref = jax_xent(jnp.asarray(logits, jnp.bfloat16).reshape(2, 128, 512),
                   jnp.asarray(labels).reshape(2, 128), interpret=True)
    lt = torch.from_numpy(logits).to(torch.bfloat16).reshape(2, 128, 512)
    out = txent.fused_softmax_xent(lt, torch.from_numpy(labels).reshape(2, 128))
    assert out.shape == (2, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-2,
                               atol=2e-2)


def test_bf16_grad_keeps_logits_dtype():
    logits, labels = _case(n=16, v=300)
    lt = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    txent.fused_softmax_xent(lt, torch.from_numpy(labels)).mean().backward()
    assert lt.grad.dtype == torch.bfloat16
