"""Adasum in the port against the JAX package's, on the CPU: the pairwise
combine and the binary tree against ``horovod_tpu.ops.adasum`` (rtol
1e-5), the core's VHDD Adasum op in worlds of 2 and 3 against the tree
oracle of ``adasum_worker.py`` (rtol 1e-4, atol 1e-5, as there; 1e-5 for
the identical and orthogonal cases, checked in the worker), and
``DistributedOptimizer(op=Adasum)`` in the eager and the axis regimes
against the JAX tree over every rank's gradients (rtol 1e-5)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import adasum as jad
from horovod_tpu_torch.ops import adasum as tad

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import REPO, build_core, spawn_world  # noqa: E402

EAGER_WORKER = os.path.join(REPO, "tests", "torch_port_eager_worker.py")


@pytest.fixture(scope="module", autouse=True)
def _core_built():
    """The core is built before any world starts (a cold build under load
    must not eat a world's timeout)."""
    build_core()


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 2, 9)])
def test_combine_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    a = rng.randn(*shape).astype(np.float32)
    b = (rng.randn(*shape) + 0.5 * a).astype(np.float32)
    out = tad.adasum_combine(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(jad.adasum_combine(jnp.asarray(a), jnp.asarray(b)))
    assert out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_combine_keeps_a_zero_partner_exact():
    """``combine(a, 0) == a`` and ``combine(0, 0) == 0`` (the zero-norm
    guard), which makes zero padding of the tree exact."""
    a = torch.from_numpy(np.random.RandomState(0).randn(9).astype(np.float32))
    assert torch.equal(tad.adasum_combine(a, torch.zeros(9)), a)
    assert torch.equal(tad.adasum_combine(torch.zeros(9), torch.zeros(9)),
                       torch.zeros(9))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_tree_reduce_matches_jax(n):
    rng = np.random.RandomState(n)
    stacked = rng.randn(n, 4, 6).astype(np.float32)
    out = tad.adasum_tree_reduce(torch.from_numpy(stacked))
    ref = np.asarray(jad.adasum_tree_reduce(jnp.asarray(stacked)))
    assert out.shape == (4, 6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def _vhdd_oracle(contribs: np.ndarray) -> np.ndarray:
    """``adasum_worker.vhdd_oracle``: fold the ranks past a power of two
    onto their partners, then the binary tree (the JAX functions)."""
    p = len(contribs)
    pow2 = 1
    while pow2 * 2 <= p:
        pow2 *= 2
    folded = []
    for i in range(pow2):
        c = jnp.asarray(contribs[i])
        if i < p - pow2:
            c = jad.adasum_combine(c, jnp.asarray(contribs[i + pow2]))
        folded.append(c)
    return np.asarray(jad.adasum_tree_reduce(jnp.stack(folded)))


@pytest.mark.parametrize("n", [2, 3])
def test_adasum_over_the_core_and_the_optimizer(tmp_path, n):
    res = spawn_world(EAGER_WORKER, "adasum", n, tmp_path, timeout=90)
    contribs, grads = res[0]["contribs"], res[0]["grads"]
    oracle = _vhdd_oracle(contribs)
    tree = np.stack([np.asarray(jad.adasum_tree_reduce(
        jnp.asarray(grads[:, leaf]))) for leaf in range(2)])
    for r in range(n):
        np.testing.assert_allclose(res[r]["rand"], oracle, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res[r]["f64"], oracle, rtol=1e-4,
                                   atol=1e-5)
        for regime in ("eager", "axis"):
            # SGD(lr=1) from zeros: the parameters are minus the update
            np.testing.assert_allclose(-res[r][f"opt_{regime}"], tree,
                                       rtol=1e-5, atol=1e-6, err_msg=regime)


def test_adasum_refusals_and_a_world_of_one(monkeypatch):
    """Adasum takes no compression and no fused apply (as the JAX
    package refuses both); in a world of one it is the identity, on the
    eager path and along a mesh axis of size 1."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.mesh_collectives import preduce
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="compression"):
        hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0), op=hvd.Adasum,
                                 compression=hvd.Compression.fp16)
    with pytest.raises(ValueError, match="Adasum"):
        hvd.DistributedOptimizer(hvd.fused_sgd(1.0), [("p", p)],
                                 op=hvd.Adasum)
    hvd.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    hvd.init()
    try:
        x = torch.arange(4.0)
        assert torch.equal(hvd.allreduce(x, op=hvd.Adasum), x)
        axis = hvd.build_mesh(dp=1).axis("dp")
        assert torch.equal(preduce(x, axis, hvd.Adasum), x)
        opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                       op=hvd.Adasum)
        p.grad = torch.ones(3)
        opt.step()
        assert torch.equal(p.detach(), -torch.ones(3))
    finally:
        hvd.shutdown()
