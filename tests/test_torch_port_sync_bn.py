"""The port's synchronized batch norm against the JAX package's and against
batch norm over the global batch, on the CPU.

The torch side runs as gloo worlds of 2 and 4 processes (``python
tests/test_torch_port_sync_bn.py --worker world<n> --out DIR``, importing
no JAX), each rank holding its block of a seeded global batch. The
oracles:

* value: JAX ``sync_batch_norm_spmd`` under ``shard_map`` over the same
  blocks, and numpy batch norm over the whole batch (1e-4, the JAX test's
  ``tests/test_parity_tail.py:17-36``);
* gradient: plain batch norm over the concatenated batch in one process
  (torch autograd of the textbook formula), which is what Horovod's
  ``SyncBatchNorm`` guarantees; the JAX ``shard_map`` gradient is checked
  against it before it is used as a second oracle;
* the module's running statistics: numpy over the global batch (the
  unbiased ``n/(n-1)`` running variance over the GLOBAL count) and the JAX
  ``SyncBatchNorm`` under ``shard_map``.

A size-1 axis is the identity (local batch norm), as the JAX
``_axes_live``.
"""

import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import worker_main  # noqa: E402

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import pytest
    import torch
    from jax.sharding import PartitionSpec as P

    from horovod_tpu._compat import shard_map
    from horovod_tpu.parallel.mesh import build_mesh

    from test_torch_port_dp import spawn

ROWS, C = 6, 5          # rows a rank, channels
NCHW = (3, 4, 3, 2)     # a rank's block of the zoo layer's input [N, C, H, W]
EPS = 1e-5
WORLDS = (2, 4)


def inputs(n):
    """The global batch of a world of ``n``, its scale, bias and the
    cotangent of the output."""
    rng = np.random.RandomState(n)
    x = (rng.randn(n * ROWS, C) * 2.0 + 0.5).astype(np.float32)
    scale = rng.rand(C).astype(np.float32) + 0.5
    bias = rng.randn(C).astype(np.float32)
    w = rng.randn(n * ROWS, C).astype(np.float32)
    x4 = rng.randn(n * NCHW[0], *NCHW[1:]).astype(np.float32)
    w4 = rng.randn(n * NCHW[0], *NCHW[1:]).astype(np.float32)
    return x, scale, bias, w, x4, w4


# -- the worker (torch only) ---------------------------------------------------

def _w_world(n):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models._flax import BatchNorm
    from horovod_tpu_torch.train.sync_batch_norm import (SyncBatchNorm,
                                                         sync_batch_norm_spmd)

    mesh = hvd.build_mesh(dp=n)
    dp, r = mesh.axis("dp"), mesh.axis("dp").index
    x, scale, bias, w, x4, w4 = inputs(n)
    blk = slice(r * ROWS, (r + 1) * ROWS)
    out = {}

    def leaf(a):
        return torch.tensor(a, requires_grad=True)

    xs, ss, bs = leaf(x[blk]), leaf(scale), leaf(bias)
    y = sync_batch_norm_spmd(xs, ss, bs, [dp], EPS)
    (y * torch.from_numpy(w[blk])).sum().backward()
    out.update(fn_y=y.detach().numpy(), fn_dx=xs.grad.numpy(),
               fn_dscale=ss.grad.numpy(), fn_dbias=bs.grad.numpy())

    # an absent or size-1 axis is the identity: local batch norm
    out["local_y"] = sync_batch_norm_spmd(
        torch.from_numpy(x[blk]), torch.from_numpy(scale),
        torch.from_numpy(bias), [mesh.axis("tp"), None], EPS).numpy()

    m = SyncBatchNorm(C, axes=[dp])
    m.train()
    y = m(torch.from_numpy(x[blk]))
    out.update(mod_y=y.detach().numpy(), mod_mean=m.mean.numpy().copy(),
               mod_var=m.var.numpy().copy())
    m.eval()
    out["mod_eval_y"] = m(torch.from_numpy(x[blk])).detach().numpy()

    # the zoo's layer: NCHW, biased running variance
    bn = BatchNorm(NCHW[1], axes=[dp], device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, NCHW[1]))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, NCHW[1]))
    b4 = slice(r * NCHW[0], (r + 1) * NCHW[0])
    x4s = leaf(x4[b4])
    y4 = bn(x4s)
    (y4 * torch.from_numpy(w4[b4])).sum().backward()
    out.update(zoo_y=y4.detach().numpy(), zoo_dx=x4s.grad.numpy(),
               zoo_dscale=bn.scale.grad.numpy(),
               zoo_dbias=bn.bias.grad.numpy(),
               zoo_mean=bn.mean.numpy().copy(), zoo_var=bn.var.numpy().copy())
    return out


if __name__ == "__main__":
    sys.exit(worker_main({f"world{n}": functools.partial(_w_world, n)
                          for n in WORLDS}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: spawn(f"world{n}", n, tmp_path_factory.mktemp(f"sbn{n}"),
                     script=__file__) for n in WORLDS}


def _np_bn(x, scale, bias, axes):
    mean = x.mean(axes, keepdims=True)
    var = x.var(axes, keepdims=True)
    return (x - mean) / np.sqrt(var + EPS) * scale + bias


def _plain_bn_grads(x, scale, bias, w, axes, shape):
    """One process, the whole batch: the textbook formula, autograd."""
    xt, st, bt = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (x, scale, bias))
    mean = xt.mean(axes, keepdim=True)
    var = ((xt - mean) ** 2).mean(axes, keepdim=True)
    y = (xt - mean) / torch.sqrt(var + EPS) * st.view(shape) + bt.view(shape)
    (y * torch.from_numpy(w).double()).sum().backward()
    return xt.grad.numpy(), st.grad.numpy(), bt.grad.numpy()


def _jax_spmd(n, x, scale, bias, w):
    """JAX ``sync_batch_norm_spmd`` under shard_map over dp=n: the output
    and the gradient of ``sum(y * w)`` (the sum outside the map)."""
    from horovod_tpu.train.sync_batch_norm import sync_batch_norm_spmd
    mesh = build_mesh(dp=n, devices=jax.devices()[:n])

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("dp"), P(), P()),
                       out_specs=P("dp"))
    def synced(xl, s, b):
        return sync_batch_norm_spmd(xl, s, b, axis_names=("dp",), eps=EPS)

    def loss(xx, s, b):
        return jnp.sum(synced(xx, s, b) * w)

    y = jax.jit(synced)(x, scale, bias)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, scale, bias)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _gather(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("n", WORLDS)
def test_functional_matches_jax_and_global_numpy(worlds, n):
    x, scale, bias, w, _, _ = inputs(n)
    y = _gather(worlds[n], "fn_y")
    jy, _ = _jax_spmd(n, x, scale, bias, w)
    np.testing.assert_allclose(y, _np_bn(x, scale, bias, 0), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(y, jy, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_functional_gradient_is_the_global_batch_norm_gradient(worlds, n):
    """dx of every rank concatenated, and the scale's and bias's gradients
    summed over the ranks (the train step's gradient sync), equal plain
    batch norm's over the concatenated batch; the JAX shard_map gradient
    equals it too, so it is a second oracle."""
    x, scale, bias, w, _, _ = inputs(n)
    dx, ds, db = _plain_bn_grads(x, scale, bias, w, 0, (1, C))
    ranks = worlds[n]
    got = (_gather(ranks, "fn_dx"), sum(r["fn_dscale"] for r in ranks),
           sum(r["fn_dbias"] for r in ranks))
    _, jgrads = _jax_spmd(n, x, scale, bias, w)
    for name, want, g, jg in zip(("dx", "dscale", "dbias"), (dx, ds, db),
                                 got, jgrads):
        np.testing.assert_allclose(jg, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"JAX {name}")
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_size_one_axis_is_the_identity(worlds, n):
    x, scale, bias, _, _, _ = inputs(n)
    for r, res in enumerate(worlds[n]):
        blk = x[r * ROWS:(r + 1) * ROWS]
        np.testing.assert_allclose(res["local_y"], _np_bn(blk, scale, bias, 0),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_module_matches_jax_module_and_global_numpy(worlds, n):
    """The module in training mode: output and running statistics (momentum
    0.9 as decay, the unbiased variance over the GLOBAL count), against
    numpy and against the JAX ``SyncBatchNorm`` under shard_map; then its
    eval output from those statistics."""
    from horovod_tpu.train.sync_batch_norm import SyncBatchNorm as JSBN
    x, _, _, _, _, _ = inputs(n)
    N = x.shape[0]
    mean = 0.1 * x.mean(0)
    var = 0.9 + 0.1 * x.var(0) * N / (N - 1)
    m = JSBN(axis_names=("dp",))
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x[:ROWS]))
    mesh = build_mesh(dp=n, devices=jax.devices()[:n])

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("dp"),),
                       out_specs=(P("dp"), P()), check_vma=False)
    def apply(xl):
        y, mut = m.apply(variables, xl, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    jy, jstats = jax.jit(apply)(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(jstats["mean"]), mean, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jstats["var"]), var, rtol=1e-5)
    np.testing.assert_allclose(_gather(worlds[n], "mod_y"), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    for r, res in enumerate(worlds[n]):
        np.testing.assert_allclose(res["mod_mean"], mean, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["mod_var"], var, rtol=1e-5)
        blk = x[r * ROWS:(r + 1) * ROWS]
        np.testing.assert_allclose(res["mod_eval_y"],
                                   (blk - mean) / np.sqrt(var + EPS),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_zoo_layer_is_global_nchw_batch_norm(worlds, n):
    """The zoo's BN layer over NCHW blocks: value, gradients (dx
    concatenated, scale/bias summed over the ranks) and the BIASED running
    variance of flax ``nn.BatchNorm``, all of the global batch."""
    _, _, _, _, x4, w4 = inputs(n)
    scale = np.linspace(0.5, 1.5, NCHW[1]).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, NCHW[1]).astype(np.float32)
    shape = (1, NCHW[1], 1, 1)
    ranks = worlds[n]
    np.testing.assert_allclose(
        _gather(ranks, "zoo_y"),
        _np_bn(x4, scale.reshape(shape), bias.reshape(shape), (0, 2, 3)),
        rtol=1e-4, atol=1e-4)
    dx, ds, db = _plain_bn_grads(x4, scale, bias, w4, (0, 2, 3), shape)
    np.testing.assert_allclose(_gather(ranks, "zoo_dx"), dx, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(sum(r["zoo_dscale"] for r in ranks), ds,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(r["zoo_dbias"] for r in ranks), db,
                               rtol=1e-4, atol=1e-4)
    for res in ranks:
        np.testing.assert_allclose(res["zoo_mean"],
                                   0.1 * x4.mean((0, 2, 3)), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["zoo_var"],
                                   0.9 + 0.1 * x4.var((0, 2, 3)), rtol=1e-5)


def test_running_var_unbiased():
    """``tests/test_parity_tail.py::test_sync_batch_norm_running_var_
    unbiased``: with momentum 0 the running variance is this batch's
    unbiased one, as the JAX module's."""
    from horovod_tpu.train.sync_batch_norm import SyncBatchNorm as JSBN
    from horovod_tpu_torch.train.sync_batch_norm import SyncBatchNorm
    x = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    m = SyncBatchNorm(4, momentum=0.0, axes=())
    m.train()
    m(torch.from_numpy(x))
    n = x.shape[0]
    np.testing.assert_allclose(m.var.numpy(), x.var(0) * n / (n - 1),
                               rtol=1e-5)
    jm = JSBN(axis_names=(), momentum=0.0)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, mut = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(m.var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5)


def test_module_normalizes_and_evaluates_like_jax():
    """``tests/test_parity_tail.py::test_sync_batch_norm_module``: one
    process, no axes: the normalized output has zero mean, and the eval
    output from the running statistics equals the JAX module's."""
    from horovod_tpu.train.sync_batch_norm import SyncBatchNorm as JSBN
    from horovod_tpu_torch.train.sync_batch_norm import SyncBatchNorm
    x = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    m = SyncBatchNorm(4, axes=())
    m.train()
    y = m(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-4)
    jm = JSBN(axis_names=())
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jy, mut = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-4, atol=1e-4)
    m.eval()
    je = jm.apply({"params": v["params"], "batch_stats": mut["batch_stats"]},
                  jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(je), rtol=1e-4, atol=1e-4)
