"""The port's ring attention, Ulysses and MoE against the JAX package's, on
the CPU, at the JAX tests' tolerances (``tests/test_parallel_layers.py``).

The torch side is one gloo world of two processes (group ``layers``),
started as::

    python tests/test_torch_port_parallel_layers.py --worker layers --out DIR

with the launcher's identity in the environment (``spawn`` of
``tests/test_torch_port_dp.py``). The worker imports no JAX: it builds its
inputs from numpy seeds, runs every case on ``sp=2`` and ``ep=2`` meshes,
and writes ``layers.rank<r>.npz``; the JAX side runs in the pytest process.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import worker_main  # noqa: E402

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import pytest

    from horovod_tpu.parallel import build_mesh
    from horovod_tpu.parallel.moe import moe_layer
    from horovod_tpu.parallel.ring_attention import _plain_attention

    from test_torch_port_dp import spawn

N = 2


def qkv(shape, seed, scale):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(3)]


# name -> (shape, seed, scale) of q/k/v, the JAX tests' inputs
QKV = {"small": ((2, 16, 4, 8), 0, 0.5), "flash": ((1, 512, 2, 128), 3, 0.3),
       "grad": ((1, 256, 2, 128), 4, 0.3)}
E, M, HD, T = 4, 8, 16, 64


def moe_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, M).astype(np.float32)
    rw = (rng.randn(M, E) * 0.1).astype(np.float32)
    rng = np.random.RandomState(1)
    w1 = (rng.randn(E, M, HD) * 0.1).astype(np.float32)
    w2 = (rng.randn(E, HD, M) * 0.1).astype(np.float32)
    return x, rw, {"w1": w1, "w2": w2}


def moe_weights():
    return np.random.RandomState(5).randn(T, M).astype(np.float32)


# -- the worker (torch only) ---------------------------------------------------

def _w_layers():
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import moe, ring_attention, ulysses

    def t(a, grad=False):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)

    def np_(x):
        return x.detach().numpy().copy()

    out = {}
    mesh = hvd.build_mesh(sp=N)
    sp = mesh.axis("sp")

    def block(a):
        n = a.shape[1] // N
        return a[:, sp.index * n:(sp.index + 1) * n]

    for causal in (True, False):
        q, k, v = qkv(*QKV["small"])
        out[f"ring_array_{causal}"] = np_(ring_attention.ring_attention(
            t(q), t(k), t(v), mesh, causal=causal))
        out[f"ulysses_array_{causal}"] = np_(ulysses.ulysses_attention(
            t(q), t(k), t(v), mesh, causal=causal))
        q, k, v = qkv(*QKV["flash"])
        out[f"ring_flash_{causal}"] = np_(ring_attention.ring_attention_spmd(
            t(block(q)), t(block(k)), t(block(v)), sp, causal,
            use_flash=True))
    # gradients of sum(o**2) over the whole sequence, through both algebras
    # and through Ulysses: each rank differentiates its block's share
    for name, fn in (
            ("ring_flash", lambda a, b, c: ring_attention.ring_attention_spmd(
                a, b, c, sp, True, use_flash=True)),
            ("ring_online", lambda a, b, c: ring_attention.ring_attention_spmd(
                a, b, c, sp, True, use_flash=False)),
            ("ulysses", lambda a, b, c: ulysses.ulysses_attention_spmd(
                a, b, c, sp, True))):
        xs = [t(block(a), grad=True) for a in qkv(*QKV["grad"])]
        (fn(*xs) ** 2).sum().backward()
        for c, x in zip("qkv", xs):
            out[f"{name}_grad_{c}"] = np_(x.grad)

    emesh = hvd.build_mesh(ep=N)
    ep = emesh.axis("ep")

    def expert(p, xs):
        return torch.tanh(xs @ p["w1"]) @ p["w2"]

    x, rw, params = moe_inputs(2)
    tparams = {k: t(v) for k, v in params.items()}
    for axes in ((), ("ep",)):
        y, met = moe.moe_layer(t(x), t(rw), expert, tparams, emesh,
                               token_axes=axes)
        out[f"moe_{'ep' if axes else 'replicated'}_y"] = np_(y)
        out[f"moe_{'ep' if axes else 'replicated'}_aux"] = np_(met.aux_loss)

    # gradients through the expert-parallel layer (each rank's tokens, its
    # experts) against one process gating each rank's tokens on its own
    w = moe_weights()
    n = T // N
    rows = slice(ep.index * n, (ep.index + 1) * n)
    xl, rl = t(x[rows], grad=True), t(rw, grad=True)
    local = {k: t(v[ep.index * (E // N):(ep.index + 1) * (E // N)],
                  grad=True) for k, v in params.items()}
    y, _ = moe.moe_layer_spmd(xl, rl, expert, local, ep)
    (y * t(w[rows])).sum().backward()
    out["moe_grad_x"] = np_(xl.grad)
    out["moe_grad_router"] = np_(rl.grad)
    for k, v in local.items():
        out[f"moe_grad_{k}"] = np_(v.grad)
    xr, rr = t(x, grad=True), t(rw, grad=True)
    full = {k: t(v, grad=True) for k, v in params.items()}
    loss = 0
    for g in range(N):
        sl = slice(g * n, (g + 1) * n)
        y, _ = moe.moe_layer_spmd(xr[sl], rr, expert, full, None)
        loss = loss + (y * t(w[sl])).sum()
    loss.backward()
    out["oracle_grad_x"] = np_(xr.grad)
    out["oracle_grad_router"] = np_(rr.grad)
    for k, v in full.items():
        out[f"oracle_grad_{k}"] = np_(v.grad)
    out["sp_index"] = np.array(sp.index)
    out["ep_index"] = np.array(ep.index)
    return out


if __name__ == "__main__":
    sys.exit(worker_main({"layers": _w_layers}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("layers", N, tmp_path_factory.mktemp("layers"),
                 script=__file__)


def _jax(name, causal=True):
    return [jnp.asarray(a) for a in qkv(*QKV[name])]


def _blocks(a, r):
    n = a.shape[1] // N
    return a[:, r * n:(r + 1) * n]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full(ranks, causal):
    """tests/test_parallel_layers.py:25-31 at sp=2: 2e-5."""
    ref = np.asarray(_plain_attention(*_jax("small"), causal=causal))
    for r in ranks:
        np.testing.assert_allclose(r[f"ring_array_{causal}"], ref, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_flash_path_matches_full(ranks, causal):
    """tests/test_parallel_layers.py:34-48: the flash algebra (per-step
    ``flash_attention_with_lse`` and the logaddexp merge; the plain
    version on the CPU) at [1, 512, 2, 128] over sp=2: 2e-4."""
    ref = np.asarray(_plain_attention(*_jax("flash"), causal=causal))
    for r in ranks:
        np.testing.assert_allclose(r[f"ring_flash_{causal}"],
                                   _blocks(ref, int(r["sp_index"])),
                                   rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def attention_grads():
    def loss_ref(q, k, v):
        return jnp.sum(_plain_attention(q, k, v, causal=True) ** 2)
    return [np.asarray(g) for g in
            jax.grad(loss_ref, argnums=(0, 1, 2))(*_jax("grad"))]


@pytest.mark.parametrize("path", ["ring_flash", "ring_online", "ulysses"])
def test_sequence_parallel_grads(ranks, attention_grads, path):
    """tests/test_parallel_layers.py:51-72: the written-out ring backward
    (both algebras) and Ulysses' swapped all-to-alls give every rank its
    block of the gradient of sum(o**2) through the oracle: 5e-4."""
    for r in ranks:
        for c, g in zip("qkv", attention_grads):
            np.testing.assert_allclose(r[f"{path}_grad_{c}"],
                                       _blocks(g, int(r["sp_index"])),
                                       rtol=5e-4, atol=5e-4, err_msg=c)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_full(ranks, causal):
    """tests/test_parallel_layers.py:83-90 at sp=2: 2e-5."""
    ref = np.asarray(_plain_attention(*_jax("small"), causal=causal))
    for r in ranks:
        np.testing.assert_allclose(r[f"ulysses_array_{causal}"], ref,
                                   rtol=2e-5, atol=2e-5)


def _ffn_expert(p, x):
    return jnp.tanh(x @ p["w1"]) @ p["w2"]


@pytest.mark.parametrize("tokens", ["replicated", "ep"])
def test_moe_ep2_matches_jax(ranks, tokens):
    """tests/test_parallel_layers.py:113-130 at ep=2: the output and aux
    loss of the JAX ``moe_layer`` (1e-5). Tokens replicated: the JAX layer
    on the same mesh. Tokens split over ep, as the model splits them: the
    JAX layer with the tokens split over dp=2 instead, the same two groups
    each gated on its own (its ``moe_layer`` cannot split tokens over the
    ep axis itself: it would pmean its metrics over ep twice)."""
    x, rw, params = moe_inputs(2)
    mesh = build_mesh(**{"ep" if tokens == "replicated" else "dp": N},
                      devices=jax.devices()[:N])
    y, met = moe_layer(jnp.asarray(x), jnp.asarray(rw), _ffn_expert,
                       {k: jnp.asarray(v) for k, v in params.items()}, mesh,
                       token_axes=("dp",) if tokens == "ep" else ())
    for r in ranks:
        np.testing.assert_allclose(r[f"moe_{tokens}_y"], np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[f"moe_{tokens}_aux"],
                                   float(met.aux_loss), rtol=1e-5)


def test_moe_ep2_grads_reach_the_expert_owner(ranks):
    """The all-to-all's backward (split and concat swapped) brings every
    rank's cotangent to the expert's owner: each rank's expert gradients
    are its slice of the one-process gradient over both ranks' token
    groups, its token gradients its rows, and the router's, replicated,
    sum over ep to the whole (1e-5)."""
    n = T // N
    router = sum(r["moe_grad_router"] for r in ranks)
    for r in ranks:
        i = int(r["ep_index"])
        np.testing.assert_allclose(r["moe_grad_x"],
                                   r["oracle_grad_x"][i * n:(i + 1) * n],
                                   rtol=1e-5, atol=1e-6)
        for k in ("w1", "w2"):
            np.testing.assert_allclose(
                r[f"moe_grad_{k}"],
                r[f"oracle_grad_{k}"][i * E // N:(i + 1) * E // N],
                rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(router, r["oracle_grad_router"],
                                   rtol=1e-5, atol=1e-6)
