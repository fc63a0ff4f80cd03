"""The port's flagship over tp, sp and ep (and dp beside them) against the
JAX package, on the CPU: the tiny flagship in fp32 (L 2, B 8, S 32) at
seven layouts, in gloo worlds of 2, 4 and 8 processes.

The oracles (the JAX ``make_grad_fn`` gradients are not one at these
layouts; ROADMAP Queue 3):
* loss: the JAX loss at the same layout (1e-4);
* gradients of a dense layout: the JAX ``dp=1`` gradient (tp and sp do
  not change the dense math), sliced as the rank holds it (1e-4);
* gradients of an MoE layout: the JAX gradient at the same layout divided
  by ``dp·ep·sp`` (capacity is per group of local tokens, so the layout is
  part of the function);
* one AdamW step: ``optax.adamw(1e-3)`` on the oracle gradient (1e-4).
Leaves replicated over an axis must be bit-identical across its ranks.
Two tests pin the JAX side's faults, as
``test_jax_dp2_gradients_are_twice_the_full_batch`` pins dp's.

The torch side runs as ``python tests/test_torch_port_layouts.py --worker
world<n> --out DIR`` (``spawn`` of ``tests/test_torch_port_dp.py``),
importing no JAX.
"""

import dataclasses
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import worker_main  # noqa: E402

if __name__ != "__main__":
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp
    import optax
    import pytest

    from test_torch_port_dp import spawn

B, S, L = 8, 32, 2
AXES = ("dp", "pp", "ep", "sp", "tp")
# world size -> [(moe, mesh sizes)]
WORLDS = {
    2: [(False, {"tp": 2}), (False, {"sp": 2}), (True, {"ep": 2})],
    4: [(True, {"ep": 2, "sp": 2})],
    8: [(False, {"dp": 2, "sp": 2, "tp": 2}), (False, {"dp": 2, "tp": 4}),
        (True, {"dp": 2, "ep": 2, "sp": 2})],
}
LAYOUTS = [(n, i, moe, sizes) for n, ls in WORLDS.items()
           for i, (moe, sizes) in enumerate(ls)]


def _ids(layout):
    return ",".join(f"{k}{v}" for k, v in layout[3].items()) + (
        "-moe" if layout[2] else "")


def batch(vocab):
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, vocab, (B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, 1)


def torch_cfg(moe):
    from horovod_tpu_torch.entry import _flagship_cfg
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), n_layers=L)
    return dataclasses.replace(cfg, n_experts=4) if moe else cfg


# -- the worker (torch only) ---------------------------------------------------

def _w_world(n):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          init_params, make_grad_fn,
                                          make_train_step, shard_params)

    out = {"rank": np.array(hvd.rank())}
    for i, (moe, sizes) in enumerate(WORLDS[n]):
        cfg = torch_cfg(moe)
        mesh = hvd.build_mesh(**sizes)
        sd = shard_params(init_params(np.random.RandomState(0), cfg), cfg,
                          mesh)
        tokens, targets = batch(cfg.vocab_size)
        tok, tgt = hvd.shard_batch(torch.from_numpy(tokens).long(),
                                   torch.from_numpy(targets).long(), mesh)
        model = Transformer(cfg, "cpu", mesh)
        model.load_state_dict(sd)
        loss, aux, grads = make_grad_fn(cfg, mesh)(model, tok, tgt)
        out[f"L{i}_loss"] = loss.numpy().copy()
        out[f"L{i}_aux"] = aux.numpy().copy()
        for k, g in grads.items():
            out[f"L{i}_grad_{k}"] = g.numpy().copy()
        opt = init_opt_state(adamw, model)
        _, _, step_loss, _ = make_train_step(cfg, mesh)(model, opt, tok, tgt)
        out[f"L{i}_step_loss"] = step_loss.numpy().copy()
        for k, p in model.state_dict().items():
            out[f"L{i}_param_{k}"] = p.numpy().copy()
    return out


if __name__ == "__main__":
    sys.exit(worker_main({f"world{n}": functools.partial(_w_world, n)
                          for n in WORLDS}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: spawn(f"world{n}", n, tmp_path_factory.mktemp(f"world{n}"),
                     script=__file__) for n in WORLDS}


def jax_cfg(moe):
    from __graft_entry__ import _flagship_cfg
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), n_layers=L,
                              n_microbatches=1)
    return dataclasses.replace(cfg, n_experts=4) if moe else cfg


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


@functools.lru_cache(maxsize=None)
def jax_layout(moe, sizes):
    """The JAX package's (loss, aux, flat grads) at a layout."""
    from horovod_tpu.models import (init_params, make_grad_fn, shard_batch,
                                    shard_params)
    from horovod_tpu.parallel.mesh import build_mesh
    sizes = dict(sizes)
    n = int(np.prod(list(sizes.values())))
    cfg = jax_cfg(moe)
    mesh = build_mesh(**sizes, devices=jax.devices()[:n])
    params = shard_params(init_params(np.random.RandomState(0), cfg, 1), cfg,
                          mesh)
    tokens, targets = batch(cfg.vocab_size)
    tok, tgt = shard_batch(jnp.asarray(tokens), jnp.asarray(targets), mesh)
    loss, aux, grads = jax.jit(make_grad_fn(cfg, mesh))(params, tok, tgt)
    return float(loss), float(aux), _flat(jax.device_get(grads))


def _key(sizes):
    return tuple(sorted(sizes.items()))


def oracle(moe, sizes):
    """The true gradient of the layout's loss, as a full tree."""
    if moe:
        _, _, g = jax_layout(True, _key(sizes))
        div = np.prod([sizes.get(a, 1) for a in ("dp", "ep", "sp")])
        return {k: v / div for k, v in g.items()}
    return jax_layout(False, (("dp", 1),))[2]


def adamw_oracle(moe, grads):
    from horovod_tpu.models import init_params
    params = _flat(init_params(np.random.RandomState(0), jax_cfg(moe), 1))
    tx = optax.adamw(1e-3)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    u, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                     tx.init(p), p)
    return {k: np.asarray(v) for k, v in optax.apply_updates(p, u).items()}


def _coords(rank, sizes):
    shape = [sizes.get(a, 1) for a in AXES]
    return dict(zip(AXES, np.unravel_index(rank, shape)))


def _slice(full, key, moe, sizes, coords):
    """The block of ``full`` that the rank at ``coords`` holds."""
    from horovod_tpu_torch.models import param_shardings
    mesh = SimpleNamespace(shape={a: sizes.get(a, 1) for a in AXES})
    out = full
    for d, a in param_shardings(torch_cfg(moe), mesh)[key].items():
        n = out.shape[d] // sizes[a]
        out = np.take(out, range(coords[a] * n, (coords[a] + 1) * n), axis=d)
    return out


def _ranks(worlds, layout):
    n, i, moe, sizes = layout
    return [(r, {k[len(f"L{i}_"):]: v for k, v in res.items()
                 if k.startswith(f"L{i}_")}) for r, res in enumerate(worlds[n])]


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_layout_loss_matches_jax(worlds, layout):
    """Every rank reports the layout's loss and aux, JAX's at the same
    layout (1e-4), and the AdamW step's loss is the same number."""
    _, _, moe, sizes = layout
    loss, aux, _ = jax_layout(moe, _key(sizes))
    for r, res in _ranks(worlds, layout):
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-4)
        np.testing.assert_allclose(res["aux"], aux, rtol=1e-4, atol=1e-7)
        assert res["step_loss"] == res["loss"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_layout_gradients_are_the_true_gradient(worlds, layout):
    """Each rank's gradient is its slice of the layout's true gradient:
    JAX dp=1's for a dense layout, JAX's at the layout over dp·ep·sp for
    an MoE one; 1e-4 relative per leaf (L2), 1e-4 per element."""
    _, _, moe, sizes = layout
    want = oracle(moe, sizes)
    for r, res in _ranks(worlds, layout):
        c = _coords(r, sizes)
        for k, full in want.items():
            got, ref = res[f"grad_{k}"], _slice(full, k, moe, sizes, c)
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= 1e-4, (k, r, rel)
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_layout_replicated_leaves_are_bit_identical(worlds, layout):
    """Ranks holding the same block of a leaf hold bit-identical gradients
    and, after the AdamW step, bit-identical parameters."""
    from horovod_tpu_torch.models import param_shardings
    _, _, moe, sizes = layout
    mesh = SimpleNamespace(shape={a: sizes.get(a, 1) for a in AXES})
    specs = param_shardings(torch_cfg(moe), mesh)
    ranks = _ranks(worlds, layout)
    for k, spec in specs.items():
        groups = {}
        for r, res in ranks:
            c = _coords(r, sizes)
            groups.setdefault(tuple(c[a] for a in spec.values()), []).append(
                res)
        assert len(groups) == int(np.prod([sizes[a] for a in spec.values()]))
        for members in groups.values():
            for res in members[1:]:
                for what in ("grad", "param"):
                    np.testing.assert_array_equal(
                        res[f"{what}_{k}"], members[0][f"{what}_{k}"],
                        err_msg=f"{what} {k}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_layout_adamw_step_matches_optax(worlds, layout):
    """One ``make_train_step`` AdamW step on each rank's shards equals
    ``optax.adamw(1e-3)`` on the oracle gradient, sliced (1e-4)."""
    _, _, moe, sizes = layout
    want = adamw_oracle(moe, oracle(moe, sizes))
    for r, res in _ranks(worlds, layout):
        c = _coords(r, sizes)
        for k, full in want.items():
            np.testing.assert_allclose(res[f"param_{k}"],
                                       _slice(full, k, moe, sizes, c),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_jax_sp2_gradients_are_twice_the_dp1_ones():
    """The JAX reference fault the port does not follow (ROADMAP Queue
    3): at ``{sp:2}`` the JAX flagship's loss equals dp=1's and every
    gradient leaf is 2.0x dp=1's (the sp factor of ``dp·ep·sp``)."""
    one = jax_layout(False, (("dp", 1),))
    two = jax_layout(False, (("sp", 2),))
    assert abs(one[0] - two[0]) < 1e-5
    for k, g in one[2].items():
        np.testing.assert_allclose(two[2][k], 2.0 * g, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_jax_tp2_sharded_leaves_twice_and_norms_wrong():
    """The other JAX fault: at ``{tp:2}`` the tp-sharded leaves' gradients
    are 2.0x dp=1's, and the replicated norms' (ln1, ln2, ln_f) are no
    multiple of dp=1's: their least-squares ratio leaves a residual of the
    gradient's own size (the partial sums of one tp rank)."""
    one = jax_layout(False, (("dp", 1),))
    two = jax_layout(False, (("tp", 2),))
    assert abs(one[0] - two[0]) < 1e-5
    for k in ("embed", "layers.wq", "layers.wk", "layers.wv", "layers.wo",
              "layers.w1", "layers.w2"):
        np.testing.assert_allclose(two[2][k], 2.0 * one[2][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k in ("layers.ln1", "layers.ln2", "ln_f"):
        a, b = one[2][k].ravel(), two[2][k].ravel()
        ratio = float(a @ b / (a @ a))
        resid = np.linalg.norm(b - ratio * a) / np.linalg.norm(b)
        assert resid > 0.1, (k, ratio, resid)


@functools.lru_cache(maxsize=None)
def jax_pp_layout(sizes):
    """The JAX flagship at a layout with pp (two microbatches, the layers
    drawn in ``[pp, L/pp, ...]``): (loss, flat grads viewed ``[1, L,
    ...]``)."""
    from horovod_tpu.models import (init_params, make_grad_fn, shard_batch,
                                    shard_params)
    from horovod_tpu.parallel.mesh import build_mesh
    sizes = dict(sizes)
    n = int(np.prod(list(sizes.values())))
    cfg = dataclasses.replace(jax_cfg(False), n_microbatches=2)
    mesh = build_mesh(**sizes, devices=jax.devices()[:n])
    params = shard_params(init_params(np.random.RandomState(0), cfg,
                                      sizes["pp"]), cfg, mesh)
    tokens, targets = batch(cfg.vocab_size)
    tok, tgt = shard_batch(jnp.asarray(tokens), jnp.asarray(targets), mesh)
    loss, _, grads = jax.jit(make_grad_fn(cfg, mesh))(params, tok, tgt)
    flat = _flat(jax.device_get(grads))
    return float(loss), {k: v.reshape((1, -1) + v.shape[2:])
                         if k.startswith("layers.") else v
                         for k, v in flat.items()}


def _ratio_residual(ref, got):
    a, b = ref.ravel(), got.ravel()
    ratio = float(a @ b / (a @ a))
    return ratio, np.linalg.norm(b - ratio * a) / np.linalg.norm(b)


def test_jax_pp2_gradient_is_the_dp1_one_and_tp_faults_persist():
    """The JAX oracle of the pipeline slice: at ``{pp:2}`` the JAX
    flagship's loss and every gradient leaf equal dp=1's (least-squares
    ratio 1, residual at most 1e-6 of the leaf), so its pp gradient is
    the true one; at ``{pp:2, tp:2}`` the tp faults above persist: the
    tp-sharded leaves 2.0x, the norms no multiple of dp=1's."""
    one = jax_layout(False, (("dp", 1),))
    pp = jax_pp_layout((("pp", 2),))
    assert abs(one[0] - pp[0]) < 1e-5
    for k, g in one[2].items():
        ratio, resid = _ratio_residual(g, pp[1][k])
        assert abs(ratio - 1.0) < 1e-5 and resid <= 1e-6, (k, ratio, resid)
    pptp = jax_pp_layout((("pp", 2), ("tp", 2)))
    assert abs(one[0] - pptp[0]) < 1e-5
    for k in ("embed", "layers.wq", "layers.wk", "layers.wv", "layers.wo",
              "layers.w1", "layers.w2"):
        np.testing.assert_allclose(pptp[1][k], 2.0 * one[2][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k in ("layers.ln1", "layers.ln2", "ln_f"):
        _, resid = _ratio_residual(one[2][k], pptp[1][k])
        assert resid > 0.1, (k, resid)
