"""The port's flagship transformer vs the JAX package on the tiny flagship
configuration in fp32, on a 1-device mesh: the same parameters (bit for
bit from one numpy seed, then carried across with ``from_jax_params``),
the same loss, every gradient leaf, and the parameters after one AdamW
step against ``optax.adamw(1e-3)``."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from __graft_entry__ import _flagship_cfg as jax_flagship_cfg
from horovod_tpu.models import (init_opt_state as jax_init_opt_state,
                                init_params as jax_init_params,
                                make_forward as jax_make_forward,
                                make_grad_fn as jax_make_grad_fn,
                                make_train_step as jax_make_train_step,
                                shard_batch, shard_params)
from horovod_tpu.parallel.mesh import build_mesh

from horovod_tpu_torch.entry import _flagship_cfg, entry
from horovod_tpu_torch.models import (Transformer, adamw, from_jax_params,
                                      init_opt_state, init_params,
                                      lm_loss, make_forward, make_grad_fn,
                                      make_train_step)
from horovod_tpu_torch.models.scan_util import multi_step

B, S = 4, 64


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_flagship_cfg(tiny=True)
    tcfg = _flagship_cfg(tiny=True)
    params = jax_init_params(np.random.RandomState(0), jcfg, 1)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    mesh = build_mesh(dp=1, devices=jax.devices()[:1])
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tokens=tokens,
                targets=targets, mesh=mesh, model=model)


def _jax_batch(s):
    return shard_batch(jnp.asarray(s["tokens"]), jnp.asarray(s["targets"]),
                       s["mesh"])


def _torch_batch(s):
    return (torch.from_numpy(s["tokens"]).long(),
            torch.from_numpy(s["targets"]).long())


@pytest.mark.parametrize("tiny", [True, False])
def test_init_params_bit_identical(tiny):
    jcfg, tcfg = jax_flagship_cfg(tiny=tiny), _flagship_cfg(tiny=tiny)
    if not tiny:   # full width: compare the cheap leaves' draws by a smaller L
        import dataclasses
        jcfg = dataclasses.replace(jcfg, n_layers=1)
        tcfg = dataclasses.replace(tcfg, n_layers=1)
    ref = _flat(jax_init_params(np.random.RandomState(0), jcfg, 1))
    got = _flat(init_params(np.random.RandomState(0), tcfg))
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("moe", [False, True])
def test_init_params_per_stage_bit_identical(stages, moe):
    """``init_params(rng, cfg, n_stages)`` equals the JAX package's for 1,
    2 and 4 stages (layers ``[pp, L/pp, ...]``), and every stage layout
    reshapes to the one-stage draw."""
    import dataclasses
    jcfg, tcfg = jax_flagship_cfg(tiny=True), _flagship_cfg(tiny=True)
    if moe:
        jcfg = dataclasses.replace(jcfg, n_experts=4)
        tcfg = dataclasses.replace(tcfg, n_experts=4)
    ref = _flat(jax_init_params(np.random.RandomState(0), jcfg, stages))
    got = _flat(init_params(np.random.RandomState(0), tcfg, stages))
    one = _flat(init_params(np.random.RandomState(0), tcfg))
    assert list(got) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        np.testing.assert_array_equal(got[name].reshape(one[name].shape),
                                      one[name], err_msg=name)


def test_shard_params_takes_any_stage_layout():
    """A rank of ``{pp:2, tp:2}`` gets the same shards from the JAX
    ``[2, L/2, ...]`` tree and from the one-stage ``[1, L, ...]`` one: its
    stage's contiguous layers, sliced over tp (a stand-in mesh: slicing
    reads only the axes' sizes and positions)."""
    from types import SimpleNamespace
    from horovod_tpu_torch.models import shard_params
    cfg = _flagship_cfg(tiny=True)
    coords = {"dp": 0, "pp": 1, "ep": 0, "sp": 0, "tp": 1}
    sizes = {"dp": 1, "pp": 2, "ep": 1, "sp": 1, "tp": 2}

    class Mesh:
        shape = sizes

        def axis(self, a):
            return SimpleNamespace(size=sizes[a], index=coords[a])

    staged = shard_params(init_params(np.random.RandomState(0), cfg, 2), cfg,
                          Mesh())
    flat = shard_params(init_params(np.random.RandomState(0), cfg), cfg,
                        Mesh())
    full = _flat(init_params(np.random.RandomState(0), cfg))
    for k in staged:
        torch.testing.assert_close(staged[k], flat[k], rtol=0, atol=0)
    assert tuple(staged["layers.wq"].shape) == (1, 2, 64, 32)
    np.testing.assert_array_equal(staged["layers.wq"].numpy()[0],
                                  full["layers.wq"][0, 2:4, :, 32:])
    assert tuple(staged["embed"].shape) == (128, 64)
    assert tuple(staged["ln_f"].shape) == (64,)


def test_from_jax_params_carries_every_leaf(setup):
    sd = setup["model"].state_dict()
    flat = _flat(setup["params"])
    assert set(sd) == set(flat)
    for name, val in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), val, err_msg=name)


def test_forward_loss_matches_jax(setup):
    s = setup
    ref = float(jax_make_forward(s["jcfg"], s["mesh"])(
        shard_params(s["params"], s["jcfg"], s["mesh"]), *_jax_batch(s)))
    got = float(make_forward(s["tcfg"])(s["model"], *_torch_batch(s)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_every_gradient_leaf_matches_jax(setup):
    s = setup
    loss_j, _, grads_j = jax_make_grad_fn(s["jcfg"], s["mesh"])(
        shard_params(s["params"], s["jcfg"], s["mesh"]), *_jax_batch(s))
    loss_t, aux_t, grads_t = make_grad_fn(s["tcfg"])(s["model"],
                                                     *_torch_batch(s))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    assert float(aux_t) == 0.0
    flat = _flat(jax.device_get(grads_j))
    assert set(grads_t) == set(flat)
    for name, g in flat.items():
        np.testing.assert_allclose(grads_t[name].numpy(), g, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_one_adamw_step_matches_optax(setup):
    s = setup
    tx = optax.adamw(1e-3)
    step_j = jax_make_train_step(s["jcfg"], s["mesh"], tx)
    p_j = shard_params(s["params"], s["jcfg"], s["mesh"])
    o_j = jax_init_opt_state(tx, p_j, s["mesh"], s["jcfg"])
    p_j, _, loss_j, _ = step_j(p_j, o_j, *_jax_batch(s))

    model = copy.deepcopy(s["model"])
    opt = init_opt_state(adamw, model)
    _, _, loss_t, _ = make_train_step(s["tcfg"])(model, opt,
                                                 *_torch_batch(s))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    sd = model.state_dict()
    for name, val in _flat(jax.device_get(p_j)).items():
        np.testing.assert_allclose(sd[name].numpy(), val, rtol=0, atol=2e-5,
                                   err_msg=name)


def test_scan_steps_chain_same_batch(setup):
    """scan_steps=3 equals three single steps on the same batch."""
    s = setup
    batch = _torch_batch(s)
    m1, m2 = copy.deepcopy(s["model"]), copy.deepcopy(s["model"])
    o1, o2 = init_opt_state(adamw, m1), init_opt_state(adamw, m2)
    one = make_train_step(s["tcfg"])
    for _ in range(3):
        _, _, loss1, _ = one(m1, o1, *batch)
    _, _, loss3, _ = make_train_step(s["tcfg"], scan_steps=3)(m2, o2, *batch)
    assert float(loss3) == float(loss1)
    for (n, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n


def test_multi_step_passthrough_and_last_outs():
    f = lambda c, x: (c + x, c * 10)                       # noqa: E731
    assert multi_step(f, n_carry=1, scan_steps=1) is f
    assert multi_step(f, n_carry=1, scan_steps=0) is f
    assert multi_step(f, n_carry=1, scan_steps=3)(1, 2) == (7, 50)


def test_training_lowers_the_loss_on_cpu(setup):
    s = setup
    model = copy.deepcopy(s["model"])
    opt = init_opt_state(adamw, model)
    step = make_train_step(s["tcfg"])
    losses = [float(step(model, opt, *_torch_batch(s))[2]) for _ in range(4)]
    assert losses[-1] < losses[0], losses


def test_entry_runs_on_cpu_when_asked():
    fn, (model, tokens, targets) = entry(device="cpu", tiny=True)
    assert tokens.shape == (8, 64) and tokens.device.type == "cpu"
    loss = fn(model, tokens, targets)
    assert loss.shape == () and np.isfinite(float(loss))
    # same seeds as __graft_entry__: params from 0, batch from 1
    rng = np.random.RandomState(1)
    np.testing.assert_array_equal(tokens.numpy(),
                                  rng.randint(0, 256, (8, 64)))
    np.testing.assert_array_equal(targets.numpy(),
                                  np.roll(tokens.numpy(), -1, 1))


def test_step_rejects_a_model_of_another_config(setup):
    fn = make_forward(_flagship_cfg(tiny=False))
    with pytest.raises(ValueError):
        fn(setup["model"], *_torch_batch(setup))


def test_moe_config_raises():
    """An MoE config builds (since the expert-parallel slice) and, since
    the pipeline slice, a mesh with pp > 1 no longer raises: the model
    holds its stage's ``[1, L/pp, ...]`` layer shards (the embedding and
    ``ln_f`` whole), and two ``make_train_step`` AdamW steps in a world
    of two gloo ranks give both stages the same finite, falling loss. (The
    name is from before the pipeline slice.)"""
    import dataclasses
    import os
    import sys
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), n_experts=4)
    model = Transformer(cfg, device="cpu")
    assert tuple(model.layers["we1"].shape) == (1, 4, 4, 64, 128)

    class PipelineMesh:
        shape = {"dp": 1, "pp": 2, "ep": 1, "sp": 1, "tp": 1}

    staged = Transformer(cfg, device="cpu", mesh=PipelineMesh())
    assert tuple(staged.layers["we1"].shape) == (1, 2, 4, 64, 128)
    make_train_step(cfg, PipelineMesh())

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from torch_port_worker import spawn_world
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        ranks = spawn_world(os.path.join(here, "test_torch_port_pipeline.py"),
                            "moe_pp2", 2, out)
    for res in ranks:
        assert tuple(res["shape_layers.we1"]) == (1, 2, 4, 64, 128)
        assert tuple(res["shape_layers.router"]) == (1, 2, 64, 4)
        assert tuple(res["shape_embed"]) == (256, 64)
        np.testing.assert_array_equal(res["losses"], ranks[0]["losses"])
        assert np.isfinite(res["losses"]).all()
        assert res["losses"][1] < res["losses"][0]


def test_model_and_step_share_one_mesh():
    """A model built with a mesh runs only under a step built with that
    mesh, and ``lm_loss`` (whose dp engines average over dp themselves)
    refuses a model whose mesh has a live data axis; a model built without
    a mesh runs under any mesh its shapes fit."""
    from types import SimpleNamespace

    class Mesh:
        def __init__(self, **live):
            self.shape = {a: live.get(a, 1) for a in
                          ("dp", "pp", "ep", "sp", "tp")}

        def axis(self, a):
            return SimpleNamespace(name=a, size=self.shape[a], index=0)

    cfg = _flagship_cfg(tiny=True)
    sd = from_jax_params(init_params(np.random.RandomState(0), cfg))
    tokens = torch.zeros((2, 8), dtype=torch.long)
    one, other = Mesh(), Mesh()
    model = Transformer(cfg, device="cpu", mesh=one)
    model.load_state_dict(sd)
    make_forward(cfg, one)(model, tokens, tokens)
    for mesh in (other, None):
        with pytest.raises(ValueError, match="build both with one"):
            make_forward(cfg, mesh)(model, tokens, tokens)
    bare = Transformer(cfg, device="cpu")
    bare.load_state_dict(sd)
    make_forward(cfg, other)(bare, tokens, tokens)
    lm_loss(model, (tokens, tokens))
    with pytest.raises(ValueError, match="live data axes"):
        lm_loss(Transformer(cfg, device="cpu", mesh=Mesh(dp=2)),
                (tokens, tokens))
