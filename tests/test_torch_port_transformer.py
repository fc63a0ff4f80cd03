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
                                      make_forward, make_grad_fn,
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
    import dataclasses
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), n_experts=4)
    with pytest.raises(NotImplementedError):
        Transformer(cfg, device="cpu")
