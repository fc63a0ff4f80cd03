"""The port's int8 error-feedback optimizers against the JAX package's, on
the CPU.

(i) ``DistributedOptimizer(fused_sgd | fused_adam, ...)`` against JAX
``hvd.DistributedOptimizer(spec, compression=ErrorFeedback(
BlockInt8Quantizer(256, interpret=True)))`` over five gradient trees;
(ii) ``DistributedOptimizer(adamw, compression=ErrorFeedback(int8))``
against ``optax.chain(error_feedback_transform(...), optax.adamw(1e-3))``;
(iii) the combinations both packages refuse; (iv) the slice: three train
steps of the tiny flagship through ``make_train_step`` in both packages,
and a resume of the port from a JAX optimizer state."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from __graft_entry__ import _flagship_cfg as jax_flagship_cfg
from horovod_tpu.compression.error_feedback import (
    ErrorFeedback as JErrorFeedback, error_feedback_transform)
from horovod_tpu.compression.quantizers import (
    BlockInt8Quantizer as JBlockInt8Quantizer)
from horovod_tpu.models import (init_opt_state as jax_init_opt_state,
                                init_params as jax_init_params,
                                make_grad_fn as jax_make_grad_fn,
                                make_train_step as jax_make_train_step,
                                shard_batch, shard_params)
from horovod_tpu.parallel.mesh import build_mesh

import horovod_tpu_torch as th
from horovod_tpu_torch.compression import (BlockInt8Quantizer, Compression,
                                           ErrorFeedback)
from horovod_tpu_torch.entry import _flagship_cfg
from horovod_tpu_torch.models import (Transformer, adamw, from_jax_params,
                                      init_opt_state, make_train_step)
from horovod_tpu_torch.ops import quantize as tq
from horovod_tpu_torch.train.fused_apply import (FusedOptimizer, _from_blocks,
                                                 _to_blocks)


def _param_tree(rng):
    """The shapes of ``tests/test_fused_apply.py``'s ``_param_tree``: 300
    and 7 elements, neither a multiple of the block."""
    return {"w": rng.randn(10, 30).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}


def _run_both(jax_tx, make_torch_opt, steps=5, seed=5):
    """The same initial parameters and gradient trees through a JAX
    transform and a torch optimizer; returns both final parameter dicts."""
    rng = np.random.RandomState(seed)
    init = _param_tree(rng)
    grads = [_param_tree(rng) for _ in range(steps)]
    p_j = {k: jnp.asarray(v) for k, v in init.items()}
    st = jax_tx.init(p_j)
    for g in grads:
        u, st = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                              p_j)
        p_j = optax.apply_updates(p_j, u)
    p_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for k, v in init.items()}
    opt = make_torch_opt(list(p_t.items()))
    for g in grads:
        for k, p in p_t.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return ({k: np.asarray(v) for k, v in p_j.items()},
            {k: p.detach().numpy() for k, p in p_t.items()})


FUSED = [
    ("sgd", lambda h: h.fused_sgd(0.1)),
    ("sgd_mom", lambda h: h.fused_sgd(0.1, momentum=0.9)),
    ("adam", lambda h: h.fused_adam(1e-3)),
]


@pytest.mark.parametrize("name,spec", FUSED, ids=[f[0] for f in FUSED])
def test_fused_optimizer_matches_jax(hvd, name, spec):
    """(i) five EF steps of the fused optimizer, params within 1e-5."""
    jax_tx = hvd.DistributedOptimizer(
        spec(hvd), compression=JErrorFeedback(
            JBlockInt8Quantizer(256, interpret=True)))
    ref, got = _run_both(jax_tx, lambda named: th.DistributedOptimizer(
        spec(th), named, compression=ErrorFeedback(BlockInt8Quantizer(256))))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_fused_optimizer_without_ef_matches_jax(hvd):
    """The bare codec: quantized each step, no residual carried."""
    jax_tx = hvd.DistributedOptimizer(
        hvd.fused_sgd(0.1, momentum=0.9),
        compression=JBlockInt8Quantizer(256, interpret=True))
    ref, got = _run_both(jax_tx, lambda named: th.DistributedOptimizer(
        th.fused_sgd(0.1, momentum=0.9), named,
        compression=Compression.int8))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_ef_adamw_wrapper_matches_optax_chain():
    """(ii) way 1: EF int8 in front of AdamW."""
    jax_tx = optax.chain(
        error_feedback_transform(JBlockInt8Quantizer(256, interpret=True)),
        optax.adamw(1e-3))
    ref, got = _run_both(jax_tx, lambda named: th.DistributedOptimizer(
        adamw([p for _, p in named]),
        compression=ErrorFeedback(BlockInt8Quantizer(256))))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_ef_wrapper_scales_like_jax(hvd):
    """EF first, then pre- and postscale, as the JAX sync applies them."""
    codec = JBlockInt8Quantizer(256, interpret=True)
    jax_tx = hvd.DistributedOptimizer(optax.sgd(0.1),
                                      compression=JErrorFeedback(codec),
                                      prescale_factor=0.5,
                                      postscale_factor=3.0)
    ref, got = _run_both(jax_tx, lambda named: th.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1),
        compression=ErrorFeedback(BlockInt8Quantizer(256)),
        prescale_factor=0.5, postscale_factor=3.0))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_bare_codec_leaves_gradients_untouched():
    """Without EF a codec only compresses the multi-process wire: one
    process steps exactly as the optimizer alone."""
    p1 = torch.nn.Parameter(torch.from_numpy(_param_tree(
        np.random.RandomState(1))["w"]))
    p2 = torch.nn.Parameter(p1.detach().clone())
    o1 = th.DistributedOptimizer(torch.optim.SGD([p1], lr=0.1),
                                 compression=Compression.int8)
    o2 = torch.optim.SGD([p2], lr=0.1)
    g = torch.from_numpy(np.random.RandomState(2).randn(10, 30)
                         .astype(np.float32))
    for p, o in ((p1, o1), (p2, o2)):
        p.grad = g.clone()
        o.step()
    assert torch.equal(p1, p2)


def test_wrapper_is_the_optimizer_class_and_shares_its_state():
    p = torch.nn.Parameter(torch.ones(300))
    inner = adamw([p])
    opt = th.DistributedOptimizer(inner, compression=ErrorFeedback(
        Compression.int8))
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.param_groups is inner.param_groups
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    p.grad = torch.full((300,), 0.5)
    opt.step()
    assert opt.state is inner.state and len(opt.state[p]) == 3
    opt.zero_grad(set_to_none=True)
    assert p.grad is None
    sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(5e-4)


# -- (iii) what both packages refuse -------------------------------------------

def test_fused_requires_int8_codec():
    ps = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(ValueError, match="block-int8"):
        th.DistributedOptimizer(th.fused_sgd(0.1), ps)
    with pytest.raises(ValueError, match="block-int8"):
        th.DistributedOptimizer(th.fused_sgd(0.1), ps,
                                compression=Compression.fp16)
    with pytest.raises(ValueError, match="block-int8"):
        th.DistributedOptimizer(th.fused_adam(1e-3), ps,
                                compression=ErrorFeedback(Compression.onebit))


def test_fused_rejects_unsupported_combinations():
    ok = Compression.int8
    ps = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(ValueError, match="Adasum"):
        th.DistributedOptimizer(th.fused_sgd(0.1), ps, op=th.Adasum,
                                compression=ok)
    with pytest.raises(ValueError, match="scale"):
        th.DistributedOptimizer(th.fused_sgd(0.1), ps, compression=ok,
                                prescale_factor=2.0)
    with pytest.raises(ValueError, match="scale"):
        th.DistributedOptimizer(th.fused_sgd(0.1), ps, compression=ok,
                                postscale_factor=2.0)
    with pytest.raises(ValueError, match="Sum/Average"):
        th.DistributedOptimizer(th.fused_sgd(0.1), ps, compression=ok,
                                op=th.ReduceOp.MAX)
    with pytest.raises(ValueError, match="parameters"):
        th.DistributedOptimizer(th.fused_sgd(0.1), compression=ok)
    with pytest.raises(ValueError, match="unknown fused optimizer kind"):
        FusedOptimizer(ps, th.train.FusedOptSpec("lamb", 0.1),
                       compression=ok)


def test_wrapper_rejects_adasum_and_accumulation():
    """Adasum with a codec raises as in the JAX package, and in a world
    of one steps on the gradient itself; ``backward_passes_per_step=2``
    steps as ``optax.MultiSteps`` does: the first pass leaves the
    parameters, the second applies the mean of the two passes' gradients
    (wrapped torch optimizer and fused optimizer alike)."""
    ps = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(ValueError, match="Adasum"):
        th.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1), op=th.Adasum,
                                compression=Compression.int8)
    ada = th.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1), op=th.Adasum)
    ps[0].grad = torch.ones(4)
    ada.step()
    assert torch.equal(ps[0].detach(), torch.full((4,), -0.1))
    ps[0].data.zero_()
    ps[0].grad = None
    rng = np.random.RandomState(9)
    grads = [_param_tree(rng) for _ in range(4)]
    for spec, make in (
            (optax.sgd(0.1), lambda named: th.DistributedOptimizer(
                torch.optim.SGD([p for _, p in named], lr=0.1),
                backward_passes_per_step=2)),
            (hvd_fused_adam(), lambda named: th.DistributedOptimizer(
                th.fused_adam(1e-3), named, compression=ErrorFeedback(
                    BlockInt8Quantizer(256)), backward_passes_per_step=2))):
        jax_tx = optax.MultiSteps(spec, every_k_schedule=2)
        init = _param_tree(np.random.RandomState(5))
        p_j = {k: jnp.asarray(v) for k, v in init.items()}
        st = jax_tx.init(p_j)
        p_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
        opt = make(list(p_t.items()))
        for i, g in enumerate(grads):
            u, st = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  st, p_j)
            p_j = optax.apply_updates(p_j, u)
            for k, p in p_t.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
            for k, p in p_t.items():
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(p_j[k]), atol=1e-5)
                if i % 2 == 0:    # the first pass of a step moves nothing
                    assert p.grad is None
    with pytest.raises(TypeError):
        th.DistributedOptimizer(optax.adam(1e-3))


def hvd_fused_adam():
    """JAX's fused Adam under EF int8 (the transform MultiSteps wraps)."""
    import horovod_tpu as hvd_mod
    return hvd_mod.DistributedOptimizer(
        hvd_mod.fused_adam(1e-3),
        compression=JErrorFeedback(JBlockInt8Quantizer(256, interpret=True)))


# -- blocking ------------------------------------------------------------------

def test_to_blocks_is_a_view_when_the_leaf_fills_its_blocks():
    g = torch.randn(4, 128)
    b = _to_blocks(g, 256)
    assert b.shape == (2, 256) and b.data_ptr() == g.data_ptr()
    assert _from_blocks(b, g).data_ptr() == g.data_ptr()
    odd = torch.randn(7)
    bo = _to_blocks(odd, 4)
    assert bo.shape == (2, 4) and float(bo[1, 3]) == 0.0
    assert torch.equal(_from_blocks(bo, odd), odd)
    half = torch.randn(3, dtype=torch.bfloat16)
    assert _from_blocks(_to_blocks(half, 2), half).dtype == torch.bfloat16


# -- (iv) the slice: the tiny flagship through make_train_step ------------------

B, S, STEPS = 4, 64, 3


@pytest.fixture(scope="module")
def flagship():
    jcfg, tcfg = jax_flagship_cfg(tiny=True), _flagship_cfg(tiny=True)
    params = jax_init_params(np.random.RandomState(0), jcfg, 1)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    mesh = build_mesh(dp=1, devices=jax.devices()[:1])
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tokens=tokens,
                targets=targets, mesh=mesh)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def _jax_run(f, tx, steps):
    step = jax_make_train_step(f["jcfg"], f["mesh"], tx)
    p = shard_params(f["params"], f["jcfg"], f["mesh"])
    o = jax_init_opt_state(tx, p, f["mesh"], f["jcfg"])
    batch = shard_batch(jnp.asarray(f["tokens"]), jnp.asarray(f["targets"]),
                        f["mesh"])
    losses = []
    for _ in range(steps):
        p, o, loss, _ = step(p, o, *batch)
        losses.append(float(loss))
    return p, o, losses


def _torch_model(f, params=None):
    model = Transformer(f["tcfg"], device="cpu")
    model.load_state_dict(from_jax_params(params or f["params"]))
    return model


def _torch_batch(f):
    return (torch.from_numpy(f["tokens"]).long(),
            torch.from_numpy(f["targets"]).long())


SLICE = [
    ("adamw_ef", 1e-3,
     lambda h: optax.chain(error_feedback_transform(JBlockInt8Quantizer(256)),
                           optax.adamw(1e-3)),
     lambda model: init_opt_state(lambda ps: th.DistributedOptimizer(
         adamw(ps), compression=ErrorFeedback(BlockInt8Quantizer(256))),
         model)),
    ("fused_adam", 1e-3,
     lambda h: h.DistributedOptimizer(
         h.fused_adam(1e-3),
         compression=JErrorFeedback(JBlockInt8Quantizer(256))),
     lambda model: th.DistributedOptimizer(
         th.fused_adam(1e-3), model.named_parameters(),
         compression=ErrorFeedback(BlockInt8Quantizer(256)))),
    ("fused_sgd_mom", 0.1,
     lambda h: h.DistributedOptimizer(
         h.fused_sgd(0.1, momentum=0.9),
         compression=JErrorFeedback(JBlockInt8Quantizer(256))),
     lambda model: th.DistributedOptimizer(
         th.fused_sgd(0.1, momentum=0.9), model.named_parameters(),
         compression=ErrorFeedback(BlockInt8Quantizer(256)))),
]


@pytest.mark.parametrize("name,lr,jax_tx,torch_opt", SLICE,
                         ids=[s[0] for s in SLICE])
def test_slice_train_steps_match_jax(hvd, flagship, name, lr, jax_tx,
                                     torch_opt):
    """Losses within 1e-4 relative; the parameters within 1e-5 on at least
    99.9% of elements and within 2·lr·steps on all (the packages'
    gradients differ by about 1e-8, enough to move a code that sits on a
    rounding edge by one)."""
    f = flagship
    p_j, _, losses_j = _jax_run(f, jax_tx(hvd), STEPS)
    model = _torch_model(f)
    opt = torch_opt(model)
    step = make_train_step(f["tcfg"])
    losses_t = [float(step(model, opt, *_torch_batch(f))[2])
                for _ in range(STEPS)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    sd = model.state_dict()
    ref = _flat(jax.device_get(p_j))
    diff = np.concatenate([np.abs(sd[k].numpy() - v).ravel()
                           for k, v in ref.items()])
    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
    assert diff.max() <= 2 * lr * STEPS, diff.max()


def test_slice_resumes_from_a_jax_state(hvd, flagship):
    """Two JAX steps of fused Adam, then both packages take the third
    from the JAX parameters and optimizer state with the same gradients:
    the parameters agree within 1e-5."""
    f = flagship
    jax_tx = hvd.DistributedOptimizer(
        hvd.fused_adam(1e-3),
        compression=JErrorFeedback(JBlockInt8Quantizer(256)))
    p_j, o_j, _ = _jax_run(f, jax_tx, 2)
    params2 = jax.device_get(p_j)
    state2 = jax.device_get(o_j)
    batch = shard_batch(jnp.asarray(f["tokens"]), jnp.asarray(f["targets"]),
                        f["mesh"])
    _, _, grads = jax_make_grad_fn(f["jcfg"], f["mesh"])(p_j, *batch)
    grads = jax.device_get(grads)
    u, _ = jax_tx.update(grads, o_j, p_j)
    ref = _flat(jax.device_get(optax.apply_updates(params2, u)))

    model = _torch_model(f, params2)
    opt = th.DistributedOptimizer(
        th.fused_adam(1e-3), model.named_parameters(),
        compression=ErrorFeedback(BlockInt8Quantizer(256)))
    opt.load_jax_state(state2.count, state2.mom, state2.vel, state2.residual)
    flat_grads = _flat(grads)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(flat_grads[name].copy())
        assert opt.state[p]["count"] == 2
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-5,
                                   err_msg=name)
        assert opt.state[p]["count"] == 3


def test_load_jax_state_checks_names_and_shapes():
    p = torch.nn.Parameter(torch.zeros(300))
    opt = th.DistributedOptimizer(th.fused_sgd(0.1, momentum=0.9), [p],
                                  compression=ErrorFeedback(
                                      BlockInt8Quantizer(256)))
    with pytest.raises(ValueError, match="named_parameters"):
        opt.load_jax_state(0, {"w": np.zeros((2, 256))})
    with pytest.raises(KeyError):
        opt.load_jax_state(1, {"w": np.zeros((2, 256))}, None, None,
                           named_parameters=[("w", p)])
    with pytest.raises(ValueError, match="block size"):
        opt.load_jax_state(1, {"w": np.zeros((1, 300))}, None,
                           {"w": np.zeros((1, 300))},
                           named_parameters=[("w", p)])
    mom = np.random.RandomState(0).randn(2, 256).astype(np.float32)
    opt.load_jax_state(4, {"w": mom}, None, {"w": np.zeros((2, 256))},
                       named_parameters=[("w", p)])
    assert opt.state[p]["count"] == 4
    np.testing.assert_array_equal(opt.state[p]["mom"].numpy(), mom)


def test_fused_optimizer_state_layout_and_cpu_launches():
    """State mirrors FusedOptState (blocked fp32); a CPU step runs the
    plain versions and counts no kernel launch."""
    model = _torch_model_small()
    opt = th.DistributedOptimizer(th.fused_adam(1e-3), model.named_parameters(),
                                  compression=ErrorFeedback(Compression.int8))
    before = [fn.launches for fn in tq.LAUNCHERS]
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert [fn.launches for fn in tq.LAUNCHERS] == before
    st = opt.state[model.weight]
    assert set(st) == {"count", "mom", "vel", "residual"}
    assert st["mom"].shape == (1, 256) and st["mom"].dtype == torch.float32
    copy.deepcopy(opt)


def _torch_model_small():
    return torch.nn.Linear(10, 3)


def test_spec_to_torch_is_the_unfused_optimizer():
    ps = [torch.nn.Parameter(torch.zeros(4))]
    sgd = th.fused_sgd(0.1, momentum=0.9).to_torch(ps)
    assert isinstance(sgd, torch.optim.SGD)
    assert (sgd.defaults["lr"], sgd.defaults["momentum"]) == (0.1, 0.9)
    adam = th.fused_adam(1e-3, b1=0.8, eps=1e-6).to_torch(ps)
    assert isinstance(adam, torch.optim.Adam)
    assert adam.defaults["betas"] == (0.8, 0.999)
    assert adam.defaults["eps"] == 1e-6
