"""The port's grad guard decides on the device, as the JAX guard does: a
step whose gradients are non-finite (or over the norm cap) leaves the
parameters and the whole optimizer state as they were, and is counted and
recorded once, read one step late. A fused AdamW skips through
``found_inf``; other optimizers through the in-place select. Held against
the JAX package's ``guarded_apply`` over optax, in process on the CPU."""

import numpy as np
import optax
import pytest
import jax.numpy as jnp
import torch

from horovod_tpu.train.guard import GuardedStep as JGuardedStep
from horovod_tpu.train.guard import GuardSpec as JGuardSpec
from horovod_tpu.train.guard import guarded_apply as j_guarded_apply
from horovod_tpu_torch.diagnostics.flight_recorder import recorder
from horovod_tpu_torch.metrics.registry import default_registry
from horovod_tpu_torch.models import adamw
from horovod_tpu_torch.train.guard import (GuardedStep, GuardSpec, Verdict,
                                           guarded_apply)

STEPS = 5


def _params():
    rng = np.random.RandomState(11)
    return {"w": rng.randn(10, 30).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}


def _grads(poison):
    """Per step, a gradient tree; the steps in ``poison`` get a NaN (or a
    spike far over the cap, ``"big"``)."""
    rng = np.random.RandomState(12)
    out = []
    for i in range(STEPS):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in _params().items()}
        if i in poison:
            if poison[i] == "nan":
                g["w"][1, 2] = np.nan
            else:
                g["b"] *= 1e3
        out.append(g)
    return out


OPTIMIZERS = {
    "adamw": (lambda ps: torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=1e-4),
              lambda: optax.adamw(1e-3)),
    "adamw_fused": (adamw, lambda: optax.adamw(1e-3)),
    "sgd_momentum": (lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
                     lambda: optax.sgd(0.05, momentum=0.9)),
}
POISON = {"first": {0: "nan"}, "middle": {2: "nan", 3: "nan"},
          "norm_cap": {1: "big"}}


@pytest.fixture(autouse=True)
def fresh_observability():
    default_registry().clear()
    recorder().clear()
    yield
    default_registry().clear()
    recorder().clear()


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("poison", sorted(POISON))
def test_guarded_steps_match_jax(opt, poison):
    """Five guarded steps, some poisoned: parameters after every step equal
    the JAX guard's (skipped steps bit-equal to the step before), the
    skip count and the ``guard_skip`` events agree, and the verdicts were
    read one step late."""
    torch_factory, optax_factory = OPTIMIZERS[opt]
    max_norm = 100.0 if poison == "norm_cap" else 0.0
    grads = _grads(POISON[poison])
    tspec, jspec = GuardSpec(max_norm=max_norm), JGuardSpec(max_norm=max_norm)

    tx = optax_factory()
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    jo = tx.init(jp)

    def jfn(p, o, g, inj):
        p, o, ok = j_guarded_apply(tx, {k: jnp.asarray(v) for k, v in
                                        g.items()}, o, p, jspec)
        return p, o, 0.0, ok

    jstep = JGuardedStep(jfn, jspec, canary=None)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in _params().items()}
    topt = torch_factory(list(tparams.values()))
    verdicts = []

    def tfn(m, o, g):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        ok = guarded_apply(o, tspec)
        verdicts.append(ok)
        return m, o, 0.0, ok

    tstep = GuardedStep(tfn, tspec)
    for i, g in enumerate(grads):
        jp, jo, _ = jstep(jp, jo, g)
        tstep(None, topt, g)
        assert isinstance(verdicts[-1], Verdict)
        for k in tparams:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    jstep.flush()
    tstep.flush()
    n_skips = len(POISON[poison])
    assert tstep.skipped == jstep.observer.skipped == n_skips
    snap = default_registry().snapshot()
    assert snap["hvd_guard_skipped_steps_total"]["value"] == n_skips
    events = [(e["step"], e["consecutive"]) for e in recorder().events()
              if e["kind"] == "guard_skip"]
    steps = sorted(POISON[poison])
    assert [s for s, _ in events] == steps
    assert [bool(v) for v in verdicts] == [i not in POISON[poison]
                                           for i in range(STEPS)]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_a_skipped_step_leaves_the_whole_state(opt):
    """The optimizer state after [g0, NaN, g1] equals the state after
    [g0, g1], key by key, the step count included; a skipped first step
    leaves no state, or a fresh one (step 0, zero moments), and the run
    [NaN, g0, g1] equals [g0, g1]."""
    torch_factory, _ = OPTIMIZERS[opt]
    grads = _grads({})

    def run(seq):
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
              for v in _params().values()]
        opt_ = torch_factory(ps)
        for g in seq:
            for p, v in zip(ps, g.values()):
                p.grad = torch.from_numpy(v.copy())
            guarded_apply(opt_, GuardSpec()).settle()
        return ps, opt_

    bad = {k: np.full_like(v, np.nan) for k, v in grads[0].items()}
    _, first_skipped = run([bad])
    assert not any(torch.as_tensor(v).any()
                   for s in first_skipped.state.values() for v in s.values())
    ps_b, b = run([grads[0], grads[1]])
    for seq in ([grads[0], bad, grads[1]], [bad, grads[0], grads[1]]):
        ps_a, a = run(seq)
        for pa, pb in zip(ps_a, ps_b):
            assert torch.equal(pa, pb)
            sa, sb = a.state[pa], b.state[pb]
            assert sorted(sa) == sorted(sb)
            for key in sa:
                assert torch.equal(torch.as_tensor(sa[key]),
                                   torch.as_tensor(sb[key])), key


def test_fused_optimizer_count_is_restored():
    """FusedOptimizer keeps a Python step count and rebinds its moments:
    a skipped step puts the count back when the verdict is read."""
    from horovod_tpu_torch.train.fused_apply import FusedOptimizer, fused_adam
    from horovod_tpu_torch.compression import Compression

    def run(n_bad):
        p = torch.nn.Parameter(torch.zeros(512))
        opt = FusedOptimizer([p], fused_adam(1e-3),
                             compression=Compression.int8)
        seq = [torch.ones(512)] + [torch.full((512,), np.nan)] * n_bad \
            + [torch.ones(512) * 2]
        for g in seq:
            p.grad = g.clone()
            guarded_apply(opt, GuardSpec()).settle()
        return p, opt.state[p]

    p0, s0 = run(0)
    p1, s1 = run(2)
    assert s0["count"] == s1["count"] == 2
    assert torch.equal(p0, p1)
    assert torch.equal(s0["mom"], s1["mom"]) and torch.equal(s0["vel"],
                                                             s1["vel"])


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_fused_adamw_skips_through_found_inf(opt):
    """``models.adamw`` (fused) is handed the verdict as ``found_inf`` and
    keeps no copy of the state; the others step and select against a
    copy. Either way ``found_inf`` does not outlive the step."""
    torch_factory, _ = OPTIMIZERS[opt]
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
          for v in _params().values()]
    o = torch_factory(ps)
    for p in ps:
        p.grad = torch.ones_like(p)
    verdict = guarded_apply(o, GuardSpec())
    assert (verdict._saved is None) == (opt == "adamw_fused")
    assert not hasattr(o, "found_inf")
    assert verdict.settle()
