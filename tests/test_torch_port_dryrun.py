"""``horovod_tpu_torch.dryrun.dryrun_multichip`` on the CPU: one train step
per layout of the JAX dry-run table, in gloo worlds of 2, 4 and 8
processes. Each layout's loss is the JAX package's (1e-4): a dense
layout without pp equals JAX dp=1's, the pp layout of n = 8
(``{dp:2, pp:2, tp:2}``, GPipe over two microbatches) and the MoE
layouts JAX's at the same layout."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from horovod_tpu_torch.dryrun import B, S, dryrun_multichip, layouts


def _jax_loss(moe, sizes):
    """The JAX flagship's (tiny, the dry run's config) loss at a layout."""
    import dataclasses
    from __graft_entry__ import _flagship_cfg
    from horovod_tpu.models import (init_params, make_grad_fn, shard_batch,
                                    shard_params)
    from horovod_tpu.parallel.mesh import build_mesh
    cfg = _flagship_cfg(tiny=True)
    if moe:
        cfg = dataclasses.replace(cfg, n_experts=4, n_microbatches=1)
    n = int(np.prod(list(sizes.values())))
    mesh = build_mesh(**sizes, devices=jax.devices()[:n])
    params = shard_params(init_params(np.random.RandomState(0), cfg,
                                      sizes.get("pp", 1)), cfg, mesh)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, S))
    targets = np.roll(tokens, -1, 1)
    tok, tgt = shard_batch(jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(targets, jnp.int32), mesh)
    loss, _, _ = jax.jit(make_grad_fn(cfg, mesh))(params, tok, tgt)
    return float(loss)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_runs_every_pp_free_layout(n):
    """Every layout of the table runs, the pp one of n = 8 included (the
    name is from before the pipeline slice)."""
    losses = dryrun_multichip(n, device="cpu")
    assert sorted(losses) == sorted(json.dumps(s) for _, s in layouts(n))
    for moe, sizes in layouts(n):
        pp = sizes.get("pp", 1) > 1
        want = _jax_loss(moe, sizes if moe or pp else {"dp": 1})
        np.testing.assert_allclose(losses[json.dumps(sizes)], want,
                                   rtol=1e-4, err_msg=str(sizes))
