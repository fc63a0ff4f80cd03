"""The port's pipeline parallelism against the JAX package, on the CPU, in
gloo worlds of 2, 4 and 8 processes.

* The array-level schedules (``pipeline_apply``, ``pipeline_1f1b_apply``,
  ``pipeline_interleaved_apply``) against ``jax.grad`` of the sequential
  model on the JAX grid cases ``(pp, dp, M, v)`` = (2, 2, 4, 2) and
  (4, 2, 8, 1): loss at 1e-5, gradients at 1e-4 / 1e-5
  (``tests/test_parallel_plan.py``); the ``dp_reducer`` seam against the
  dense mean at 1e-6.
* The composed dp x pp step (``make_pipeline_train_step``: 1F1B pp 4 M 8,
  interleaved pp 2 v 2 M 8, GPipe pp 4 M 8, on 8 ranks) against pure dp
  (its pp = 1 path, the overlap engine) and against Adam on the
  full-batch loss in JAX: losses at 1e-4 / 1e-5, parameters at 1e-3 /
  1e-4; ``restore_params`` gives the natural order back bit for bit; the
  guard's verdict is one for all stages.
* The flagship at ``{pp:2}``, ``{pp:2, tp:2}`` and MoE ``{pp:2, ep:2}``:
  the loss equals JAX's at the layout (1e-4); the gradient equals JAX's
  ``{pp:2}`` gradient (dense; the true one) or JAX ``dp=1``'s (under tp,
  where JAX's is not), or JAX's at the layout over ep (MoE), to 1e-4;
  leaves replicated over an axis are bit-identical; one AdamW step equals
  optax's on the oracle gradient.

The torch side runs as ``python tests/test_torch_port_pipeline.py
--worker world<n> --out DIR``, importing no JAX.
"""

import dataclasses
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import spawn_world, worker_main  # noqa: E402

if __name__ != "__main__":
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp
    import optax
    import pytest

AXES = ("dp", "pp", "ep", "sp", "tp")
H = 8                     # the grid model's width
GRID = {4: (2, 2, 4, 2), 8: (4, 2, 8, 1)}           # world -> (pp, dp, M, v)
FLAGSHIP = {2: [(False, {"pp": 2})],
            4: [(False, {"pp": 2, "tp": 2}), (True, {"pp": 2, "ep": 2})]}
FLAGSHIP_LAYOUTS = [(n, i, moe, sizes) for n, ls in FLAGSHIP.items()
                    for i, (moe, sizes) in enumerate(ls)]
B, S = 8, 32
TRAJ_L, TRAJ_D, TRAJ_STEPS, TRAJ_LR = 8, 16, 6, 1e-2
COMPOSED = [("1f1b", 4, 8, 1), ("interleaved", 2, 8, 2), ("gpipe", 4, 8, 1)]


# -- inputs, from numpy seeds (both sides) -------------------------------------

def grid_inputs(pp, M, v):
    """The JAX grid case's stages (``V = pp·v``), batch and targets."""
    V, T = pp * v, M * 4
    rng = np.random.RandomState(7)
    stages = [{"w": (rng.randn(H, H) * 0.4).astype(np.float32),
               "b": (rng.randn(H) * 0.1).astype(np.float32)}
              for _ in range(V)]
    x = rng.randn(T, H).astype(np.float32)
    tgt = rng.randn(T, H).astype(np.float32)
    return ({k: np.stack([s[k] for s in stages]) for k in ("b", "w")}, x,
            tgt)


def traj_inputs():
    """The layer-major model of the composed-step test."""
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(TRAJ_L, TRAJ_D, TRAJ_D) * 0.4).astype(
        np.float32),
              "b": (rng.randn(TRAJ_L, TRAJ_D) * 0.1).astype(np.float32)}
    x = rng.randn(64, TRAJ_D).astype(np.float32)
    tgt = rng.randn(64, TRAJ_D).astype(np.float32)
    return params, x, tgt


def flagship_batch(vocab):
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, vocab, (B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, 1)


def torch_cfg(moe):
    from horovod_tpu_torch.entry import _flagship_cfg
    cfg = _flagship_cfg(tiny=True)
    return dataclasses.replace(cfg, n_experts=4) if moe else cfg


# -- the worker (torch only) ---------------------------------------------------

def _t_stage(p, x):
    import torch
    return torch.tanh(x @ p["w"] + p["b"])


def _t_mse(y, t):
    return ((y - t) ** 2).mean()


def _w_grid(out, pp, dp, M, v):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.pipeline import (
        pipeline_1f1b_apply, pipeline_apply, pipeline_interleaved_apply)
    stacked, x, tgt = grid_inputs(pp, M, v)
    mesh = hvd.build_mesh(dp=dp, pp=pp)
    tp = {k: torch.from_numpy(a) for k, a in stacked.items()}
    x, tgt = torch.from_numpy(x), torch.from_numpy(tgt)
    loss, g = pipeline_interleaved_apply(_t_stage, _t_mse, tp, x, tgt, mesh,
                                         n_microbatches=M, virtual_stages=v)
    out["inter_loss"] = loss.numpy()
    for k, a in g.items():
        out[f"inter_grad_{k}"] = a.numpy()
    # 1F1B and GPipe on the first pp stages of the same draw
    first = {k: a[:pp].clone() for k, a in tp.items()}
    loss, g = pipeline_1f1b_apply(_t_stage, _t_mse, first, x, tgt, mesh,
                                  n_microbatches=M)
    out["1f1b_loss"] = loss.numpy()
    for k, a in g.items():
        out[f"1f1b_grad_{k}"] = a.numpy()
    # GPipe: outputs replicated over pp, gradients by loss.backward()
    leaves = {k: a.clone().requires_grad_() for k, a in first.items()}
    y = pipeline_apply(_t_stage, leaves, x, mesh, n_microbatches=M)
    xm = x.reshape(M, -1, H)
    n = xm.shape[1] // dp
    rows = tgt.reshape(M, -1, H)[:, mesh.axis("dp").index * n:][:, :n]
    gl = _t_mse(y, rows.reshape(-1, H))
    gl.backward()
    out["gpipe_y"] = y.detach().numpy()
    out["gpipe_loss"] = gl.detach().numpy()
    idx = mesh.axis("pp").index
    for k, a in leaves.items():
        # the mean over dp of this rank's stage row
        from horovod_tpu_torch.ops.mesh_collectives import preduce
        out[f"gpipe_grad_{k}"] = preduce(a.grad[idx:idx + 1], mesh.axis("dp"),
                                         hvd.Average).numpy()
    out["coords_pp"] = np.array(idx)
    out["coords_dp"] = np.array(mesh.axis("dp").index)


def _w_reducer(out):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.pipeline import pipeline_1f1b_apply
    pp, dp, M = 2, 4, 4
    rng = np.random.RandomState(3)
    stages = [{"w": (rng.randn(8, 8) * 0.4).astype(np.float32),
               "b": (rng.randn(8) * 0.1).astype(np.float32)}
              for _ in range(pp)]
    stacked = {k: torch.from_numpy(np.stack([s[k] for s in stages]))
               for k in ("b", "w")}
    x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    tgt = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    mesh = hvd.build_mesh(dp=dp, pp=pp)
    dense_loss, dense_g = pipeline_1f1b_apply(_t_stage, _t_mse, stacked, x,
                                              tgt, mesh, n_microbatches=M)

    def reducer(grads):
        return hvd.bucketed_grad_sync(grads, mesh.axis("dp"), bucket_bytes=64)

    loss, g = pipeline_1f1b_apply(_t_stage, _t_mse, stacked, x, tgt, mesh,
                                  n_microbatches=M, dp_reducer=reducer)
    out["red_dense_loss"], out["red_loss"] = dense_loss.numpy(), loss.numpy()
    for k in g:
        out[f"red_dense_grad_{k}"] = dense_g[k].numpy()
        out[f"red_grad_{k}"] = g[k].numpy()


def _w_composed(out):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.train.pipeline import make_pipeline_train_step
    params, x, tgt = traj_inputs()

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    for label, (schedule, pp, M, v) in [("pure", ("1f1b", 1, 8, 1))] + [
            (f"c{i}", c) for i, c in enumerate(COMPOSED)]:
        mesh = hvd.build_mesh(dp=hvd.size() // pp, pp=pp)
        step = make_pipeline_train_step(
            layer_fn, _t_mse, n_layers=TRAJ_L, mesh=mesh, schedule=schedule,
            pp=pp, n_micro=M, virtual_stages=v, device="cpu", guard=False)
        p = step.prepare_params(params)
        back = step.restore_params(p)
        out[f"{label}_roundtrip"] = np.array(all(
            np.array_equal(back[k].numpy(), params[k]) for k in params))
        opt = torch.optim.Adam(p.parameters(), lr=TRAJ_LR)
        n = x.shape[0] // mesh.shape["dp"]
        rows = slice(mesh.axis("dp").index * n, (mesh.axis("dp").index + 1)
                     * n)
        batch = (torch.from_numpy(x[rows]), torch.from_numpy(tgt[rows]))
        losses = []
        for _ in range(TRAJ_STEPS):
            p, opt, loss = step(p, opt, batch)
            losses.append(float(loss))
        out[f"{label}_losses"] = np.array(losses)
        for k, a in step.restore_params(p).items():
            out[f"{label}_param_{k}"] = a.numpy()


def _w_guard(out):
    """pp 2 x dp 1: a norm cap between the larger stage's squared norm and
    the two stages' sum skips the step on both stages; a cap above the sum
    applies it on both."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.train.guard import GuardSpec
    from horovod_tpu_torch.train.pipeline import make_pipeline_train_step
    params, x, tgt = traj_inputs()

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    mesh = hvd.build_mesh(dp=1, pp=2)
    batch = (torch.from_numpy(x), torch.from_numpy(tgt))
    probe = make_pipeline_train_step(layer_fn, _t_mse, n_layers=TRAJ_L,
                                     mesh=mesh, pp=2, n_micro=4,
                                     device="cpu", guard=False)
    p = probe.prepare_params(params)
    probe(p, torch.optim.SGD(p.parameters(), lr=0.0), batch)
    sq = torch.stack([sum(q.grad.double().square().sum()
                          for q in p.parameters())])
    sqs = [torch.zeros_like(sq) for _ in range(2)]
    torch.distributed.all_gather(sqs, sq)
    sqs = [float(s) for s in sqs]
    out["stage_sq"] = np.array(sqs)
    for label, cap in (("skip", (max(sqs) + sum(sqs)) / 2),
                       ("apply", 2 * sum(sqs))):
        step = make_pipeline_train_step(
            layer_fn, _t_mse, n_layers=TRAJ_L, mesh=mesh, pp=2, n_micro=4,
            device="cpu", guard=GuardSpec(True, cap ** 0.5))
        p = step.prepare_params(params)
        opt = torch.optim.SGD(p.parameters(), lr=0.1)
        step(p, opt, batch)
        step.flush()
        out[f"{label}_skipped"] = np.array(step.skipped)
        out[f"{label}_changed"] = np.array(any(
            not np.array_equal(a.numpy(), params[k])
            for k, a in step.restore_params(p).items()))


def _w_replicate(out):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.autograd_collectives import \
        replicate_from_stage
    mesh = hvd.build_mesh(dp=1, pp=4)
    pp = mesh.axis("pp")
    w = torch.from_numpy(np.random.RandomState(0).randn(4).astype(
        np.float32))[pp.index].clone().requires_grad_()
    val = w * 2.0 if pp.index == 3 else w
    (replicate_from_stage(val, pp, 3) ** 2).backward()
    out["rep_grad"] = w.grad.numpy()


def _w_flagship(out, n):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          init_params, make_grad_fn,
                                          make_train_step, shard_params)
    for i, (moe, sizes) in enumerate(FLAGSHIP[n]):
        cfg = torch_cfg(moe)
        mesh = hvd.build_mesh(**sizes)
        sd = shard_params(init_params(np.random.RandomState(0), cfg), cfg,
                          mesh)
        tokens, targets = flagship_batch(cfg.vocab_size)
        tok, tgt = hvd.shard_batch(torch.from_numpy(tokens).long(),
                                   torch.from_numpy(targets).long(), mesh)
        model = Transformer(cfg, "cpu", mesh)
        model.load_state_dict(sd)
        loss, aux, grads = make_grad_fn(cfg, mesh)(model, tok, tgt)
        out[f"F{i}_loss"] = loss.numpy().copy()
        out[f"F{i}_aux"] = aux.numpy().copy()
        for k, g in grads.items():
            out[f"F{i}_grad_{k}"] = g.numpy().copy()
        opt = init_opt_state(adamw, model)
        _, _, step_loss, _ = make_train_step(cfg, mesh)(model, opt, tok, tgt)
        out[f"F{i}_step_loss"] = step_loss.numpy().copy()
        for k, p in model.state_dict().items():
            out[f"F{i}_param_{k}"] = p.numpy().copy()


def _w_moe_pp2():
    """The tiny MoE flagship on ``{pp:2}``: its stage shards' shapes and
    one AdamW step of ``make_train_step``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          init_params, make_train_step,
                                          shard_params)
    cfg = torch_cfg(True)
    mesh = hvd.build_mesh(pp=2)
    model = Transformer(cfg, "cpu", mesh)
    shapes = {f"shape_{k}": np.array(p.shape) for k, p in
              model.state_dict().items()}
    model.load_state_dict(shard_params(init_params(np.random.RandomState(0),
                                                   cfg), cfg, mesh))
    tokens, targets = flagship_batch(cfg.vocab_size)
    tok, tgt = torch.from_numpy(tokens).long(), torch.from_numpy(
        targets).long()
    opt = init_opt_state(adamw, model)
    step = make_train_step(cfg, mesh)
    losses = [float(step(model, opt, tok, tgt)[2]) for _ in range(2)]
    return {"rank": np.array(hvd.rank()), "losses": np.array(losses),
            **shapes}


def _w_world(n):
    import horovod_tpu_torch as hvd
    out = {"rank": np.array(hvd.rank())}
    if n in GRID:
        _w_grid(out, *GRID[n])
    if n in FLAGSHIP:
        _w_flagship(out, n)
    if n == 2:
        _w_guard(out)
    if n == 4:
        _w_replicate(out)
    if n == 8:
        _w_reducer(out)
        _w_composed(out)
    return out


if __name__ == "__main__":
    sys.exit(worker_main({"moe_pp2": _w_moe_pp2,
                          **{f"world{n}": functools.partial(_w_world, n)
                             for n in (2, 4, 8)}}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: spawn_world(__file__, f"world{n}", n,
                           tmp_path_factory.mktemp(f"world{n}"), timeout=240)
            for n in (2, 4, 8)}


def _j_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _j_mse(y, t):
    return jnp.mean((y - t) ** 2)


@functools.lru_cache(maxsize=None)
def jax_grid(pp, M, v, stages):
    """``jax.grad`` of the sequential model over the first ``stages``
    stages of the grid draw: (loss, {leaf: [stages, ...]})."""
    stacked, x, tgt = grid_inputs(pp, M, v)
    stacked = {k: jnp.asarray(a[:stages]) for k, a in stacked.items()}
    T = x.shape[0]

    def oracle(pl):
        xm = jnp.asarray(x).reshape(M, T // M, H)
        tm = jnp.asarray(tgt).reshape(M, T // M, H)

        def one_mb(xb, tb):
            h = xb
            for s in range(stages):
                h = _j_stage(jax.tree_util.tree_map(lambda p, s=s: p[s], pl),
                             h)
            return _j_mse(h, tb)
        return jax.vmap(one_mb)(xm, tm).mean()

    loss, g = jax.value_and_grad(oracle)(stacked)
    return float(loss), {k: np.asarray(a) for k, a in g.items()}


def _own_rows(full, pp, v, pp_index):
    """This rank's chunks of a stacked ``[v·pp, ...]`` leaf: stage
    ``j·pp + pp_index`` for each chunk ``j``."""
    return np.stack([full[j * pp + pp_index] for j in range(v)])


@pytest.mark.parametrize("n", sorted(GRID), ids=lambda n: "pp%d-dp%d-M%d-v%d"
                         % GRID[n])
def test_interleaved_matches_jax_grad(worlds, n):
    """``pipeline_interleaved_apply`` on every rank: the mean loss at
    1e-5, this rank's chunks of the gradient at 1e-4 / 1e-5."""
    pp, dp, M, v = GRID[n]
    loss, g = jax_grid(pp, M, v, pp * v)
    for res in worlds[n]:
        np.testing.assert_allclose(res["inter_loss"], loss, rtol=1e-5)
        for k, full in g.items():
            np.testing.assert_allclose(
                res[f"inter_grad_{k}"],
                _own_rows(full, pp, v, int(res["coords_pp"])),
                rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n", sorted(GRID), ids=lambda n: "pp%d-dp%d-M%d"
                         % GRID[n][:3])
def test_1f1b_matches_jax_grad(worlds, n):
    """``pipeline_1f1b_apply`` on the first pp stages: loss 1e-5, this
    rank's stage of the gradient 1e-4 / 1e-5."""
    pp, dp, M, v = GRID[n]
    loss, g = jax_grid(pp, M, v, pp)
    for res in worlds[n]:
        np.testing.assert_allclose(res["1f1b_loss"], loss, rtol=1e-5)
        for k, full in g.items():
            np.testing.assert_allclose(
                res[f"1f1b_grad_{k}"],
                _own_rows(full, pp, 1, int(res["coords_pp"])),
                rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n", sorted(GRID), ids=lambda n: "pp%d-dp%d-M%d"
                         % GRID[n][:3])
def test_gpipe_apply_matches_jax(worlds, n):
    """``pipeline_apply`` (GPipe): every rank's output rows are the
    sequential model's on its dp block; ``loss.backward()`` on each rank
    of the pipeline gives its stage the true gradient (mean over dp), not
    pp times it."""
    pp, dp, M, v = GRID[n]
    stacked, x, tgt = grid_inputs(pp, M, v)
    h = jnp.asarray(x)
    for s in range(pp):
        h = _j_stage({k: jnp.asarray(a[s]) for k, a in stacked.items()}, h)
    ym = np.asarray(h).reshape(M, -1, H)
    _, g = jax_grid(pp, M, v, pp)
    for res in worlds[n]:
        d, q = int(res["coords_dp"]), int(res["coords_pp"])
        n_rows = ym.shape[1] // dp
        want = ym[:, d * n_rows:(d + 1) * n_rows].reshape(-1, H)
        np.testing.assert_allclose(res["gpipe_y"], want, rtol=1e-5,
                                   atol=1e-6)
        for k, full in g.items():
            np.testing.assert_allclose(res[f"gpipe_grad_{k}"], full[q:q + 1],
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_dp_reducer_seam_matches_dense_pmean(worlds):
    """Routed through the bucketed sync (64-byte buckets), the 1F1B
    gradients equal the dense pmean's (1e-6)."""
    for res in worlds[8]:
        np.testing.assert_allclose(res["red_loss"], res["red_dense_loss"],
                                   rtol=1e-6)
        for k in ("b", "w"):
            np.testing.assert_allclose(res[f"red_grad_{k}"],
                                       res[f"red_dense_grad_{k}"],
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@functools.lru_cache(maxsize=None)
def jax_pure_dp_trajectory():
    """Adam(1e-2) on the full-batch loss of the sequential model: what
    pure dp computes (every microbatch and replica the same size)."""
    params, x, tgt = traj_inputs()
    tx = optax.adam(TRAJ_LR)
    p = {k: jnp.asarray(a) for k, a in params.items()}

    def loss_fn(p):
        h = jnp.asarray(x)
        for i in range(TRAJ_L):
            h = jnp.tanh(h @ p["w"][i] + p["b"][i])
        return _j_mse(h, jnp.asarray(tgt))

    s = tx.init(p)
    losses = []
    for _ in range(TRAJ_STEPS):
        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        p = optax.apply_updates(p, u)
        losses.append(float(loss))
    return losses, {k: np.asarray(a) for k, a in p.items()}


@pytest.mark.parametrize("case", range(len(COMPOSED)),
                         ids=["%s-pp%d-M%d-v%d" % c for c in COMPOSED])
def test_composed_dp_pp_matches_pure_dp_trajectory(worlds, case):
    """The composed dp x pp step's 6-step loss trajectory and final
    parameters (gathered, natural order) equal pure dp's (the pp = 1
    overlap engine) and JAX's full-batch Adam: losses 1e-4 / 1e-5,
    parameters 1e-3 / 1e-4."""
    ref_losses, ref_p = jax_pure_dp_trajectory()
    for res in worlds[8]:
        np.testing.assert_allclose(res["pure_losses"], ref_losses, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res[f"c{case}_losses"],
                                   res["pure_losses"], rtol=1e-4, atol=1e-5)
        for k in ("b", "w"):
            np.testing.assert_allclose(res[f"c{case}_param_{k}"],
                                       res[f"pure_param_{k}"], rtol=1e-3,
                                       atol=1e-4, err_msg=k)
            np.testing.assert_allclose(res[f"c{case}_param_{k}"], ref_p[k],
                                       rtol=1e-3, atol=1e-4, err_msg=k)
        assert res[f"c{case}_roundtrip"]


def test_composed_guard_decides_for_every_stage(worlds):
    """A norm cap between the larger stage's squared norm and the sum over
    stages skips the step on both stages (a verdict from one stage's norm
    alone would apply it on one); a cap above the sum applies it on both."""
    ranks = worlds[2]
    sq = ranks[0]["stage_sq"]
    assert max(sq) < (max(sq) + sum(sq)) / 2 < sum(sq)
    for res in ranks:
        assert int(res["skip_skipped"]) == 1 and not res["skip_changed"]
        assert int(res["apply_skipped"]) == 0 and res["apply_changed"]


def test_replicate_from_stage_counts_the_source_once(worlds):
    """Differentiated on every rank of pp = 4, a loss replicated from stage
    3 gives stage 3 the gradient of (2w)² once (8w) and the others 0."""
    w = np.random.RandomState(0).randn(4).astype(np.float32)
    grads = [float(res["rep_grad"]) for res in worlds[4]]
    np.testing.assert_allclose(grads[3], 8.0 * w[3], rtol=1e-6)
    np.testing.assert_allclose(grads[:3], 0.0, atol=1e-7)


# -- the flagship over pp ------------------------------------------------------

def jax_cfg(moe):
    from __graft_entry__ import _flagship_cfg
    cfg = _flagship_cfg(tiny=True)
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
    """The JAX flagship's (loss, aux, flat grads) at a layout, with the
    layers in ``[pp, L/pp, ...]``."""
    from horovod_tpu.models import (init_params, make_grad_fn, shard_batch,
                                    shard_params)
    from horovod_tpu.parallel.mesh import build_mesh
    sizes = dict(sizes)
    n = int(np.prod(list(sizes.values())))
    cfg = jax_cfg(moe)
    mesh = build_mesh(**sizes, devices=jax.devices()[:n])
    params = shard_params(init_params(np.random.RandomState(0), cfg,
                                      sizes.get("pp", 1)), cfg, mesh)
    tokens, targets = flagship_batch(cfg.vocab_size)
    tok, tgt = shard_batch(jnp.asarray(tokens), jnp.asarray(targets), mesh)
    loss, aux, grads = jax.jit(make_grad_fn(cfg, mesh))(params, tok, tgt)
    return float(loss), float(aux), _flat(jax.device_get(grads))


def _key(sizes):
    return tuple(sorted(sizes.items()))


def _stages(tree, pp):
    """Layer leaves of any stage layout viewed as ``[pp, L/pp, ...]``."""
    out = {}
    for k, v in tree.items():
        if k.startswith("layers."):
            v = v.reshape((pp, -1) + v.shape[2:])
        out[k] = v
    return out


def oracle(moe, sizes):
    """The true gradient of the layout's loss, as a full tree: JAX's at
    ``{pp:2}`` for a dense layout without tp, JAX ``dp=1``'s under tp, and
    JAX's at the layout over ep for MoE."""
    pp = sizes["pp"]
    if moe:
        _, _, g = jax_layout(True, _key(sizes))
        div = np.prod([sizes.get(a, 1) for a in ("dp", "ep", "sp")])
        return _stages({k: v / div for k, v in g.items()}, pp)
    if sizes.get("tp", 1) > 1:
        return _stages(jax_layout(False, (("dp", 1),))[2], pp)
    return _stages(jax_layout(False, _key(sizes))[2], pp)


def _coords(rank, sizes):
    shape = [sizes.get(a, 1) for a in AXES]
    return dict(zip(AXES, np.unravel_index(rank, shape)))


def _slice(full, key, moe, sizes, coords):
    from horovod_tpu_torch.models import param_shardings
    mesh = SimpleNamespace(shape={a: sizes.get(a, 1) for a in AXES})
    out = full
    for d, a in param_shardings(torch_cfg(moe), mesh)[key].items():
        n = out.shape[d] // sizes[a]
        out = np.take(out, range(coords[a] * n, (coords[a] + 1) * n), axis=d)
    return out


def _ranks(worlds, layout):
    n, i, moe, sizes = layout
    return [(r, {k[len(f"F{i}_"):]: v for k, v in res.items()
                 if k.startswith(f"F{i}_")}) for r, res in enumerate(worlds[n])]


def _ids(layout):
    return ",".join(f"{k}{v}" for k, v in layout[3].items()) + (
        "-moe" if layout[2] else "")


@pytest.mark.parametrize("layout", FLAGSHIP_LAYOUTS, ids=_ids)
def test_flagship_pp_loss_matches_jax(worlds, layout):
    """Every rank of every stage reports the layout's loss and aux, JAX's
    at the same layout (1e-4)."""
    _, _, moe, sizes = layout
    loss, aux, _ = jax_layout(moe, _key(sizes))
    for r, res in _ranks(worlds, layout):
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-4)
        np.testing.assert_allclose(res["aux"], aux, rtol=1e-4, atol=1e-7)
        assert res["step_loss"] == res["loss"]


@pytest.mark.parametrize("layout", FLAGSHIP_LAYOUTS, ids=_ids)
def test_flagship_pp_gradients_are_the_true_gradient(worlds, layout):
    """Each rank's gradient is its slice of the true gradient (1e-4 rel
    L2 per leaf, 1e-4 per element): the stage leaves not scaled by pp,
    the embedding and ``ln_f`` summed over the stages."""
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


@pytest.mark.parametrize("layout", FLAGSHIP_LAYOUTS, ids=_ids)
def test_flagship_pp_replicated_leaves_are_bit_identical(worlds, layout):
    """Ranks holding the same block of a leaf (the embedding and ``ln_f``
    on every stage; a stage's layers on its tp/ep replicas) hold
    bit-identical gradients and, after the AdamW step, parameters."""
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
        for members in groups.values():
            for res in members[1:]:
                for what in ("grad", "param"):
                    np.testing.assert_array_equal(
                        res[f"{what}_{k}"], members[0][f"{what}_{k}"],
                        err_msg=f"{what} {k}")


@pytest.mark.parametrize("layout", FLAGSHIP_LAYOUTS, ids=_ids)
def test_flagship_pp_adamw_step_matches_optax(worlds, layout):
    """One ``make_train_step`` AdamW step on each rank's stage equals
    ``optax.adamw(1e-3)`` on the oracle gradient, sliced (1e-4)."""
    from horovod_tpu.models import init_params
    _, _, moe, sizes = layout
    grads = oracle(moe, sizes)
    params = _stages(_flat(init_params(np.random.RandomState(0),
                                       jax_cfg(moe), 1)), sizes["pp"])
    tx = optax.adamw(1e-3)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    u, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                     tx.init(p), p)
    want = {k: np.asarray(v) for k, v in optax.apply_updates(p, u).items()}
    for r, res in _ranks(worlds, layout):
        c = _coords(r, sizes)
        for k, full in want.items():
            np.testing.assert_allclose(res[f"param_{k}"],
                                       _slice(full, k, moe, sizes, c),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
