"""Data-parallel training in the port against the JAX package, on the CPU.

The torch side runs as gloo worlds of separate processes, started by the
tests as::

    python tests/test_torch_port_dp.py --worker <group> --out <dir>

with the launcher's identity in the environment. A worker imports no JAX:
it builds its inputs from numpy seeds, runs every case of its group, and
writes one ``<group>.rank<r>.npz``. The JAX side runs in the pytest
process on the 8-device CPU mesh, ``build_mesh(dp=2)`` over its first two
devices. Each case is its own test.

This file holds the worker of every group (``collectives`` and ``hier``
serve ``tests/test_torch_port_collectives.py``, ``init`` the isolation
test, ``metrics`` ``tests/test_torch_port_metrics.py``) and the tests of
the ``dp`` group: the overlap engine's pipelined accumulation and
trajectories (``tests/test_overlap.py``), the guard, the
eager ``DistributedOptimizer`` (plain, fp16, int8, EF, pre/postscale,
``backward_passes_per_step``), the broadcasts, the fused optimizers'
multi-device regimes (``tests/test_fused_apply.py``) and the tiny flagship
at dp=2.
"""

import os
import signal
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 150

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import log_time, spawn_world  # noqa: E402

if __name__ != "__main__":
    import functools

    import jax
    import jax.numpy as jnp
    import optax
    import pytest
    from jax.sharding import PartitionSpec as P

    from horovod_tpu._compat import shard_map


# -- the spawner ---------------------------------------------------------------

def spawn(group: str, n: int, out_dir, extra_env=None,
          timeout: float = SPAWN_TIMEOUT_S, script: str = __file__):
    """Run the worker ``group`` of ``script`` (this file by default) as a
    gloo world of ``n`` processes and return each rank's results (dicts of
    arrays); see ``tests/torch_port_worker.py``."""
    return spawn_world(script, group, n, out_dir, extra_env, timeout)


# -- inputs, from numpy seeds (both sides) -------------------------------------

def ops_input():
    return np.random.RandomState(0).randn(2, 8).astype(np.float32)


def grad_tree(rng, n):
    """``tests/test_overlap.py``'s ``_grad_tree`` with ``n`` shards."""
    return {"w": rng.randn(n, 16, 3).astype(np.float32),
            "b": rng.randn(n, 5).astype(np.float32)}


RING_SHAPES = [(13,), (4, 5), (1,)]


def ring_inputs(n):
    rng = np.random.RandomState(2)
    return [rng.randn(n, *s).astype(np.float32) for s in RING_SHAPES]


def quantized_input():
    return np.random.RandomState(3).randn(2, 1024).astype(np.float32)


# bucketed_grad_sync cases of tests/test_overlap.py:52-57 (and int8)
SYNC_CASES = {
    "one-bucket": {},
    "many-buckets": {"bucket_bytes": 64},
    "ring": {"ring": True},
    "sum": {"op": "SUM", "bucket_bytes": 128},
    "int8": {"compression": "int8", "bucket_bytes": 256},
}

HIER_TOPOLOGIES = {"2x2": (2, 2), "4x1": (4, 1)}


def linear_problem(seed, n=64, din=6, dout=4):
    """``tests/test_overlap.py``'s ``_linear_problem``."""
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(din, dout).astype(np.float32),
              "b": np.zeros((dout,), np.float32)}
    X = rng.randn(n, din).astype(np.float32)
    Y = rng.randn(n, dout).astype(np.float32)
    return params, X, Y


# pipelined accumulation cases of tests/test_overlap.py:129-135
ACCUM_CASES = {
    "fallback": {"n_micro": 1},
    "pipelined": {"n_micro": 4},
    "serialized": {"n_micro": 4, "overlap": False},
    "buckets": {"n_micro": 4, "bucket_bytes": 32},
    "ring": {"n_micro": 2, "ring": True},
}

TRAJ_CASES = {
    "base": {"n_micro": 1},
    "pipelined": {"n_micro": 4, "bucket_bytes": 64},
    "int8": {"n_micro": 4, "bucket_bytes": 64, "compression": "int8"},
}
TRAJ_STEPS = 6


def param_tree(rng):
    """``tests/test_fused_apply.py``'s shapes: 300 and 7 elements."""
    return {"w": rng.randn(10, 30).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}


EAGER_CASES = {
    "plain": {},
    "scaled": {"prescale": 0.5, "postscale": 3.0},
    "fp16": {"compression": "fp16"},
    "int8": {"compression": "int8"},
    "ef_int8": {"compression": "ef_int8"},
    "multisteps": {"k": 2},
}
EAGER_STEPS = 3
EAGER_LR = 0.1


def eager_grads(rank, passes):
    rng = np.random.RandomState(100 + rank)
    return [param_tree(rng) for _ in range(passes)]


FLAGSHIP_B, FLAGSHIP_S, FLAGSHIP_STEPS = 4, 64, 3


def metric_inputs():
    """Per-rank tensors ``[2, ...]`` of the quantized mesh path's byte
    counters (``tests/test_torch_port_metrics.py``): a block multiple, a
    2-D tensor, and a slice that pads its last block."""
    rng = np.random.RandomState(9)
    return [rng.randn(2, *s).astype(np.float32)
            for s in ((1024,), (4, 300), (518,))]


def flagship_batch(vocab):
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, vocab, (FLAGSHIP_B, FLAGSHIP_S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, 1)


# -- the workers (torch only) ---------------------------------------------------

def _dev():
    """Where a worker's tensors live: the CPU, or with ``--device cuda``
    (``HVD_TEST_DEVICE``) the rank's card, for an NCCL world."""
    import torch

    from horovod_tpu_torch import device
    return device() if os.environ.get("HVD_TEST_DEVICE") == "cuda" \
        else torch.device("cpu")


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(_dev())


def _np(t):
    """A copy: the tensor may be updated in place after it is recorded."""
    return (t.detach().float() if t.is_floating_point()
            else t.detach()).cpu().numpy().copy()


def _int8(block=256):
    from horovod_tpu_torch.compression import BlockInt8Quantizer
    return BlockInt8Quantizer(block)


def _w_collectives():
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import mesh_collectives as mc
    from horovod_tpu_torch.ops.reduce_op import ReduceOp
    from horovod_tpu_torch.train.overlap import bucketed_grad_sync

    mesh = hvd.build_mesh(dp=2)
    ax = mesh.axis("dp")
    r = ax.index
    out = {}
    x = ops_input()
    for op in ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT"):
        out[f"preduce_{op}"] = _np(mc.preduce(_t(x[r]), ax, ReduceOp[op]))
    a = np.arange(12).reshape(2, 6)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        got = mc.preduce(_t(a[r]).to(dt), ax)
        assert got.dtype == dt
        out[f"sum_{str(dt).split('.')[-1]}"] = _np(got)
    g = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    out["gather_dim0"] = _np(mc.pallgather(_t(g[r]), ax))
    out["gather_dim1"] = _np(mc.pallgather(_t(g[r]), ax, dim=1))
    out["gather_stacked"] = _np(mc.pallgather(_t(g[r]), ax, dim=1,
                                              tiled=False))
    for root in (0, 1):
        out[f"broadcast_{root}"] = _np(mc.pbroadcast(_t(x[r]), ax, root))
    a2a = np.arange(8, dtype=np.float32).reshape(2, 4, 1)
    out["alltoall"] = _np(mc.palltoall(_t(a2a[r]), ax))
    out["reduce_scatter"] = _np(mc.preduce_scatter(_t(x[r]), ax))
    out["ring_shift"] = _np(mc.pring_shift(_t(np.arange(2.0)[r:r + 1]), ax))
    xq = quantized_input()
    for op in ("SUM", "AVERAGE"):
        out[f"quantized_{op}"] = _np(mc.preduce_quantized(
            _t(xq[r]), ax, _int8(), ReduceOp[op]))
    for i, xr in enumerate(ring_inputs(2)):
        out[f"ring_{i}"] = _np(mc.pring_allreduce(_t(xr[r]), ax))
    for name, kw in SYNC_CASES.items():
        kw = dict(kw)
        if "op" in kw:
            kw["op"] = ReduceOp[kw["op"]]
        if kw.get("compression") == "int8":
            kw["compression"] = _int8()
        seed = 1 if name == "int8" else 0
        tree = grad_tree(np.random.RandomState(seed), 2)
        res = bucketed_grad_sync({k: _t(v[r]) for k, v in tree.items()}, ax,
                                 **kw)
        for k, v in res.items():
            out[f"sync_{name}_{k}"] = _np(v)
    return out


def _w_hier():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.topology import MeshTopology
    from horovod_tpu_torch.ops import mesh_collectives as mc
    from horovod_tpu_torch.ops.reduce_op import ReduceOp
    from horovod_tpu_torch.train.overlap import bucketed_grad_sync

    mesh = hvd.build_mesh(dp=4)
    ax = mesh.axis("dp")
    r = ax.index
    out = {}
    x37 = np.random.RandomState(0).randn(4, 37).astype(np.float32)
    x64 = np.random.RandomState(1).randn(4, 64).astype(np.float32)
    for tname, topo in HIER_TOPOLOGIES.items():
        topo = MeshTopology(*topo)
        for op in ("SUM", "AVERAGE"):
            out[f"hier_{tname}_{op}"] = _np(mc.phier_allreduce(
                _t(x37[r]), ax, topo, ReduceOp[op]))
            out[f"hierq_{tname}_{op}"] = _np(mc.phier_allreduce(
                _t(x64[r]), ax, topo, ReduceOp[op], inter_codec=_int8()))
    x2d = np.random.RandomState(2).randn(4, 6, 10).astype(np.float32)
    out["hier_2d"] = _np(mc.phier_allreduce(_t(x2d[r]), ax,
                                            MeshTopology(2, 2),
                                            ReduceOp.AVERAGE))
    x16 = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    out["floored"] = _np(mc.phier_allreduce(
        _t(x16[r]), ax, MeshTopology(2, 2), ReduceOp.SUM,
        inter_codec=_int8(), small_floor=1 << 30))
    out["flat_sum"] = _np(mc.preduce(_t(x16[r]), ax, ReduceOp.SUM))
    for name, seed, kw in (
            ("hier", 4, dict(algorithm="hier", bucket_bytes=128)),
            ("hier_int8", 5, dict(algorithm="hier",
                                  topology=MeshTopology(2, 2),
                                  compression=_int8())),
            ("floor", 6, dict(compression=_int8(), small_floor=1 << 30))):
        tree = grad_tree(np.random.RandomState(seed), 4)
        res = bucketed_grad_sync({k: _t(v[r]) for k, v in tree.items()}, ax,
                                 **kw)
        for k, v in res.items():
            out[f"sync_{name}_{k}"] = _np(v)
    for i, xr in enumerate(ring_inputs(4)):
        out[f"ring_{i}"] = _np(mc.pring_allreduce(_t(xr[r]), ax))
    return out


class _Params:
    """A module whose parameters are a dict of numpy arrays."""

    @staticmethod
    def make(tree):
        import torch

        class M(torch.nn.Module):
            def __init__(self):
                super().__init__()
                for k, v in tree.items():
                    setattr(self, k, torch.nn.Parameter(_t(v.copy())))
        return M()


def _lin_loss(m, batch):
    x, y = batch
    return ((x @ m.w + m.b - y) ** 2).mean()


def _w_dp_overlap(hvd, mesh, out):
    import torch

    from horovod_tpu_torch.ops.mesh_collectives import preduce
    from horovod_tpu_torch.train.overlap import pipelined_accumulate

    ax = mesh.axis("dp")
    params, X, Y = linear_problem(0)
    x, y = hvd.shard_batch(_t(X), _t(Y), mesh)
    for name, kw in ACCUM_CASES.items():
        kw = dict(kw)
        n_micro = kw.pop("n_micro")
        model = _Params.make(params)
        micro = tuple(a.reshape((n_micro, a.shape[0] // n_micro)
                                + tuple(a.shape[1:])) for a in (x, y))
        loss, grads = pipelined_accumulate(_lin_loss, model, micro, axis=ax,
                                           **kw)
        out[f"accum_{name}_loss"] = _np(preduce(loss, ax, hvd.Average))
        for k, g in grads.items():
            out[f"accum_{name}_{k}"] = _np(g)
            assert model.get_parameter(k).grad is g

    params, X, Y = linear_problem(3)
    batch = hvd.shard_batch(_t(X), _t(Y), mesh)
    for name, kw in TRAJ_CASES.items():
        kw = dict(kw)
        if kw.get("compression") == "int8":
            kw["compression"] = _int8()
        model = _Params.make(params)
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        step = hvd.make_overlap_train_step(_lin_loss, mesh, "dp", **kw)
        out[f"traj_{name}"] = np.array(
            [float(step(model, opt, batch)[2]) for _ in range(TRAJ_STEPS)])

    # the guard: a NaN in rank 0's rows poisons the synced gradient on every
    # rank; the step is skipped, then a clean one is taken
    model = _Params.make(params)
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    step = hvd.make_overlap_train_step(_lin_loss, mesh, "dp", n_micro=2)
    Xn = X.copy()
    Xn[0, 0] = np.nan
    step(model, opt, hvd.shard_batch(_t(Xn), _t(Y), mesh))
    step.flush()
    out["guard_skipped_after_nan"] = np.array(step.skipped)
    for k, p in model.named_parameters():
        out[f"guard_after_nan_{k}"] = _np(p)
    step(model, opt, batch)
    step.flush()
    out["guard_skipped_after_clean"] = np.array(step.skipped)
    for k, p in model.named_parameters():
        out[f"guard_after_clean_{k}"] = _np(p)


def _w_dp_eager(hvd, mesh, out):
    import torch

    from horovod_tpu_torch.compression import Compression, ErrorFeedback
    from horovod_tpu_torch.train import optimizer as topt

    r = hvd.rank()
    launches = []
    real_start = topt._start_eager_bucket

    def counting(*a, **kw):
        launches.append(1)
        return real_start(*a, **kw)

    topt._start_eager_bucket = counting
    comps = {"fp16": Compression.fp16, "int8": _int8(),
             "ef_int8": ErrorFeedback(_int8())}
    for name, kw in EAGER_CASES.items():
        k = kw.get("k", 1)
        model = _Params.make(param_tree(np.random.RandomState(5)))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=EAGER_LR),
            named_parameters=model.named_parameters(),
            compression=comps.get(kw.get("compression"),
                                  Compression.none),
            prescale_factor=kw.get("prescale", 1.0),
            postscale_factor=kw.get("postscale", 1.0),
            backward_passes_per_step=k)
        assert opt._hvd_hooks is not None
        per_pass = []
        for i, g in enumerate(eager_grads(r, EAGER_STEPS * k)):
            del launches[:]
            opt.zero_grad()
            # the gradient of sum(p * G) is G: backward drives the hooks
            sum((p * _t(g[n])).sum() for n, p in model.named_parameters()
                ).backward()
            per_pass.append(len(launches))
            opt.step()
            for n, p in model.named_parameters():
                out[f"eager_{name}_{i}_{n}"] = _np(p)
        out[f"eager_{name}_launches"] = np.array(per_pass)
    topt._start_eager_bucket = real_start


def _w_dp_broadcast(hvd, out):
    import torch

    r = hvd.rank()
    torch.manual_seed(10 + r)
    model = torch.nn.Linear(5, 3).to(_dev())
    out["bcast_init_weight"] = _np(model.weight)
    hvd.broadcast_parameters(model.named_parameters(), root_rank=1)
    out["bcast_weight"] = _np(model.weight)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    if r == 0:
        for _ in range(2):
            model(torch.ones(2, 5, device=_dev())).sum().backward()
            opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    st = opt.state[model.weight]
    out["opt_exp_avg"] = _np(st["exp_avg"])
    out["opt_step"] = np.array(float(st["step"]))
    out["object"] = np.array(hvd.broadcast_object({"from": r}, 1)["from"])
    out["objects"] = np.array([o["r"] for o in
                               hvd.allgather_object({"r": r * 7})])


def _w_dp_fused(hvd, mesh, out):
    import torch

    from horovod_tpu_torch.compression import ErrorFeedback

    ax = mesh.axis("dp")
    r = ax.index
    g = np.random.RandomState(7).randn(2, 64).astype(np.float32)
    for regime, axis in (("axis", ax), ("eager", None)):
        p = torch.nn.Parameter(torch.zeros(64, device=_dev()))
        opt = hvd.DistributedOptimizer(hvd.fused_sgd(1.0), [("w", p)],
                                       compression=_int8(), axis=axis)
        p.grad = _t(g[r])
        opt.step()
        out[f"fused_sgd_{regime}"] = _np(p)
    ga = np.random.RandomState(8).randn(3, 2, 300).astype(np.float32)
    for regime, axis in (("axis", ax), ("eager", None)):
        p = torch.nn.Parameter(torch.zeros(300, device=_dev()))
        opt = hvd.DistributedOptimizer(hvd.fused_adam(1e-3), [("w", p)],
                                       compression=ErrorFeedback(_int8()),
                                       axis=axis)
        for s in range(3):
            p.grad = _t(ga[s, r])
            opt.step()
        out[f"fused_adam_{regime}"] = _np(p)


def _w_dp_flagship(hvd, mesh, out):
    import torch

    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.models import (Transformer, adamw, from_jax_params,
                                          init_opt_state, init_params,
                                          lm_loss, make_grad_fn,
                                          make_train_step)

    cfg = _flagship_cfg(tiny=True)
    sd = from_jax_params(init_params(np.random.RandomState(0), cfg))
    tokens, targets = flagship_batch(cfg.vocab_size)
    local = hvd.shard_batch(_t(tokens).long(), _t(targets).long(), mesh)

    model = Transformer(cfg, device=_dev())
    model.load_state_dict(sd)
    loss, _, grads = make_grad_fn(cfg, mesh)(model, *local)
    out["flag_loss"] = _np(loss)
    for k, v in grads.items():
        out[f"flag_grad_{k}"] = _np(v)

    opt = init_opt_state(adamw, model)
    step = make_train_step(cfg, mesh)
    out["flag_losses"] = np.array(
        [float(step(model, opt, *local)[2]) for _ in range(FLAGSHIP_STEPS)])
    for k, v in model.state_dict().items():
        out[f"flag_param_{k}"] = _np(v)

    # the overlap engine on the same batch: step 1's synced gradient
    model = Transformer(cfg, device=_dev())
    model.load_state_dict(sd)
    opt = init_opt_state(adamw, model)
    ostep = hvd.make_overlap_train_step(lm_loss, mesh, "dp", n_micro=2)
    out["flag_overlap_loss"] = _np(ostep(model, opt, local)[2])
    for k, p in model.named_parameters():
        out[f"flag_overlap_grad_{k}"] = _np(p.grad)


def _w_dp():
    import horovod_tpu_torch as hvd

    mesh = hvd.build_mesh(dp=2)
    out = {}
    _w_dp_overlap(hvd, mesh, out)
    _w_dp_eager(hvd, mesh, out)
    _w_dp_broadcast(hvd, out)
    _w_dp_fused(hvd, mesh, out)
    if _dev().type == "cpu":    # the tiny flagship's head dim 16 has no kernel
        _w_dp_flagship(hvd, mesh, out)
    return out


def _w_metrics():
    """The compression byte counters of ``preduce_quantized`` (int8,
    average) per tensor of :func:`metric_inputs`, then one eager int8
    ``DistributedOptimizer`` step over :func:`param_tree` gradients: its
    byte counters and sync gauges."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.ops import mesh_collectives as mc
    from horovod_tpu_torch.ops.reduce_op import ReduceOp

    ax = hvd.build_mesh(dp=2).axis("dp")
    r = ax.index
    reg = default_registry()
    out = {}
    for i, x in enumerate(metric_inputs()):
        reg.clear()
        mc.preduce_quantized(_t(x[r]), ax, _int8(), ReduceOp.AVERAGE)
        for kind in ("pre_bytes_total", "wire_bytes_total", "ratio"):
            inst = reg.get(f"hvd_compression_{kind}", {"codec": "int8"})
            out[f"mesh{i}_{kind}"] = np.array(inst.value)
    reg.clear()
    params = {k: torch.nn.Parameter(_t(v)) for k, v in
              param_tree(np.random.RandomState(5)).items()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params.values(), lr=0.1),
                                   named_parameters=params.items(),
                                   compression=_int8())
    for k, g in param_tree(np.random.RandomState(100)).items():
        params[k].grad = _t(g)
    opt.step()
    snap = reg.snapshot()
    for key, name in (
            ('hvd_compression_pre_bytes_total{codec="int8"}',
             "eager_pre_bytes_total"),
            ('hvd_compression_wire_bytes_total{codec="int8"}',
             "eager_wire_bytes_total"),
            ("hvd_overlap_exposed_comm_seconds", "eager_exposed"),
            ("hvd_overlap_sync_seconds", "eager_sync"),
            ("hvd_overlap_bucket_count", "eager_bucket_count")):
        out[name] = np.array(snap[key]["value"])
    out["codec_events"] = np.array(sum(
        e["kind"] == "codec_choice" for e in recorder().events()))
    return out


def _w_init():
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    out = {k: np.array(getattr(hvd, k)()) for k in (
        "rank", "size", "local_rank", "local_size", "cross_rank",
        "cross_size", "is_homogeneous")}
    out["backend_is_gloo"] = np.array(dist.get_backend() == "gloo")
    out["world"] = np.array(dist.get_world_size())
    hvd.shutdown()
    out["after_shutdown"] = np.array([hvd.is_initialized(),
                                      dist.is_initialized()])
    return out


WORKERS = {"collectives": _w_collectives, "hier": _w_hier, "dp": _w_dp,
           "init": _w_init, "metrics": _w_metrics}
# results that pass through the int8 codec may differ by one code when the
# sums before it differ in the last bit (another reduction order)
_CODEC_KEYS = ("quantized", "int8", "hierq", "fused")


def _compare(run_dir: str, ref_dir: str) -> int:
    """Every array of ``run_dir``'s worker results against the same file
    of ``ref_dir`` (e.g. an NCCL run on the cards against the gloo run on
    the CPU): relative max difference, at most 1e-4, or one int8 code
    (1/127) where the codec is on the path. Prints the worst keys."""
    import glob
    worst, bad = [], []
    for path in sorted(glob.glob(os.path.join(run_dir, "*.npz"))):
        name = os.path.basename(path)
        run, ref = np.load(path), np.load(os.path.join(ref_dir, name))
        assert set(run.files) <= set(ref.files), name
        for key in run.files:
            a, b = run[key].astype(np.float64), ref[key].astype(np.float64)
            scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-30)
            rel = float(np.abs(a - b).max()) / scale if b.size else 0.0
            tol = 1.0 / 127 if any(c in key for c in _CODEC_KEYS) else 1e-4
            worst.append((rel, f"{name}:{key}"))
            if not rel <= tol:
                bad.append((rel, tol, f"{name}:{key}"))
    for rel, key in sorted(worst)[-8:]:
        print(f"compare {key} rel={rel}")
    print(f"compare arrays={len(worst)} over_tolerance={bad}")
    return 1 if bad else 0


def _worker_main(argv) -> int:
    """``--worker GROUP --out DIR``: one rank (the launcher's identity in
    the environment). ``--spawn GROUP --ranks N --out DIR [--device
    cuda]``: start the whole world (on the cards, an NCCL world of N, one
    card a rank), as the tests do, for a comparison with the gloo run."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", choices=sorted(WORKERS))
    ap.add_argument("--spawn", choices=sorted(WORKERS))
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("RUN", "REF"))
    args = ap.parse_args(argv)
    if args.compare:
        return _compare(*args.compare)
    if args.spawn:
        env = {"HVD_TEST_DEVICE": args.device,
               "HVD_TPU_GLOO_TIMEOUT_SECONDS": "60"}
        if args.spawn == "hier":
            env["HVD_TPU_VIRTUAL_HOSTS"] = "2"
        os.makedirs(args.out, exist_ok=True)
        spawn(args.spawn, args.ranks, args.out, env)
        return 0
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    log_time("imported")
    hvd.init()
    log_time("initialized")
    rank = hvd.rank()
    res = WORKERS[args.worker]()
    log_time("ran its cases")
    assert not [m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "horovod_tpu")], "a worker imported JAX"
    np.savez(os.path.join(args.out, f"{args.worker}.rank{rank}.npz"), **res)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))


# -- the tests of the dp group (JAX side in this process) ----------------------

@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    return spawn("dp", 2, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def mesh2():
    from horovod_tpu.parallel.mesh import build_mesh
    return build_mesh(dp=2, devices=jax.devices()[:2])


def _jax_lin_loss(p, batch):
    x, y = batch
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


@pytest.mark.parametrize("case", list(ACCUM_CASES))
def test_pipelined_accumulate_matches_full_batch(dp, mesh2, case):
    """tests/test_overlap.py:129-150 at dp=2: the port's bucketed,
    pipelined accumulation equals the full-batch gradient (loss 1e-5,
    grads rtol 1e-4/atol 1e-5) and the JAX engine's on the same mesh."""
    from horovod_tpu.train.overlap import pipelined_accumulate
    params, X, Y = linear_problem(0)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_loss, ref_g = jax.value_and_grad(_jax_lin_loss)(
        p, (jnp.asarray(X), jnp.asarray(Y)))
    kw = dict(ACCUM_CASES[case])
    n_micro = kw.pop("n_micro")

    @functools.partial(shard_map, mesh=mesh2,
                       in_specs=(P(), P("dp"), P("dp")),
                       out_specs=(P(), P()), check_vma=False)
    def body(p, x, y):
        mb = jax.tree_util.tree_map(
            lambda a: a.reshape((n_micro, a.shape[0] // n_micro)
                                + a.shape[1:]), (x, y))
        loss, g = pipelined_accumulate(jax.value_and_grad(_jax_lin_loss), p,
                                       mb, axis_name="dp", **kw)
        return jax.lax.pmean(loss, "dp"), g

    jloss, jg = jax.jit(body)(p, jnp.asarray(X), jnp.asarray(Y))
    for r in dp:
        assert abs(float(r[f"accum_{case}_loss"]) - float(ref_loss)) < 1e-5
        for k in ("w", "b"):
            got = r[f"accum_{case}_{k}"]
            np.testing.assert_allclose(got, np.asarray(ref_g[k]), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got, np.asarray(jg[k]), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_array_equal(dp[0][f"accum_{case}_w"],
                                  dp[1][f"accum_{case}_w"])


@pytest.fixture(scope="module")
def jax_trajectories(mesh2):
    from horovod_tpu.compression.quantizers import BlockInt8Quantizer
    from horovod_tpu.train.overlap import make_overlap_train_step
    params, X, Y = linear_problem(3)
    p0 = {k: jnp.asarray(v) for k, v in params.items()}
    batch = (jnp.asarray(X), jnp.asarray(Y))
    tx = optax.sgd(0.05)
    out = {}
    for name, kw in TRAJ_CASES.items():
        kw = dict(kw)
        if kw.get("compression") == "int8":
            kw["compression"] = BlockInt8Quantizer(256)
        step = make_overlap_train_step(_jax_lin_loss, tx, mesh2, "dp",
                                       donate=False, **kw)
        p, o, losses = dict(p0), tx.init(p0), []
        for _ in range(TRAJ_STEPS):
            p, o, loss = step(p, o, batch)
            losses.append(float(loss))
        out[name] = np.asarray(losses)
    return out


@pytest.mark.parametrize("case,rtol", [("base", 1e-5), ("pipelined", 2e-2),
                                       ("int8", 5e-2)])
def test_overlap_trajectory_matches_jax(dp, jax_trajectories, case, rtol):
    """tests/test_overlap.py:163-187: six SGD steps of the overlap engine;
    every configuration tracks the JAX engine's base (unbucketed)
    trajectory within the test's tolerance, and its own configuration
    within 1e-4 (int8: 5e-2, each package quantizes on its own)."""
    base = jax_trajectories["base"]
    own_tol = 5e-2 if case == "int8" else 1e-4
    for r in dp:
        got = r[f"traj_{case}"]
        np.testing.assert_allclose(got, base, rtol=rtol)
        np.testing.assert_allclose(got, jax_trajectories[case], rtol=own_tol)
        assert got[-1] < got[0]


def test_guard_skips_a_poisoned_step_like_jax(dp, mesh2):
    """A NaN in one rank's rows: the step is skipped on every rank with the
    parameters as they were (as the JAX guard leaves them), counted once;
    the next clean step moves them as the JAX step does."""
    from horovod_tpu.train.overlap import make_overlap_train_step
    params, X, Y = linear_problem(3)
    Xn = X.copy()
    Xn[0, 0] = np.nan
    tx = optax.sgd(0.05)
    step = make_overlap_train_step(_jax_lin_loss, tx, mesh2, "dp", n_micro=2,
                                   donate=False)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    o = tx.init(p)
    p, o, _ = step(p, o, (jnp.asarray(Xn), jnp.asarray(Y)))
    nan_p = jax.device_get(p)
    p, o, _ = step(p, o, (jnp.asarray(X), jnp.asarray(Y)))
    clean_p = jax.device_get(p)
    for r in dp:
        assert int(r["guard_skipped_after_nan"]) == 1
        assert int(r["guard_skipped_after_clean"]) == 1
        for k in ("w", "b"):
            np.testing.assert_array_equal(r[f"guard_after_nan_{k}"],
                                          params[k])
            np.testing.assert_array_equal(nan_p[k], params[k])
            np.testing.assert_allclose(r[f"guard_after_clean_{k}"],
                                       clean_p[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.0, 1.0, 30.0])
@pytest.mark.parametrize("poison", [None, "nan", "inf", "big"])
def test_guard_verdict_matches_jax(max_norm, poison):
    """grads_ok: the fp32 sum of squares, finite and under max_norm**2 when
    a cap is set, as the JAX guard decides (in process)."""
    import torch

    from horovod_tpu.train.guard import GuardSpec as JGuardSpec
    from horovod_tpu.train.guard import grads_ok as jax_grads_ok
    from horovod_tpu_torch.train.guard import GuardSpec, grads_ok
    tree = param_tree(np.random.RandomState(11))
    if poison == "nan":
        tree["w"][3, 4] = np.nan
    elif poison == "inf":
        tree["b"][2] = np.inf
    elif poison == "big":
        tree["w"] *= 1e20          # the sum of squares overflows fp32
    want = bool(jax_grads_ok({k: jnp.asarray(v) for k, v in tree.items()},
                             JGuardSpec(max_norm=max_norm)))
    got = bool(grads_ok([torch.from_numpy(v) for v in tree.values()],
                        GuardSpec(max_norm=max_norm)))
    assert got == want


def _jax_eager_reference(case):
    """A single-process JAX reconstruction of the eager multi-process sync
    of 2 ranks (``_eager_allreduce_tree``: the plain grouped allreduce, or
    ``quantized_grouped_allreduce``: each rank's contribution quantized,
    dequantized, summed in rank order, divided by n), with EF and optax
    around it; the parameters after every pass."""
    from horovod_tpu.compression.error_feedback import ef_apply, init_residual
    from horovod_tpu.compression.quantizers import BlockInt8Quantizer
    kw = EAGER_CASES[case]
    k = kw.get("k", 1)
    q = BlockInt8Quantizer(256)
    comp = kw.get("compression")
    params = {n: jnp.asarray(v) for n, v in
              param_tree(np.random.RandomState(5)).items()}
    grads = [eager_grads(r, EAGER_STEPS * k) for r in range(2)]
    tx = optax.sgd(EAGER_LR)
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    st = tx.init(params)
    res = [init_residual(params) for _ in range(2)]
    pre, post = kw.get("prescale", 1.0), kw.get("postscale", 1.0)
    history = []
    for i in range(EAGER_STEPS * k):
        per_rank = [{n: jnp.asarray(v) for n, v in grads[r][i].items()}
                    for r in range(2)]
        if comp == "ef_int8":
            for r in range(2):
                per_rank[r], res[r] = ef_apply(q, per_rank[r], res[r])
        synced = {}
        for n in params:
            vals = [g[n] * pre for g in per_rank]
            if comp in ("int8", "ef_int8"):
                parts = [q.qdq(v) for v in vals]
                out = parts[0] + parts[1]
            elif comp == "fp16":
                out = (vals[0].astype(jnp.float16)
                       + vals[1].astype(jnp.float16))
            else:
                out = vals[0] + vals[1]
            synced[n] = ((out / 2) * post).astype(jnp.float32)
        u, st = tx.update(synced, st, params)
        params = optax.apply_updates(params, u)
        history.append({n: np.asarray(v) for n, v in params.items()})
    return history


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_eager_distributed_optimizer_matches_jax(dp, case):
    """The eager multi-process ``DistributedOptimizer`` (gradients from a
    real backward, buckets launched by the hooks) against a JAX
    reconstruction of the same 2-rank sync: parameters within 1e-5 after
    every pass (fp16: 1e-3), and identical on both ranks. With
    ``backward_passes_per_step=2`` the first pass of each step launches no
    collective and leaves the parameters, as ``optax.MultiSteps`` does."""
    ref = _jax_eager_reference(case)
    tol = 1e-3 if case == "fp16" else 1e-5
    k = EAGER_CASES[case].get("k", 1)
    for r in dp:
        for i, want in enumerate(ref):
            for n, v in want.items():
                np.testing.assert_allclose(r[f"eager_{case}_{i}_{n}"], v,
                                           atol=tol, err_msg=f"{case} {i} {n}")
        # one 64 MiB bucket: one launch from the backward of the k-th pass
        launches = r[f"eager_{case}_launches"]
        assert launches.tolist() == [0 if (i + 1) % k else 1
                                     for i in range(len(ref))], launches
    for i in range(len(ref)):
        for n in ("w", "b"):
            np.testing.assert_array_equal(dp[0][f"eager_{case}_{i}_{n}"],
                                          dp[1][f"eager_{case}_{i}_{n}"])


def test_broadcasts_and_object_collectives(dp):
    """broadcast_parameters gives every rank the root's parameters,
    broadcast_optimizer_state the root's Adam state (to a rank that had
    none), and the object collectives the root's and every rank's
    objects."""
    for r in dp:
        np.testing.assert_array_equal(r["bcast_weight"],
                                      dp[1]["bcast_init_weight"])
        np.testing.assert_array_equal(r["opt_exp_avg"], dp[0]["opt_exp_avg"])
        assert float(r["opt_step"]) == 2.0
        assert int(r["object"]) == 1
        assert r["objects"].tolist() == [0, 7]
    assert not np.array_equal(dp[0]["bcast_init_weight"],
                              dp[1]["bcast_init_weight"])


def test_fused_regimes_match_jax(dp, mesh2):
    """tests/test_fused_apply.py:156-179 at dp=2: the fused SGD's axis
    regime (codes dequantized, reduced along the axis) equals the JAX
    regime and ``-mean(qdq(g_r))``; the eager regime (the quantized
    allreduce on the wire as well) matches its reconstruction; fused Adam
    with EF over three steps matches the JAX axis regime."""
    import horovod_tpu as hvd_mod
    from horovod_tpu.compression.error_feedback import ErrorFeedback
    from horovod_tpu.compression.quantizers import BlockInt8Quantizer
    codec = BlockInt8Quantizer(256, interpret=True)
    g = np.random.RandomState(7).randn(2, 64).astype(np.float32)
    ga = np.random.RandomState(8).randn(3, 2, 300).astype(np.float32)

    def axis_regime(spec, comp, grads, steps):
        tx = hvd_mod.DistributedOptimizer(spec, compression=comp,
                                          axis_name="dp")
        n = grads.shape[-1]

        @functools.partial(shard_map, mesh=mesh2,
                           in_specs=(P(), P(None, "dp")),
                           out_specs=P("dp"), check_vma=False)
        def body(p, gs):
            st = tx.init(p)
            for s in range(steps):
                u, st = tx.update({"w": gs[s, 0]}, st, p)
                p = optax.apply_updates(p, u)
            return p["w"][None]

        return np.asarray(jax.jit(body)({"w": jnp.zeros((n,))},
                                        jnp.asarray(grads)))

    sgd_axis = axis_regime(hvd_mod.fused_sgd(1.0), codec, g[None], 1)
    qdq = [np.asarray(codec.qdq(jnp.asarray(g[r]))) for r in range(2)]
    expect = -np.mean(qdq, axis=0)
    eager = -(np.asarray(codec.qdq(jnp.asarray(qdq[0])))
              + np.asarray(codec.qdq(jnp.asarray(qdq[1])))) / 2
    adam_axis = axis_regime(hvd_mod.fused_adam(1e-3), ErrorFeedback(codec),
                            ga, 3)
    for r in dp:
        np.testing.assert_allclose(r["fused_sgd_axis"], sgd_axis[0],
                                   atol=2e-5)
        np.testing.assert_allclose(r["fused_sgd_axis"], expect, atol=2e-5)
        np.testing.assert_allclose(r["fused_sgd_eager"], eager, atol=2e-5)
        np.testing.assert_allclose(r["fused_adam_axis"], adam_axis[0],
                                   atol=1e-5)
        np.testing.assert_allclose(r["fused_adam_eager"], adam_axis[0],
                                   atol=1e-3)


@pytest.fixture(scope="module")
def jax_flagship():
    from __graft_entry__ import _flagship_cfg as jax_flagship_cfg
    from horovod_tpu.models import (init_opt_state, init_params,
                                    make_grad_fn, make_train_step,
                                    shard_batch, shard_params)
    from horovod_tpu.parallel.mesh import build_mesh
    cfg = jax_flagship_cfg(tiny=True)
    params = init_params(np.random.RandomState(0), cfg, 1)
    tokens, targets = flagship_batch(cfg.vocab_size)
    out = {}
    for dp_size in (1, 2):
        mesh = build_mesh(dp=dp_size, devices=jax.devices()[:dp_size])
        batch = shard_batch(jnp.asarray(tokens), jnp.asarray(targets), mesh)
        p = shard_params(params, cfg, mesh)
        loss, _, grads = jax.jit(make_grad_fn(cfg, mesh))(p, *batch)
        out[dp_size] = dict(loss=float(loss), grads=_flat(
            jax.device_get(grads)))
    tx = optax.adamw(1e-3)
    step = make_train_step(cfg, mesh, tx)
    p = shard_params(params, cfg, mesh)
    o = init_opt_state(tx, p, mesh, cfg)
    losses = []
    for _ in range(FLAGSHIP_STEPS):
        p, o, loss, _ = step(p, o, *batch)
        losses.append(float(loss))
    out["losses"] = np.asarray(losses)
    return out


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def test_jax_dp2_gradients_are_twice_the_full_batch(jax_flagship):
    """The reference fault the port does not follow (ROADMAP Queue 3):
    the JAX flagship's dp=2 gradients are 2.0x its dp=1 (full-batch)
    gradients at an equal loss. Should either side change, this shows."""
    one, two = jax_flagship[1], jax_flagship[2]
    assert abs(one["loss"] - two["loss"]) < 1e-5
    for k, g in one["grads"].items():
        np.testing.assert_allclose(two["grads"][k], 2.0 * g, rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_flagship_dp2_gradients_are_the_full_batch_mean(dp, jax_flagship):
    """The tiny flagship at dp=2, two rows a rank: the port's gradients
    (make_grad_fn over the mesh, and the overlap engine's synced step-1
    gradient) equal JAX dp=1's full-batch gradients within 1e-4, and the
    loss JAX's."""
    one = jax_flagship[1]
    for r in dp:
        assert abs(float(r["flag_loss"]) - one["loss"]) < 1e-4
        assert abs(float(r["flag_overlap_loss"]) - one["loss"]) < 1e-4
        for k, g in one["grads"].items():
            np.testing.assert_allclose(r[f"flag_grad_{k}"], g, atol=1e-4,
                                       rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(r[f"flag_overlap_grad_{k}"], g,
                                       atol=1e-4, rtol=1e-4, err_msg=k)


def test_flagship_dp2_adamw_tracks_jax_dp2(dp, jax_flagship):
    """Three AdamW steps through ``make_train_step(cfg, mesh)``: the losses
    track JAX dp=2's within 1e-4 (AdamW hides the JAX factor up to eps),
    and both ranks hold bit-identical parameters."""
    for r in dp:
        np.testing.assert_allclose(r["flag_losses"], jax_flagship["losses"],
                                   rtol=1e-4)
        assert r["flag_losses"][-1] < r["flag_losses"][0]
    for k in [k for k in dp[0] if k.startswith("flag_param_")]:
        np.testing.assert_array_equal(dp[0][k], dp[1][k])
