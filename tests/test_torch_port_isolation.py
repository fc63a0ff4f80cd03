"""The port stands alone: importing any module of horovod_tpu_torch loads
neither jax nor horovod_tpu, no source of the port (nor chip_smoke.py)
imports them, and no entry point drifts onto the CPU without being asked."""

import os
import re
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch
from horovod_tpu_torch.entry import _flagship_cfg, entry
from horovod_tpu_torch.models import Transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|optax|flax|ml_dtypes|horovod_tpu)"
    r"(?:[.\s]|$)",
    re.M)


def _port_sources():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return [os.path.join(REPO, "chip_smoke.py")] + sorted(out)


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, importlib, sys, horovod_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'ml_dtypes', 'horovod_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 8 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# the observability modules of the exporter, watchdog and timeline slice
OBSERVABILITY = ("common.timeline", "diagnostics.clock",
                 "diagnostics.merge", "diagnostics.watchdog",
                 "diagnostics.autopsy", "diagnostics.__main__",
                 "metrics.exporter", "metrics.fleet", "metrics.__main__",
                 "tracing.reader")


def test_observability_modules_are_covered():
    """Every module of the exporter, watchdog and timeline slice is a
    source the checks above read and a module the import walk loads."""
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(
        horovod_tpu_torch.__path__, "horovod_tpu_torch.")}
    srcs = set(_port_sources())
    for mod in OBSERVABILITY:
        assert "horovod_tpu_torch." + mod in walked, mod
        assert os.path.join(PKG, *mod.split(".")) + ".py" in srcs, mod


def test_sources_import_nothing_of_jax():
    srcs = _port_sources()
    assert len(srcs) >= 9 and os.path.exists(srcs[0])
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert not _FORBIDDEN.search(text), path
        assert "horovod_tpu." not in text, path


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import jax.numpy",
                "  from horovod_tpu.ops import x", "import horovod_tpu",
                "import ml_dtypes", "    import ml_dtypes  # bf16"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import horovod_tpu_torch", "from horovod_tpu_torch import x",
               "# the jax package"):
        assert not _FORBIDDEN.search(ok), ok


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")


def test_entry_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(tiny=True)


def test_model_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        Transformer(_flagship_cfg(tiny=True))


def test_device_helper_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        horovod_tpu_torch.device()


def test_identity_from_env(monkeypatch):
    from horovod_tpu_torch.common import basics
    horovod_tpu_torch.shutdown()
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "3")
    monkeypatch.setenv("HVD_TPU_LOCAL_RANK", "2")   # HVD_TPU_* wins
    monkeypatch.setenv("HOROVOD_SIZE", "1")
    try:
        with pytest.raises(basics.NotInitializedError):
            horovod_tpu_torch.rank()
        horovod_tpu_torch.init()
        assert horovod_tpu_torch.is_initialized()
        assert (horovod_tpu_torch.rank(), horovod_tpu_torch.size()) == (0, 1)
        assert horovod_tpu_torch.local_rank() == 2
        assert horovod_tpu_torch.local_size() == 1
    finally:
        horovod_tpu_torch.shutdown()


def test_two_process_gloo_world_initializes_and_shuts_down(tmp_path):
    """A launched world of 2 (the ``init`` worker of
    tests/test_torch_port_dp.py, gloo on the CPU) starts its process group
    with each rank's identity, cross values included, and shuts down
    clean."""
    from test_torch_port_dp import spawn
    ranks = spawn("init", 2, tmp_path)
    for r, res in enumerate(ranks):
        assert (int(res["rank"]), int(res["size"])) == (r, 2)
        assert (int(res["local_rank"]), int(res["local_size"])) == (r, 2)
        assert (int(res["cross_rank"]), int(res["cross_size"])) == (0, 1)
        assert bool(res["is_homogeneous"]) and bool(res["backend_is_gloo"])
        assert int(res["world"]) == 2
        assert res["after_shutdown"].tolist() == [False, False]


def test_world_of_one_starts_a_group_and_needs_no_rendezvous(monkeypatch):
    import torch.distributed as dist
    horovod_tpu_torch.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    try:
        horovod_tpu_torch.init()
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert (horovod_tpu_torch.cross_rank(),
                horovod_tpu_torch.cross_size()) == (0, 1)
        assert horovod_tpu_torch.is_homogeneous()
    finally:
        horovod_tpu_torch.shutdown()
    assert not dist.is_initialized()


def test_init_refuses_a_world_it_cannot_form(monkeypatch):
    horovod_tpu_torch.shutdown()
    monkeypatch.setenv("HVD_TPU_SIZE", "2")
    for k in ("HVD_TPU_RENDEZVOUS_ADDR", "HOROVOD_RENDEZVOUS_ADDR",
              "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HVD_TPU_RENDEZVOUS_PORT",
              "HOROVOD_RENDEZVOUS_PORT", "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="rendezvous"):
        horovod_tpu_torch.init()
    monkeypatch.setenv("HVD_TPU_RANK", "2")
    with pytest.raises(ValueError, match="outside"):
        horovod_tpu_torch.init()
    monkeypatch.setenv("HVD_TPU_RANK", "0")
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "MPI")
    with pytest.raises(ValueError, match="NCCL or GLOO"):
        horovod_tpu_torch.init()
    assert not horovod_tpu_torch.is_initialized()


def test_nccl_without_a_card_raises(no_cuda, monkeypatch):
    horovod_tpu_torch.shutdown()
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "NCCL")
    with pytest.raises(RuntimeError, match="CUDA"):
        horovod_tpu_torch.init()


def test_new_modules_import_and_export():
    from horovod_tpu_torch.common import config, process_sets, topology
    from horovod_tpu_torch.compression import Compression, ErrorFeedback
    from horovod_tpu_torch.ops import mesh_collectives, quantize, reduce_op
    from horovod_tpu_torch.parallel import mesh
    from horovod_tpu_torch.train import (buckets, fused_apply, guard,
                                         optimizer, overlap)
    assert horovod_tpu_torch.Compression is Compression
    assert horovod_tpu_torch.ErrorFeedback is ErrorFeedback
    assert horovod_tpu_torch.DistributedOptimizer is \
        optimizer.DistributedOptimizer
    assert horovod_tpu_torch.fused_adam is fused_apply.fused_adam
    assert horovod_tpu_torch.ReduceOp is reduce_op.ReduceOp
    assert len(quantize.LAUNCHERS) == 6
    assert horovod_tpu_torch.build_mesh is mesh.build_mesh
    assert horovod_tpu_torch.make_overlap_train_step is \
        overlap.make_overlap_train_step
    assert horovod_tpu_torch.broadcast_parameters is \
        optimizer.broadcast_parameters
    assert horovod_tpu_torch.global_process_set is \
        process_sets.global_process_set
    for m in (config, topology, mesh_collectives, buckets, guard):
        assert m.__doc__


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("fn", ["block_quantize", "block_quantize_ef"])
def test_quantizers_compute_nowhere_but_cpu_or_kernel(fn, dtype):
    """The plain versions are for CPU tensors only: a tensor on another
    device (here the meta device), or operands split across devices, raise
    instead of being computed in plain PyTorch."""
    from horovod_tpu_torch.ops import quantize
    wrapper = getattr(quantize, fn)
    with pytest.raises(ValueError, match="one CUDA device"):
        wrapper(torch.empty(4, 256, device="meta", dtype=dtype))
    vals, scales = quantize.block_quantize(torch.ones(4, 256, dtype=dtype))
    with pytest.raises(ValueError, match="one CUDA device"):
        quantize.block_dequantize(vals, scales.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_cuda_tensor_of_unsupported_dtype_raises(dtype):
    """A CUDA tensor the kernels do not take raises; it does not fall back
    to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from horovod_tpu_torch.ops import quantize
    x = torch.zeros(4, 256, device="cuda", dtype=dtype)
    before = [f.launches for f in quantize.LAUNCHERS]
    for wrapper in (quantize.block_quantize, quantize.block_quantize_ef):
        with pytest.raises(TypeError):
            wrapper(x)
    assert [f.launches for f in quantize.LAUNCHERS] == before


def test_parallel_axes_modules_import_and_export():
    """The tensor/sequence/expert slice's modules stand alone too: each has
    its docstring, the model package exports the sharded entry points, and
    the dry run refuses to drift onto the CPU without being asked."""
    from horovod_tpu_torch import dryrun, models
    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.ops import autograd_collectives
    from horovod_tpu_torch.parallel import mesh, moe, ring_attention, ulysses
    for m in (dryrun, transformer, autograd_collectives, moe, ring_attention,
              ulysses):
        assert m.__doc__
    for name in ("shard_params", "shard_state_dict", "param_shardings",
                 "forward_loss_spmd", "data_sharding_spec"):
        assert getattr(models, name) is getattr(transformer, name)
    assert models.data_sharding_spec is mesh.data_sharding_spec
    assert horovod_tpu_torch.shard_batch is mesh.shard_batch


def test_pipeline_modules_import_and_export(no_cuda):
    """The pipeline slice's modules stand alone: each has its docstring,
    the package exports the pipeline plane under the JAX package's names,
    and the composed step refuses to drift onto the CPU without being
    asked."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.parallel import pipeline, plan
    from horovod_tpu_torch.train import autotune
    from horovod_tpu_torch.train import pipeline as train_pipeline
    for m in (pipeline, plan, autotune, train_pipeline):
        assert m.__doc__
    assert horovod_tpu_torch.make_pipeline_train_step is \
        train_pipeline.make_pipeline_train_step
    assert horovod_tpu_torch.ParallelPlan is plan.ParallelPlan
    assert horovod_tpu_torch.AutotunePlan is autotune.Plan
    assert parallel.pipeline_1f1b_apply is pipeline.pipeline_1f1b_apply

    class Mesh:
        shape = {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1}

    with pytest.raises(RuntimeError, match="device='cpu'"):
        horovod_tpu_torch.make_pipeline_train_step(
            lambda p, x: x, lambda y, t: y.sum(), n_layers=2, mesh=Mesh(),
            autotune=False)


def test_dryrun_without_device_raises_without_cuda(no_cuda):
    from horovod_tpu_torch.dryrun import dryrun_multichip
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


def test_checkpoint_modules_import_and_export():
    """The checkpoint slice's modules stand alone: each has its docstring,
    the package exports the JAX package's names of them, and the
    prefetcher refuses to drift onto the CPU without being asked."""
    from horovod_tpu_torch import checkpoint, data
    from horovod_tpu_torch.checkpoint import format, metrics, state, store, \
        writer
    from horovod_tpu_torch.train import callbacks, guard
    from horovod_tpu_torch.train import checkpoint as train_checkpoint
    for m in (checkpoint, format, metrics, state, store, writer, data,
              train_checkpoint):
        assert m.__doc__
    assert horovod_tpu_torch.ShardedCheckpointer is store.ShardedCheckpointer
    assert horovod_tpu_torch.Checkpointer is store.ShardedCheckpointer
    assert horovod_tpu_torch.CheckpointError is format.CheckpointError
    assert horovod_tpu_torch.ReplicaCanary is guard.ReplicaCanary
    assert horovod_tpu_torch.param_digest is guard.param_digest
    assert horovod_tpu_torch.callbacks is callbacks
    for name in ("CheckpointCallback", "BroadcastGlobalVariablesCallback",
                 "MetricAverageCallback", "LearningRateWarmupCallback"):
        assert getattr(callbacks, name).__doc__


def test_zoo_modules_import_and_export():
    """The model zoo's and sync-BN's modules stand alone: each has its
    docstring, imports none of JAX, flax, optax or horovod_tpu (in a fresh
    process), and the model package indexes the five networks."""
    code = (
        "import sys\n"
        "from horovod_tpu_torch.models import (MODEL_ZOO, _flax, bert,\n"
        "    inception, resnet, vgg)\n"
        "from horovod_tpu_torch.train import sync_batch_norm\n"
        "for m in (_flax, bert, inception, resnet, vgg, sync_batch_norm):\n"
        "    assert m.__doc__, m\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'ml_dtypes', 'horovod_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(MODEL_ZOO) == 6, MODEL_ZOO\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", ["resnet50", "resnet101", "vgg16",
                                  "inception3"])
def test_zoo_model_without_device_raises_without_cuda(no_cuda, name):
    from horovod_tpu_torch.models import get_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(name)


def test_bert_without_device_raises_without_cuda(no_cuda):
    from horovod_tpu_torch.models import bert
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.Bert(bert.bert_base())


def test_serving_modules_import_and_export():
    """The serving slice: the JAX ``serving/__init__`` names (less the
    rollout ones), the decode math, the copied HTTP server and reader;
    none of it pulls JAX (the walk above imports every module)."""
    import horovod_tpu_torch.serving as serving
    from horovod_tpu_torch.models import (decode_step_paged,  # noqa: F401
                                          flatten_decode_params,
                                          kv_cache_spec,
                                          prefill_chunk_paged,
                                          reference_greedy_decode)
    from horovod_tpu_torch.runner.http_kv import \
        ThreadedHTTPServer  # noqa: F401
    from horovod_tpu_torch.tracing.reader import read_jsonl  # noqa: F401
    for name in ("DynamicBatcher", "PendingRequest", "SheddedError",
                 "DrainingError", "DeadlineError", "ReplicaServer",
                 "demo_apply", "demo_params", "Router", "RequestLog",
                 "RequestFailed", "RequestRejected", "ready_endpoints",
                 "ReplicaFleet", "LatencyWindow", "GenerateEngine",
                 "GenRequest", "KVPagePlan", "PagePool", "SlotScheduler",
                 "demo_gen_setup", "plan_kv_pages",
                 "request_level_generate", "STAGES", "BurnRateSlo",
                 "ExemplarRing", "WindowBooks", "close_books",
                 "dominant_stage", "quantile", "residual_fraction"):
        assert name in serving.__all__ and hasattr(serving, name), name
    assert not hasattr(serving, "RolloutController")


def test_serving_entry_points_raise_without_cuda(no_cuda):
    """GenerateEngine, ReplicaServer, demo_gen_setup, flagship_gen_setup,
    the replica CLI and ``python -m horovod_tpu_torch.serving`` take the
    card unless asked for the CPU; without one they raise."""
    from horovod_tpu_torch.serving import (GenerateEngine, ReplicaServer,
                                           demo_gen_setup)
    from horovod_tpu_torch.serving.__main__ import main as front_main
    from horovod_tpu_torch.serving.generate import flagship_gen_setup
    from horovod_tpu_torch.serving.replica import main as replica_main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo_gen_setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_gen_setup()
    params, cfg = demo_gen_setup(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerateEngine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaServer(dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaServer(mode="generate", gen_model=(params, cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica_main(["--mode", "generate"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        front_main(["--replicas", "1"])
    eng = GenerateEngine(params, cfg, device="cpu")
    assert eng.device.type == "cpu" and eng.params["embed"].device.type \
        == "cpu"
