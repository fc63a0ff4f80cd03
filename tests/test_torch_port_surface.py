"""The port's public surface against the JAX package's, read from source.

The walk parses every module of ``horovod_tpu/`` with ``ast`` (nothing of
it is imported, so JAX is not loaded for the walk). A module's public
names are the top-level functions, classes and assignments that do not
start with ``_``, with its ``__all__``; a package ``__init__`` adds the
names it imports from the package. Each such name is held in one of three
ways:

* the port's module of the same path binds the same name (``MOVED`` maps
  the JAX modules whose counterpart has another path);
* ``RENAMED`` names its counterpart in the port, which must exist;
* ``NOT_PORTED`` gives the reason there is none, and the port must not
  bind the name.

A row for a name that the JAX package no longer has fails too, so the
table follows both packages. README's port section mirrors it.

Then each newly ported function that computes something is held to the
JAX package's on the same inputs: ``peak_bytes`` of given stats, the
identity fields of ``sibling``, the order of ``wall_monotonic_pair``'s
clocks, and the trace ``trace(log_dir)`` leaves of a small CPU step."""

import ast
import importlib
import json
import os
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "horovod_tpu")
PORT_PKG = os.path.join(REPO, "horovod_tpu_torch")

# JAX module -> the port's module of the same role under another path
MOVED = {
    "ops/pallas_attention.py": "ops/attention.py",
    "ops/pallas_xent.py": "ops/xent.py",
    "ops/pallas_quantize.py": "ops/quantize.py",
    "runner/tpu_discovery.py": "runner/gpu_discovery.py",
}

# "JAX module:name" -> "port module:name", the counterpart under another name
RENAMED = {
    "ops/pallas_attention.py:flash_attention_tpu":
        "ops/attention.py:flash_attn_fwd_cuda",
    "ops/xla_backend.py:XlaBackend": "ops/dist_backend.py:DistBackend",
    "runner/tpu_discovery.py:tpu_pod_hosts":
        "runner/gpu_discovery.py:pod_hosts",
    "runner/tpu_discovery.py:tpu_worker_index":
        "runner/gpu_discovery.py:worker_index",
    "runner/tpu_discovery.py:tpu_accelerator_type":
        "runner/gpu_discovery.py:accelerator_type",
    "runner/tpu_discovery.py:tpu_maintenance_event":
        "runner/gpu_discovery.py:maintenance_event",
    "runner/tpu_discovery.py:running_on_tpu_vm":
        "runner/gpu_discovery.py:running_on_cloud_vm",
    "runner/tpu_discovery.py:TpuPodDiscovery":
        "runner/gpu_discovery.py:PodDiscovery",
    "ops/mesh_collectives.py:device_allreduce":
        "ops/mesh_collectives.py:preduce",
    "ops/mesh_collectives.py:device_allgather":
        "ops/mesh_collectives.py:pallgather",
    "ops/mesh_collectives.py:device_broadcast":
        "ops/mesh_collectives.py:pbroadcast",
    "ops/mesh_collectives.py:device_alltoall":
        "ops/mesh_collectives.py:palltoall",
    "ops/mesh_collectives.py:device_reduce_scatter":
        "ops/mesh_collectives.py:preduce_scatter",
    "parallel/pipeline.py:pipeline_spmd": "parallel/pipeline.py:gpipe",
    "parallel/pipeline.py:pipeline_1f1b_spmd":
        "parallel/pipeline.py:run_schedule",
    "parallel/pipeline.py:pipeline_interleaved_spmd":
        "parallel/pipeline.py:run_schedule",
    "parallel/mesh.py:single_axis_mesh": "parallel/mesh.py:build_mesh",
    "parallel/__init__.py:single_axis_mesh": "parallel/__init__.py:build_mesh",
    "__init__.py:single_axis_mesh": "__init__.py:build_mesh",
    "__init__.py:DistributedGradTransform": "__init__.py:DistributedOptimizer",
    "train/optimizer.py:DistributedGradTransform":
        "train/optimizer.py:DistributedOptimizer",
    "train/optimizer.py:DistributedState":
        "train/optimizer.py:DistributedOptimizer",
    "ops/adasum.py:AdasumGradTransform":
        "train/optimizer.py:DistributedOptimizer",
    "compression/error_feedback.py:error_feedback_transform":
        "train/optimizer.py:DistributedOptimizer",
    "compression/error_feedback.py:EFState":
        "train/optimizer.py:DistributedOptimizer",
    "compression/__init__.py:error_feedback_transform":
        "train/optimizer.py:DistributedOptimizer",
    "compression/__init__.py:EFState":
        "train/optimizer.py:DistributedOptimizer",
    "train/fused_apply.py:make_fused_transform":
        "train/fused_apply.py:fused_adam",
    "train/fused_apply.py:FusedOptState":
        "train/fused_apply.py:FusedOptimizer",
    "train/guard.py:GuardObserver": "train/guard.py:GuardedStep",
    "elastic/__init__.py:TpuState": "torch/elastic.py:TorchState",
    "runner/exec_run.py:free_port": "runner/exec_run.py:reserve_port",
}

_XLA = "none: XLA only"
_SHARDING = "none: the port has no XLA shardings; a rank holds its shard"
_PALLAS = ("none: a Pallas tiling constant; the CUDA kernel's tiles are in "
           "csrc/")
# "JAX module:name" -> why the port has no counterpart
NOT_PORTED = {
    "_compat.py:axis_size": _XLA + " (shard_map compatibility)",
    "_compat.py:shard_map": _XLA + " (shard_map compatibility)",
    "ops/pallas_attention.py:BLOCK_Q": _PALLAS,
    "ops/pallas_xent.py:BLOCK_N": _PALLAS,
    "ops/pallas_xent.py:BLOCK_V": _PALLAS,
    "ops/pallas_xent.py:NEG_INF": "none: the port's xent pads no vocab "
                                  "columns (ROADMAP queue 3 item 2)",
    "ops/pallas_quantize.py:ROWS": _PALLAS,
    "__init__.py:batch_sharding": _SHARDING,
    "__init__.py:logical_sharding": _SHARDING,
    "__init__.py:xla_built": _XLA,
    "common/basics.py:xla_built": _XLA,
    "common/timeline.py:XLA_COLLECTIVE": _XLA + " (no reference activity)",
    "common/util.py:is_traced": _XLA + " (JAX tracers)",
    "metrics/mfu.py:hlo_flops_per_device": _XLA + " (HLO cost analysis); "
                                           "the port counts FLOPs "
                                           "analytically",
    "models/resnet.py:batch_sharding": _SHARDING,
    "parallel/__init__.py:AxisRules": _SHARDING,
    "parallel/__init__.py:batch_sharding": _SHARDING,
    "parallel/__init__.py:default_rules": _SHARDING,
    "parallel/__init__.py:logical_sharding": _SHARDING,
    "parallel/__init__.py:replicated": _SHARDING,
    "parallel/__init__.py:sharded": _SHARDING,
    "parallel/mesh.py:AxisRules": _SHARDING,
    "parallel/mesh.py:DEFAULT_RULES": _SHARDING,
    "parallel/mesh.py:batch_sharding": _SHARDING,
    "parallel/mesh.py:default_rules": _SHARDING,
    "parallel/mesh.py:logical_sharding": _SHARDING,
    "parallel/mesh.py:replicated": _SHARDING,
    "parallel/mesh.py:sharded": _SHARDING,
    "profiling/compile_watch.py:DEFAULT_RECOMPILE_STORM":
        _XLA + " (the recompile storm); the port's compile watch counts "
               "nvcc builds and graph captures",
    "profiling/compile_watch.py:DEFAULT_RECOMPILE_WARMUP":
        _XLA + " (the recompile storm)",
    "profiling/compile_watch.py:ensure_installed":
        _XLA + " (hooks jax's compile log)",
    "profiling/compile_watch.py:uninstall":
        _XLA + " (hooks jax's compile log)",
    "train/checkpoint.py:OrbaxCheckpointer": "none: orbax is JAX-only "
                                             "(ROADMAP queue 1 item 3)",
    "checkpoint/format.py:np_dtype": "none: needs ml_dtypes; the port's bf16 "
                                     "is a uint16 view named 'bfloat16'",
    "checkpoint/format.py:logical_view": "none: needs ml_dtypes; the port's "
                                         "bf16 is a uint16 view named "
                                         "'bfloat16'",
}

# parameters the port's counterpart lacks: "JAX module:function" ->
# (parameters, why)
NOT_PORTED_PARAMS = {
    "serving/generate/engine.py:request_level_generate": (
        ("traced", "on_token_factory"),
        "waits for the benchmark PR, its caller (ROADMAP queue 1 item 1)"),
}


def _modules(root: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = ast.parse(open(p).read())
    return out


def _targets(node) -> set:
    tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
    return {n.id for t in tgts for n in ast.walk(t) if isinstance(n, ast.Name)}


def public_names(tree: ast.Module, is_init: bool) -> set:
    """The JAX module's public names (module docstring)."""
    out = set()
    for node in _top(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out |= _targets(node)
            if "__all__" in _targets(node):
                out |= set(ast.literal_eval(node.value))
        elif is_init and isinstance(node, ast.ImportFrom) and (
                node.level or (node.module or "").startswith("horovod_tpu")):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def bound_names(tree: ast.Module) -> set:
    """Every name the port's module binds at top level."""
    out = set()
    for node in _top(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out |= _targets(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _top(tree: ast.Module):
    """Top-level statements, those in the branches of a top-level ``if`` or
    ``try`` too (not the bodies of functions or classes)."""
    def flat(stmts):
        for node in stmts:
            if isinstance(node, ast.If):
                yield from flat(node.body + node.orelse)
            elif isinstance(node, ast.Try):
                yield from flat(node.body + node.orelse + node.finalbody +
                                [s for h in node.handlers for s in h.body])
            else:
                yield node
    return flat(tree.body)


@pytest.fixture(scope="module")
def trees():
    return _modules(JAX_PKG), _modules(PORT_PKG)


def _port_has(port, key: str) -> bool:
    mod, name = key.split(":")
    return mod in port and name in bound_names(port[mod])


def test_every_public_name_is_ported_renamed_or_listed(trees):
    jax_mods, port = trees
    missing, stale_not_ported = [], []
    for mod, tree in sorted(jax_mods.items()):
        twin = MOVED.get(mod, mod)
        names = bound_names(port[twin]) if twin in port else set()
        for name in sorted(public_names(tree, mod.endswith("__init__.py"))):
            key = f"{mod}:{name}"
            if key in RENAMED:
                assert _port_has(port, RENAMED[key]), (key, RENAMED[key])
            elif key in NOT_PORTED:
                assert NOT_PORTED[key].startswith("none: ")
                if name in names:
                    stale_not_ported.append(key)
            elif name not in names:
                missing.append(key)
    assert not missing, f"JAX public names with no row: {missing}"
    assert not stale_not_ported, \
        f"listed as not ported but present in the port: {stale_not_ported}"


def test_every_row_names_a_public_jax_name(trees):
    jax_mods, port = trees
    public = {f"{m}:{n}" for m, t in jax_mods.items()
              for n in public_names(t, m.endswith("__init__.py"))}
    assert not (set(RENAMED) | set(NOT_PORTED)) - public
    assert set(MOVED) <= set(jax_mods) and \
        all(m not in port for m in MOVED)
    assert all(v in port for v in MOVED.values())


def _params(tree: ast.Module, fn: str) -> set:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == fn:
            a = node.args
            return {x.arg for x in a.args + a.kwonlyargs}
    raise AssertionError(fn)


def test_parameters_not_ported_are_listed(trees):
    jax_mods, port = trees
    for key, (params, why) in NOT_PORTED_PARAMS.items():
        mod, fn = key.split(":")
        assert set(params) <= _params(jax_mods[mod], fn)
        assert not set(params) & _params(port[mod], fn), key
        assert why


@pytest.mark.parametrize("pkg", [
    "", "compression", "metrics", "models", "serving", "runner", "parallel",
    "profiling", "diagnostics", "tracing", "elastic", "train", "checkpoint"])
def test_package_reexports_import(trees, pkg):
    """Each name a JAX package ``__init__`` exports resolves on the
    imported port package (or is a row of the tables)."""
    jax_mods, _ = trees
    init = os.path.join(pkg, "__init__.py") if pkg else "__init__.py"
    mod = importlib.import_module(
        "horovod_tpu_torch" + (f".{pkg}" if pkg else ""))
    names = public_names(jax_mods[init], True)
    absent = [n for n in sorted(names)
              if f"{init}:{n}" not in RENAMED and
              f"{init}:{n}" not in NOT_PORTED and not hasattr(mod, n)]
    assert not absent, absent


def test_top_level_build_queries_and_reexports():
    import horovod_tpu_torch as hvd
    for fn in ("nccl_built", "gloo_built", "gloo_enabled", "mpi_built",
               "mpi_enabled", "mpi_threads_supported", "cuda_built",
               "rocm_built", "ccl_built", "ddl_built", "sycl_built"):
        assert isinstance(getattr(hvd, fn)(), bool), fn
    assert not hvd.mpi_built() and not hvd.rocm_built()
    assert hvd.gloo_built() and hvd.gloo_enabled()
    assert hvd.SyncBatchNorm is not None and callable(hvd.plan_buckets)
    assert hvd.AXIS_ORDER == ("dp", "pp", "ep", "sp", "tp")
    import torch
    assert hvd.num_devices() == torch.cuda.device_count()
    assert hvd.global_device_count() == hvd.num_devices()  # before init


def test_constants_equal_the_jax_package():
    from horovod_tpu.common import timeline as jt
    from horovod_tpu.parallel import mesh as jm

    from horovod_tpu_torch.common import timeline as tt
    from horovod_tpu_torch.parallel import mesh as tm
    for name in ("NEGOTIATE_ALLREDUCE", "NEGOTIATE_ALLGATHER",
                 "NEGOTIATE_BROADCAST", "NEGOTIATE_ALLTOALL",
                 "WAIT_FOR_DATA", "WAIT_FOR_OTHER_TENSOR_DATA", "QUEUE",
                 "MEMCPY_IN_FUSION_BUFFER", "COMPUTE",
                 "MEMCPY_OUT_FUSION_BUFFER"):
        assert getattr(tt, name) == getattr(jt, name)
    for name in ("AXIS_ORDER", "DATA_AXIS", "PIPELINE_AXIS", "EXPERT_AXIS",
                 "SEQUENCE_AXIS", "TENSOR_AXIS"):
        assert getattr(tm, name) == getattr(jm, name)


@pytest.mark.parametrize("stats", [
    [],
    [{"peak_bytes_in_use": 7}],
    [{"peak_bytes_in_use": 3, "bytes_in_use": 1},
     {"peak_bytes_in_use": 2.5e9}, {"bytes_limit": 9}],
    [{"peak_bytes_in_use": None}, {"peak_bytes_in_use": "12"}],
])
def test_peak_bytes_equals_jax(stats):
    from horovod_tpu.profiling.memory import peak_bytes as jax_peak

    from horovod_tpu_torch.profiling.memory import peak_bytes
    assert peak_bytes(stats) == jax_peak(stats)


def test_peak_bytes_reads_the_card_or_none():
    import torch

    from horovod_tpu_torch.profiling.memory import peak_bytes
    got = peak_bytes()
    assert (got is None) == (not torch.cuda.is_available()), got


def test_sibling_keeps_the_trace_and_parent(monkeypatch):
    from horovod_tpu import tracing as jt

    from horovod_tpu_torch import tracing as tt
    monkeypatch.delenv("HVD_TPU_TRACE", raising=False)
    for mod in (jt, tt):
        root = mod.new_trace("serving")
        kid = mod.child(root, "serving")
        sib = mod.sibling(kid, "serving")
        assert (sib.trace_id, sib.parent_id) == (kid.trace_id, kid.parent_id)
        assert sib.span_id != kid.span_id and len(sib.span_id) == 16
        assert mod.sibling(None) is None
    # one header decoded by each package: siblings of the same identity
    header = jt.encode(jt.child(jt.new_trace()))
    a, b = jt.sibling(jt.decode(header)), tt.sibling(tt.decode(header))
    assert (a.trace_id, a.parent_id) == (b.trace_id, b.parent_id)
    assert a.span_id != b.span_id
    monkeypatch.setenv("HVD_TPU_TRACE", "0")
    assert tt.sibling(tt.TraceContext("a" * 32, "b" * 16, None)) is None


def test_wall_monotonic_pair_brackets_like_jax():
    from horovod_tpu.diagnostics.clock import wall_monotonic_pair as jax_pair

    from horovod_tpu_torch.diagnostics.clock import wall_monotonic_pair
    w0, m0 = jax_pair()
    w1, m1 = wall_monotonic_pair()
    w2, m2 = jax_pair()
    assert w0 <= w1 <= w2 and m0 <= m1 <= m2
    assert abs((w1 - m1) - (w0 - m0)) < 1.0   # one anchor, both clocks


def test_set_active_and_reset_logger():
    from horovod_tpu_torch.common import logging as hl
    from horovod_tpu_torch.diagnostics import spans
    spans.set_active("allreduce.g#3")
    assert spans.current_span() == "allreduce.g#3"
    spans.set_active(None)
    assert spans.current_span() is None
    log = hl.get_logger()
    assert log.handlers
    hl.reset_logger()
    assert not log.handlers and hl._LOGGER is None
    assert hl.get_logger().handlers


def test_from_ledger_reads_the_goodput_snapshot(monkeypatch):
    from horovod_tpu_torch.metrics import goodput
    from horovod_tpu_torch.profiling import attribution
    monkeypatch.delenv("HVD_TPU_GOODPUT", raising=False)
    goodput.reset()
    try:
        assert attribution.from_ledger() is None   # the ledger never ran
        goodput.note_step_begin()
        time.sleep(0.02)
        goodput.note_step_end(0.02)
        att = attribution.from_ledger(mfu=0.25, flush_open=True)
        assert att == attribution.attribute(goodput.snapshot(), mfu=0.25)
        assert att["mfu"] == 0.25 and att["wall_s"] > 0
        assert att["shares"]["compute"] > 0
    finally:
        goodput.reset()


def test_trace_leaves_a_readable_trace_of_a_cpu_step(tmp_path):
    import torch

    from horovod_tpu_torch import profiling
    from horovod_tpu_torch.utils import profiler
    assert profiler.trace is profiling.trace
    w = torch.randn(16, 16, requires_grad=True)
    with profiling.trace(str(tmp_path)):
        loss = (torch.randn(8, 16) @ w).square().mean()
        loss.backward()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names and "aten::mean" in names
    with pytest.raises(RuntimeError):
        profiling.stop_trace()
    profiling.start_trace(str(tmp_path / "b"))
    with pytest.raises(RuntimeError):
        profiling.start_trace(str(tmp_path / "c"))
    profiling.stop_trace()
    assert os.path.exists(tmp_path / "b" / "trace.json")
