"""The port's mesh collectives, bucket planner and bucketed gradient sync
against the JAX package's, on the CPU.

The torch side runs as gloo worlds of 2 and 4 processes (the
``collectives`` and ``hier`` workers of ``tests/test_torch_port_dp.py``,
which import no JAX; the 4-rank world with ``HVD_TPU_VIRTUAL_HOSTS=2``).
The JAX side runs in this process, on the first 2 or 4 devices of the
8-device CPU mesh, with the tolerances of ``tests/test_mesh_collectives.py``,
``tests/test_overlap.py`` and ``tests/test_hier_collectives.py``. The
planner cases of ``tests/test_buckets.py`` run in process: the port's plan
must equal the JAX plan on the same shapes.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu._compat import shard_map
from horovod_tpu.common.topology import MeshTopology as JMeshTopology
from horovod_tpu.compression.quantizers import (
    BlockInt8Quantizer as JBlockInt8Quantizer)
from horovod_tpu.ops import mesh_collectives as jmc
from horovod_tpu.ops.reduce_op import ReduceOp as JReduceOp
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu.train import buckets as jbuckets
from horovod_tpu.train.overlap import bucketed_grad_sync as jax_sync

from horovod_tpu_torch.common.topology import MeshTopology
from horovod_tpu_torch.ops import mesh_collectives as mc
from horovod_tpu_torch.ops.reduce_op import ReduceOp
from horovod_tpu_torch.train import buckets
from horovod_tpu_torch.train.overlap import BucketReducer

from test_torch_port_dp import (HIER_TOPOLOGIES, SYNC_CASES, grad_tree,
                                ops_input, quantized_input, ring_inputs,
                                spawn)


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    return spawn("collectives", 2, tmp_path_factory.mktemp("collectives"))


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    return spawn("hier", 4, tmp_path_factory.mktemp("hier"),
                 {"HVD_TPU_VIRTUAL_HOSTS": "2"})


def _mesh(n):
    return build_mesh(dp=n, devices=jax.devices()[:n])


def _spmd(n, fn, x, out_spec=P("dp")):
    """``fn(shard)`` under shard_map over the first ``n`` devices; the
    per-shard results stacked ``[n, ...]``."""
    @functools.partial(shard_map, mesh=_mesh(n), in_specs=(P("dp"),),
                       out_specs=out_spec, check_vma=False)
    def body(s):
        return jax.tree_util.tree_map(lambda y: y[None],
                                      fn(jax.tree_util.tree_map(
                                          lambda a: a[0], s)))
    return jax.tree_util.tree_map(np.asarray, jax.jit(body)(x))


# -- preduce and the other collectives ------------------------------------------

@pytest.mark.parametrize("op,rtol", [("SUM", 1e-6), ("AVERAGE", 1e-6),
                                     ("MIN", 0), ("MAX", 0),
                                     ("PRODUCT", 1e-5)])
def test_preduce_ops_match_jax(coll, op, rtol):
    x = ops_input()
    ref = _spmd(2, lambda s: jmc.preduce(s, "dp", JReduceOp[op]),
                jnp.asarray(x))
    want = {"SUM": x.sum(0), "AVERAGE": x.mean(0), "MIN": x.min(0),
            "MAX": x.max(0), "PRODUCT": x.prod(0)}[op]
    for r, res in enumerate(coll):
        np.testing.assert_allclose(res[f"preduce_{op}"], want, rtol=rtol)
        np.testing.assert_allclose(res[f"preduce_{op}"], ref[r], rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_preduce_sum_keeps_dtype(coll, dtype):
    """tests/test_mesh_collectives.py:24-29 at dp=2."""
    want = np.arange(12).reshape(2, 6).sum(0)
    for res in coll:
        np.testing.assert_allclose(res[f"sum_{dtype}"].astype(np.float64),
                                   want)


@pytest.mark.parametrize("case,kw", [
    ("dim0", dict(axis=0, tiled=True)),
    ("dim1", dict(axis=1, tiled=True)),
    ("stacked", dict(axis=1, tiled=False))])
def test_pallgather_matches_jax(coll, case, kw):
    g = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    ref = _spmd(2, lambda s: jmc.pallgather(s, "dp", **kw), jnp.asarray(g))
    for r, res in enumerate(coll):
        np.testing.assert_array_equal(res[f"gather_{case}"], ref[r])


@pytest.mark.parametrize("root", [0, 1])
def test_pbroadcast_matches_jax(coll, root):
    x = ops_input()
    ref = _spmd(2, lambda s: jmc.pbroadcast(s, "dp", root), jnp.asarray(x))
    for r, res in enumerate(coll):
        np.testing.assert_array_equal(res[f"broadcast_{root}"], ref[r])
        np.testing.assert_array_equal(res[f"broadcast_{root}"], x[root])


def test_palltoall_matches_jax(coll):
    a = np.arange(8, dtype=np.float32).reshape(2, 4, 1)
    ref = _spmd(2, lambda s: jmc.palltoall(s, "dp"), jnp.asarray(a))
    for r, res in enumerate(coll):
        np.testing.assert_array_equal(res["alltoall"], ref[r])


def test_preduce_scatter_matches_jax(coll):
    x = ops_input()
    ref = _spmd(2, lambda s: jmc.preduce_scatter(s, "dp"), jnp.asarray(x))
    for r, res in enumerate(coll):
        np.testing.assert_allclose(res["reduce_scatter"], ref[r], rtol=1e-6)
        np.testing.assert_allclose(res["reduce_scatter"],
                                   x.sum(0)[4 * r:4 * r + 4], rtol=1e-6)


def test_pring_shift_matches_jax(coll):
    ref = _spmd(2, lambda s: jmc.pring_shift(s, "dp", 1),
                jnp.arange(2.0)[:, None])
    for r, res in enumerate(coll):
        np.testing.assert_array_equal(res["ring_shift"], ref[r])


@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_preduce_quantized_matches_jax(coll, op):
    """One quantization step of the exact reduction: equal to the JAX
    function within 1e-6, and within ``|ref|.max()/254 + 1e-6`` of the
    exact sum or mean."""
    x = quantized_input()
    codec = JBlockInt8Quantizer(256)
    ref = _spmd(2, lambda s: jmc.preduce_quantized(s, "dp", codec,
                                                   JReduceOp[op]),
                jnp.asarray(x))
    exact = x.sum(0) if op == "SUM" else x.mean(0)
    bound = np.abs(exact).max() / 254 + 1e-6
    for r, res in enumerate(coll):
        got = res[f"quantized_{op}"]
        np.testing.assert_allclose(got, ref[r], atol=1e-6)
        assert np.abs(got - exact).max() <= bound


@pytest.mark.parametrize("i", range(3), ids=["13", "4x5", "1"])
def test_ring_allreduce_matches_psum_any_shape(coll, hier, i):
    """tests/test_overlap.py:82-95 over 2 and 4 ranks: the ring equals the
    sum (rtol 2e-5, atol 1e-5) and JAX's ring."""
    for n, world in ((2, coll), (4, hier)):
        x = ring_inputs(n)[i]
        ref = _spmd(n, lambda s: jmc.pring_allreduce(s, "dp"),
                    jnp.asarray(x))
        for r, res in enumerate(world):
            np.testing.assert_allclose(res[f"ring_{i}"], x.sum(0),
                                       rtol=2e-5, atol=1e-5)
            np.testing.assert_allclose(res[f"ring_{i}"], ref[r], rtol=1e-6,
                                       atol=1e-6)


# -- bucketed_grad_sync ---------------------------------------------------------

@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_bucketed_sync_matches_jax(coll, case):
    """tests/test_overlap.py:52-79 at dp=2: dense, many buckets, ring and
    sum within 1e-5 of the dense reduction, int8 within the codec bound;
    each within 1e-6 of JAX's bucketed_grad_sync on the same plan."""
    kw = dict(SYNC_CASES[case])
    if "op" in kw:
        kw["op"] = JReduceOp[kw["op"]]
    if kw.get("compression") == "int8":
        kw["compression"] = JBlockInt8Quantizer(256)
    tree = grad_tree(np.random.RandomState(1 if case == "int8" else 0), 2)
    ref = _spmd(2, lambda g: jax_sync(g, "dp", **kw),
                {k: jnp.asarray(v) for k, v in tree.items()})
    red = np.sum if case == "sum" else np.mean
    # a block of the packed bucket spans leaves: the codec bound is the
    # packed vector's absmax (tests/test_hier_collectives.py:150-155)
    packed_max = max(np.abs(red(v, axis=0)).max() for v in tree.values())
    for r, res in enumerate(coll):
        for k, v in tree.items():
            got, exact = res[f"sync_{case}_{k}"], red(v, axis=0)
            np.testing.assert_allclose(got, ref[k][r], atol=1e-6)
            if case == "int8":
                assert np.abs(got - exact).max() <= packed_max / 254 + 1e-6
            else:
                np.testing.assert_allclose(got, exact, atol=1e-5)


# -- phier_allreduce (4 ranks, HVD_TPU_VIRTUAL_HOSTS=2) -------------------------

def _jhier(x, topo, op, codec=None, floor=None):
    return _spmd(4, lambda s: jmc.phier_allreduce(
        s, "dp", topo, op, inter_codec=codec, small_floor=floor),
        jnp.asarray(x))


@pytest.mark.parametrize("topo", list(HIER_TOPOLOGIES))
@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_hier_matches_flat_and_jax(hier, topo, op):
    """tests/test_hier_collectives.py:49-72 at 4 ranks: 37 elements (padded
    by the scatters) within 1e-4 of the flat reduction, and with the int8
    codec on the inter-host hop within one quantization step; both within
    1e-6 of JAX."""
    jt = JMeshTopology(*HIER_TOPOLOGIES[topo])
    red = np.sum if op == "SUM" else np.mean
    x37 = np.random.RandomState(0).randn(4, 37).astype(np.float32)
    x64 = np.random.RandomState(1).randn(4, 64).astype(np.float32)
    ref = _jhier(x37, jt, JReduceOp[op])
    refq = _jhier(x64, jt, JReduceOp[op], JBlockInt8Quantizer())
    exact64 = red(x64.astype(np.float64), axis=0)
    for r, res in enumerate(hier):
        np.testing.assert_allclose(res[f"hier_{topo}_{op}"],
                                   red(x37.astype(np.float64), axis=0),
                                   atol=1e-4)
        np.testing.assert_allclose(res[f"hier_{topo}_{op}"], ref[r],
                                   atol=1e-6)
        got = res[f"hierq_{topo}_{op}"]
        assert np.abs(got - exact64).max() <= np.abs(exact64).max() / 254 \
            + 1e-6
        np.testing.assert_allclose(got, refq[r], atol=1e-6)


def test_hier_2d_tensor_and_dtype_preserved(hier):
    x = np.random.RandomState(2).randn(4, 6, 10).astype(np.float32)
    for res in hier:
        got = res["hier_2d"]
        assert got.shape == (6, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, x.mean(0), atol=1e-4)


def test_small_floor_takes_dense_path_exactly(hier):
    """Below the byte floor the hierarchy and the codec are skipped: the
    result equals the flat psum bit for bit."""
    for res in hier:
        np.testing.assert_array_equal(res["floored"], res["flat_sum"])


@pytest.mark.parametrize("case", ["hier", "hier_int8", "floor"])
def test_bucketed_sync_hier_matches_jax(hier, case):
    """tests/test_hier_collectives.py:135-173 at 4 ranks; ``hier`` takes its
    topology from ``HVD_TPU_VIRTUAL_HOSTS=2`` (2x2)."""
    seed, kw = {"hier": (4, dict(algorithm="hier", bucket_bytes=128)),
                "hier_int8": (5, dict(algorithm="hier",
                                      compression=JBlockInt8Quantizer())),
                "floor": (6, dict(compression=JBlockInt8Quantizer(),
                                  small_floor=1 << 30))}[case]
    if case.startswith("hier"):
        kw["topology"] = JMeshTopology(2, 2)
    tree = grad_tree(np.random.RandomState(seed), 4)
    ref = _spmd(4, lambda g: jax_sync(g, "dp", **kw),
                {k: jnp.asarray(v) for k, v in tree.items()})
    packed_max = max(np.abs(v.mean(0)).max() for v in tree.values())
    for r, res in enumerate(hier):
        for k, v in tree.items():
            got, exact = res[f"sync_{case}_{k}"], v.mean(0)
            np.testing.assert_allclose(got, ref[k][r], atol=1e-6)
            if case == "hier_int8":
                assert np.abs(got - exact).max() <= packed_max / 254 + 1e-6
            else:
                np.testing.assert_allclose(got, exact, atol=1e-5, rtol=1e-6)


def _fake_axis(n):
    return SimpleNamespace(size=n, name="dp")


def test_hier_refuses_what_jax_refuses():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="does not cover"):
        mc.phier_allreduce(x, _fake_axis(8), MeshTopology(2, 2))
    with pytest.raises(ValueError, match="Sum/Average"):
        mc.phier_allreduce(x, _fake_axis(8), MeshTopology(2, 4),
                           ReduceOp.MIN)
    with pytest.raises(ValueError, match="Sum/Average"):
        mc.pring_allreduce(x, _fake_axis(2), ReduceOp.MAX)
    with pytest.raises(ValueError, match="divisible"):
        mc.preduce_quantized(torch.zeros(5), _fake_axis(2), None)
    with pytest.raises(ValueError, match="no compression seam"):
        BucketReducer(_fake_axis(2), ring=True,
                      compression=JBlockInt8Quantizer())
    with pytest.raises(ValueError, match="psum | ring | hier"):
        BucketReducer(_fake_axis(2), algorithm="tree")
    with pytest.raises(ValueError, match="Unsupported reduce op"):
        mc.preduce(x, _fake_axis(2), 99)


# -- the bucket planner (in process) --------------------------------------------

PLAN_CASES = {
    "covers_all": ([(4,), (8,), (2,)], 1 << 20, True),
    "splits_reverse": ([(100,), (3, 4), (2,)], 400, True),
    "forward": ([(100,), (3, 4), (2,)], 400, False),
    "tiny_coalesce": ([(4,)] * 64, 128, True),
    "oversized": ([(1000,), (2,), (1000,)], 512, True),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_equals_jax(case):
    """The cases of tests/test_buckets.py: the port's plan is JAX's, bucket
    for bucket, on the same shapes and budget."""
    shapes, budget, reverse = PLAN_CASES[case]
    got = buckets.plan_buckets([torch.zeros(s) for s in shapes], budget,
                               reverse)
    want = jbuckets.plan_buckets([jnp.zeros(s) for s in shapes], budget,
                                 reverse)
    assert tuple(got.buckets) == tuple(want.buckets)
    assert got.total_bytes == want.total_bytes


def test_plan_over_a_tree_follows_jax_flatten_order():
    """A dict of dotted names plans in JAX's sorted order, the same plan as
    the nested JAX tree; mixed dtypes count their own bytes."""
    jtree = {"embed": jnp.zeros((50, 8)), "ln_f": jnp.zeros(8),
             "layers": {"wq": jnp.zeros((1, 2, 8, 8), jnp.bfloat16),
                        "ln1": jnp.zeros((1, 2, 8))}}
    ttree = {"embed": torch.zeros(50, 8), "ln_f": torch.zeros(8),
             "layers.wq": torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16),
             "layers.ln1": torch.zeros(1, 2, 8)}
    for budget in (64, 300, 1 << 20):
        want = jbuckets.plan_buckets(jtree, budget)
        assert tuple(buckets.plan_buckets(ttree, budget).buckets) == \
            tuple(want.buckets), budget


def test_budget_resolution_prefers_env_then_fusion(monkeypatch):
    from horovod_tpu_torch.common.config import reset_config
    for k in ("HVD_TPU_BUCKET_BYTES", "HOROVOD_BUCKET_BYTES",
              "HVD_TPU_FUSION_THRESHOLD", "HOROVOD_FUSION_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    reset_config()
    assert buckets.resolve_bucket_bytes() == 64 * 1024 * 1024
    monkeypatch.setenv("HVD_TPU_BUCKET_BYTES", "4096")
    reset_config()
    assert buckets.resolve_bucket_bytes() == 4096
    assert buckets.resolve_bucket_bytes(128) == 128
    monkeypatch.delenv("HVD_TPU_BUCKET_BYTES")
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1000")
    reset_config()
    assert buckets.resolve_bucket_bytes() == 1000
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD")
    reset_config()


def test_pack_unpack_roundtrip_and_wire_dtype():
    rng = np.random.RandomState(0)
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((3, 5), (7,), (2, 2))]
    plan = buckets.plan_buckets(leaves, 1 << 20)
    vec = buckets.pack(leaves, plan.buckets[0], pad_to=8)
    jvec = jbuckets.pack([jnp.asarray(t.numpy()) for t in leaves],
                         plan.buckets[0], pad_to=8)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    for got, i in zip(buckets.unpack(vec, plan.buckets[0], leaves),
                      plan.buckets[0].indices):
        assert torch.equal(got, leaves[i])
    bf = [torch.zeros(8, dtype=torch.bfloat16),
          torch.zeros(4, dtype=torch.bfloat16)]
    b = buckets.plan_buckets(bf, 1 << 20).buckets[0]
    assert buckets.pack(bf, b).dtype == torch.bfloat16
    mixed = [bf[0], torch.zeros(4)]
    b = buckets.plan_buckets(mixed, 1 << 20).buckets[0]
    assert buckets.pack(mixed, b).dtype == torch.float32


def test_flagship_plan_is_two_buckets_in_jax_order():
    """The flagship at full width and the default budget: two buckets, the
    eight layer leaves with ``ln_f`` (50.3 MB), then ``embed`` (65.5 MB),
    as the JAX planner makes them over its tree."""
    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.models.transformer import _param_shapes
    from horovod_tpu_torch.common.tree import flatten_dotted, tree_flatten
    shapes = flatten_dotted(_param_shapes(_flagship_cfg()))
    metas = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    plan = buckets.plan_buckets(metas, 64 * 1024 * 1024)
    names = [k for k in sorted(shapes, key=lambda k: k.split("."))]
    assert [[names[i] for i in b.indices] for b in plan.buckets] == \
        [[n for n in names if n != "embed"], ["embed"]]
    assert [b.nbytes for b in plan.buckets] == [50350080, 65536000]
    assert tree_flatten(metas)[0][0] is metas["embed"]


@pytest.mark.parametrize("sizes,n", [
    (dict(dp=-1), 8), (dict(dp=2, tp=4), 8), (dict(dp=-1, pp=2), 4),
    (dict(dp=-1, tp=-1), 8), (dict(dp=-1, tp=3), 8), (dict(dp=2, tp=2), 8)])
def test_mesh_spec_resolves_like_jax(sizes, n):
    """MeshSpec.resolve: the same sizes, or the same error, as the JAX
    package's."""
    from horovod_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from horovod_tpu_torch.parallel.mesh import MeshSpec
    try:
        want = JMeshSpec(**sizes).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshSpec(**sizes).resolve(n)
        assert str(got.value) == str(e)
    else:
        assert MeshSpec(**sizes).resolve(n) == want
