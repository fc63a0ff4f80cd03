"""The port's compression package against the JAX package's, on the CPU:
the block-int8 codec (round-trip bound ``absmax/254``, padding of odd
shapes, codes within ±1 and scales within 1 ULP of the Pallas kernel), fp8
and onebit, error feedback (the exact residual carry and the telescoping
identity, rtol 1e-4 / atol 1e-5 as in ``tests/test_compression.py``), the
casts, ``resolve_compressor``, the block-size environment variables and
``ReduceOp``. Inputs come from numpy seeds and go through both packages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import horovod_tpu.compression as jc
from horovod_tpu.ops import reduce_op as jro

import horovod_tpu_torch as hvd
import horovod_tpu_torch.compression as tc
from horovod_tpu_torch.ops import reduce_op as tro


def _np(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- block int8 ----------------------------------------------------------------

def test_int8_roundtrip_error_bound():
    """|x - qdq(x)| <= absmax_block / 254 elementwise."""
    q = tc.BlockInt8Quantizer(block_size=128)
    x = torch.from_numpy(_np((1000,)))
    qt, spec = q.quantize(x)
    out = q.dequantize(qt, spec)
    assert out.shape == x.shape and out.dtype == x.dtype
    pad = (-x.numel()) % 128
    blocks = np.pad(x.numpy(), (0, pad)).reshape(-1, 128)
    bound = np.abs(blocks).max(axis=1) / 254 + 1e-7
    err = np.abs(np.pad((out - x).numpy(), (0, pad))).reshape(-1, 128)
    assert (err <= bound[:, None]).all()


@pytest.mark.parametrize("shape", [(7,), (1,), (3, 5), (4, 256), (2, 3, 17)])
def test_int8_shapes_and_padding_match_jax(shape):
    """Odd sizes pad to a block multiple and restore; codes, scales and the
    round trip agree with the JAX codec through its Pallas kernel."""
    x = _np(shape, seed=3)
    q = tc.BlockInt8Quantizer(block_size=64)
    qt, spec = q.quantize(torch.from_numpy(x))
    jq = jc.BlockInt8Quantizer(block_size=64, interpret=True)
    jqt, jspec = jq.quantize(jnp.asarray(x))
    assert spec.pad == jspec.pad and spec.shape == jspec.shape
    assert qt.values.shape == jqt.values.shape
    assert np.abs(qt.values.numpy().astype(np.int32)
                  - np.asarray(jqt.values, np.int32)).max() <= 1
    np.testing.assert_array_max_ulp(qt.scales.numpy(), np.asarray(jqt.scales),
                                    maxulp=1)
    out = q.dequantize(qt, spec)
    assert out.shape == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jq.dequantize(jqt,
                                                                     jspec)),
                               atol=1e-6)
    np.testing.assert_allclose(out.numpy(), x, atol=0.05)


def test_int8_bf16_input_keeps_dtype_and_matches_jax():
    x = _np((128,), seed=5)
    q = tc.BlockInt8Quantizer(block_size=64)
    xt = torch.from_numpy(x).bfloat16()
    out = q.dequantize(*q.quantize(xt))
    assert out.dtype == torch.bfloat16
    jq = jc.BlockInt8Quantizer(block_size=64, interpret=True)
    ref = jq.qdq(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_int8_wire_ratio():
    """fp32 → int8 + one fp32 scale per block: > 3.5x at block 256."""
    qt, _ = tc.BlockInt8Quantizer(256).quantize(torch.from_numpy(_np((4096,))))
    assert 4096 * 4 / qt.wire_bytes > 3.5
    jqt, _ = jc.BlockInt8Quantizer(256).quantize(jnp.asarray(_np((4096,))))
    assert qt.wire_bytes == jqt.wire_bytes


def test_quantizer_hashable_config():
    assert tc.BlockInt8Quantizer(128) == tc.BlockInt8Quantizer(128)
    assert tc.BlockInt8Quantizer(128) != tc.BlockInt8Quantizer(256)
    assert hash(tc.BlockInt8Quantizer(128)) == hash(tc.BlockInt8Quantizer(128))
    assert tc.OneBitQuantizer() != tc.BlockInt8Quantizer(128)
    with pytest.raises(ValueError):
        tc.BlockInt8Quantizer(0)


def test_block_size_env_read_at_use(monkeypatch):
    q = tc.BlockInt8Quantizer()
    monkeypatch.delenv("HVD_TPU_COMPRESSION_BLOCK_SIZE", raising=False)
    monkeypatch.delenv("HOROVOD_COMPRESSION_BLOCK_SIZE", raising=False)
    assert q.block_size == 256
    monkeypatch.setenv("HOROVOD_COMPRESSION_BLOCK_SIZE", "64")
    assert q.block_size == 64 == jc.BlockInt8Quantizer().block_size
    monkeypatch.setenv("HVD_TPU_COMPRESSION_BLOCK_SIZE", "32")   # wins
    assert q.block_size == 32 == jc.BlockInt8Quantizer().block_size
    assert q == tc.BlockInt8Quantizer(32) and hash(q) == hash(
        tc.BlockInt8Quantizer(32))
    qt, _ = q.quantize(torch.zeros(96))
    assert qt.values.shape == (3, 32)
    assert tc.BlockInt8Quantizer(16).block_size == 16   # explicit wins


# -- fp8 and onebit ----------------------------------------------------------------

@pytest.mark.skipif(not (tc.fp8_supported() and jc.fp8_supported()),
                    reason="needs float8 dtypes in both torch and jax")
@pytest.mark.parametrize("flavor", ["e4m3", "e5m2"])
def test_fp8_matches_jax(flavor):
    x = _np((512,), seed=1)
    q, jq = tc.FP8Quantizer(flavor), jc.FP8Quantizer(flavor)
    qt, spec = q.quantize(torch.from_numpy(x))
    jqt, jspec = jq.quantize(jnp.asarray(x))
    assert qt.values.element_size() == 1
    np.testing.assert_array_max_ulp(qt.scales.numpy(), np.asarray(jqt.scales),
                                    maxulp=1)
    np.testing.assert_array_equal(qt.values.float().numpy(),
                                  np.asarray(jqt.values.astype(jnp.float32)))
    out = q.dequantize(qt, spec)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jq.dequantize(jqt,
                                                                     jspec)),
                               rtol=1e-6)
    tol = 0.07 if flavor == "e4m3" else 0.3
    np.testing.assert_allclose(out.numpy(), x, atol=tol * np.abs(x).max())


@pytest.mark.parametrize("n", [8, 13, 1000])
def test_onebit_matches_jax(n):
    x = _np((n,), seed=n)
    q, jq = tc.OneBitQuantizer(), jc.OneBitQuantizer()
    qt, spec = q.quantize(torch.from_numpy(x))
    jqt, jspec = jq.quantize(jnp.asarray(x))
    assert qt.values.dtype == torch.uint8 and spec.pad == jspec.pad
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(jqt.values))
    np.testing.assert_allclose(qt.scales.numpy(), np.asarray(jqt.scales),
                               rtol=1e-6)
    out = q.dequantize(qt, spec)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jq.dequantize(jqt, jspec)),
                               rtol=1e-6)
    np.testing.assert_allclose(out.numpy(),
                               np.where(x >= 0, 1.0, -1.0) * np.abs(x).mean(),
                               rtol=1e-5)


# -- error feedback ------------------------------------------------------------

def test_ef_residual_carry_exact():
    """One-bit EF on a known vector: the residual is exactly acc - C(acc),
    re-injected the next step."""
    q = tc.OneBitQuantizer()
    g = {"w": torch.tensor([0.5, -0.25])}
    residual = tc.init_residual(g)
    c1, r1 = tc.ef_apply(q, g, residual)
    np.testing.assert_allclose(c1["w"].numpy(), [0.375, -0.375], rtol=1e-6)
    np.testing.assert_allclose(r1["w"].numpy(), [0.125, 0.125], rtol=1e-6)
    c2, r2 = tc.ef_apply(q, g, r1)
    np.testing.assert_allclose(c2["w"].numpy(), [0.375, -0.375], rtol=1e-6)
    np.testing.assert_allclose(r2["w"].numpy(), [0.25, 0.25], rtol=1e-6)


def test_ef_telescopes_to_true_sum():
    """Over K steps of a constant gradient, sum(compressed) + residual ==
    K * g: EF loses nothing in the long run."""
    q = tc.BlockInt8Quantizer(block_size=64)
    g = {"w": torch.from_numpy(_np((96,), seed=8))}
    residual = tc.init_residual(g)
    total = torch.zeros_like(g["w"])
    K = 10
    for _ in range(K):
        c, residual = tc.ef_apply(q, g, residual)
        total = total + c["w"]
    np.testing.assert_allclose((total + residual["w"]).numpy(),
                               (g["w"] * K).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_apply_matches_jax_over_steps(dtype):
    """Three EF rounds of block-int8 over two leaves, the residual carried:
    the same compressed gradients and residuals as the JAX package,
    including the cast back to a bf16 gradient inside the residual."""
    grads = [{"w": _np((10, 30), seed=10 + i), "b": _np((7,), seed=20 + i)}
             for i in range(3)]
    jdt = getattr(jnp, dtype)
    q, jq = tc.BlockInt8Quantizer(64), jc.BlockInt8Quantizer(64,
                                                            interpret=True)
    tree = {k: torch.from_numpy(v).to(getattr(torch, dtype))
            for k, v in grads[0].items()}
    r, jr = tc.init_residual(tree), jc.init_residual(
        {k: jnp.asarray(v, jdt) for k, v in grads[0].items()})
    for g in grads:
        c, r = tc.ef_apply(q, {k: torch.from_numpy(v).to(getattr(torch, dtype))
                               for k, v in g.items()}, r)
        jc_, jr = jc.ef_apply(jq, {k: jnp.asarray(v, jdt)
                                   for k, v in g.items()}, jr)
        for k in g:
            assert c[k].dtype == getattr(torch, dtype)
            assert r[k].dtype == torch.float32
            np.testing.assert_allclose(c[k].float().numpy(),
                                       np.asarray(jc_[k], np.float32),
                                       atol=1e-6)
            np.testing.assert_allclose(r[k].numpy(), np.asarray(jr[k]),
                                       atol=1e-6)


def test_ef_non_float_leaves_pass_through():
    g = {"w": torch.ones(4), "step": torch.tensor(3, dtype=torch.int32)}
    residual = tc.init_residual(g)
    assert residual["step"] is None
    c, r = tc.ef_apply(tc.BlockInt8Quantizer(64), g, residual)
    assert int(c["step"]) == 3 and r["step"] is None
    with pytest.raises(ValueError):
        tc.ef_apply(tc.BlockInt8Quantizer(64), g, {"w": None})


def test_ef_cannot_wrap_ef():
    with pytest.raises(ValueError):
        tc.ErrorFeedback(tc.ErrorFeedback(tc.Compression.int8))
    assert repr(tc.ErrorFeedback(tc.Compression.int8)) == \
        "ErrorFeedback(BlockInt8Quantizer(256,))"


# -- casts, names and the namespace -----------------------------------------------

@pytest.mark.parametrize("name,wire", [("fp16", torch.float16),
                                       ("bf16", torch.bfloat16)])
def test_cast_compressors(name, wire):
    comp = getattr(tc.Compression, name)
    x = torch.from_numpy(_np((33,)))
    payload, ctx = comp.compress(x)
    assert payload.dtype == wire and ctx == torch.float32
    assert comp.decompress(payload, ctx).dtype == torch.float32
    ints = torch.arange(4)
    assert comp.compress(ints) == (ints, None)
    same = x.to(wire)
    assert comp.compress(same)[0] is same
    ref = np.asarray(getattr(jc.Compression, name).compress(
        jnp.asarray(x.numpy()))[0].astype(jnp.float32))
    np.testing.assert_array_equal(payload.float().numpy(), ref)


def test_resolve_compressor():
    assert isinstance(tc.resolve_compressor("int8"), tc.BlockInt8Quantizer)
    assert isinstance(tc.resolve_compressor("onebit"), tc.OneBitQuantizer)
    assert tc.resolve_compressor("none") is tc.Compression.none
    assert tc.resolve_compressor(None) is tc.Compression.none
    assert tc.resolve_compressor("BF16") is tc.Compression.bf16
    assert tc.resolve_compressor("fp16") is tc.Compression.fp16
    if tc.fp8_supported():
        assert tc.resolve_compressor("fp8_e5m2").flavor == "e5m2"
        assert tc.resolve_compressor("fp8") == tc.Compression.fp8
    with pytest.raises(ValueError, match="unknown compression"):
        tc.resolve_compressor("zstd")


def test_compression_namespace_and_top_level_exports():
    assert tc.Compression.int8 == tc.BlockInt8Quantizer(256)
    assert hvd.Compression is tc.Compression
    assert hvd.ErrorFeedback is tc.ErrorFeedback
    assert hvd.Sum == tro.Sum and hvd.Average == tro.Average


def test_reduce_op_values_match_jax():
    assert {op.name: int(op) for op in tro.ReduceOp} == \
        {op.name: int(op) for op in jro.ReduceOp}
    for name in ("Average", "Sum", "Adasum", "Min", "Max", "Product"):
        assert int(getattr(tro, name)) == int(getattr(jro, name))
