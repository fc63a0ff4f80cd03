"""The port's block-int8 codec and fused optimizer kernels (their plain
versions, on the CPU) against the JAX package's Pallas kernels in
interpret mode, and against its XLA path at a block that is not a multiple
of 128. Tolerances are those of ``tests/test_fused_apply.py``: scales
within 1 ULP, codes within ±1, everything else 1e-6."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from horovod_tpu.ops import pallas_quantize as jpq

from horovod_tpu_torch.ops import quantize as tq


def _blocks(shape, seed, zero_row=None):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    return x


# [5, 256]; [33, 128] crosses the Pallas 32-row tile; an all-zero row;
# block 100 is off the Pallas gate and so meets the JAX XLA path
CASES = [((5, 256), None, True), ((33, 128), None, True),
         ((6, 256), 3, True), ((7, 100), 2, False)]
IDS = ["5x256", "33x128", "zero_row", "block100_xla"]


def _codes_close(got, ref):
    diff = np.abs(got.astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert diff.max() <= 1, diff.max()


def _scales_close(got, ref):
    np.testing.assert_array_max_ulp(got, np.asarray(ref), maxulp=1)


@pytest.mark.parametrize("shape,zero_row,interpret", CASES, ids=IDS)
def test_quantize_matches_pallas(shape, zero_row, interpret):
    x = _blocks(shape, 0, zero_row)
    vals_j, scales_j = jpq.block_quantize(jnp.asarray(x), interpret=interpret)
    vals, scales = tq.block_quantize(torch.from_numpy(x))
    assert vals.dtype == torch.int8 and scales.shape == (shape[0], 1)
    _codes_close(vals.numpy(), vals_j)
    _scales_close(scales.numpy(), scales_j)
    if zero_row is not None:
        assert float(scales[zero_row]) == 1.0
        assert not vals[zero_row].any()


@pytest.mark.parametrize("shape,zero_row,interpret", CASES, ids=IDS)
def test_quantize_ef_matches_pallas(shape, zero_row, interpret):
    x = _blocks(shape, 1, zero_row)
    vals_j, scales_j, res_j = jpq.block_quantize_ef(jnp.asarray(x),
                                                    interpret=interpret)
    vals, scales, res = tq.block_quantize_ef(torch.from_numpy(x))
    _codes_close(vals.numpy(), vals_j)
    _scales_close(scales.numpy(), scales_j)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_j), atol=1e-6)
    # the residual is what a dequantize of the same codes leaves behind
    np.testing.assert_allclose(
        res.numpy(), x - tq.block_dequantize(vals, scales).numpy(), atol=1e-6)


def test_quantize_bf16_input_matches_pallas():
    x = jnp.asarray(_blocks((33, 128), 2)).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    vals_j, scales_j = jpq.block_quantize(x, interpret=True)
    vals, scales = tq.block_quantize(xt)
    _codes_close(vals.numpy(), vals_j)
    _scales_close(scales.numpy(), scales_j)
    _, _, res_j = jpq.block_quantize_ef(x, interpret=True)
    _, _, res = tq.block_quantize_ef(xt)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_j), atol=1e-6)


def _codes(shape, seed, zero_row=None):
    """The same int8 codes and scales for both packages."""
    vals, scales = tq.block_quantize(torch.from_numpy(
        _blocks(shape, seed, zero_row)))
    return vals.numpy(), scales.numpy()


@pytest.mark.parametrize("shape,zero_row,interpret", CASES, ids=IDS)
def test_dequantize_matches_pallas(shape, zero_row, interpret):
    v, s = _codes(shape, 3, zero_row)
    ref = jpq.block_dequantize(jnp.asarray(v), jnp.asarray(s),
                               interpret=interpret)
    got = tq.block_dequantize(torch.from_numpy(v), torch.from_numpy(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["sgd0", "sgd"])
@pytest.mark.parametrize("shape,zero_row,interpret", CASES, ids=IDS)
def test_fused_sgd_matches_pallas(shape, zero_row, interpret, momentum):
    v, s = _codes(shape, 4, zero_row)
    mom = _blocks(shape, 5) if momentum else None
    delta_j, nm_j = jpq.fused_sgd_apply(
        jnp.asarray(v), jnp.asarray(s),
        None if mom is None else jnp.asarray(mom), 0.1, momentum,
        interpret=interpret)
    delta, nm = tq.fused_sgd_apply(
        torch.from_numpy(v), torch.from_numpy(s),
        None if mom is None else torch.from_numpy(mom.copy()), 0.1, momentum)
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_j), atol=1e-6)
    if momentum:
        np.testing.assert_allclose(nm.numpy(), np.asarray(nm_j), atol=1e-6)
    else:
        assert nm is None and nm_j is None


@pytest.mark.parametrize("shape,zero_row,interpret", CASES, ids=IDS)
def test_fused_adam_matches_pallas(shape, zero_row, interpret):
    v, s = _codes(shape, 6, zero_row)
    m = _blocks(shape, 7) * 0.1
    vel = np.abs(_blocks(shape, 8)) * 0.01
    hp = (1e-3, 0.9, 0.999, 1e-8, 1 - 0.9 ** 3, 1 - 0.999 ** 3)
    ref = jpq.fused_adam_apply(jnp.asarray(v), jnp.asarray(s),
                               jnp.asarray(m), jnp.asarray(vel), *hp,
                               interpret=interpret)
    got = tq.fused_adam_apply(torch.from_numpy(v), torch.from_numpy(s),
                              torch.from_numpy(m), torch.from_numpy(vel), *hp)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_wrappers_leave_their_operands_untouched():
    """As the JAX functions: new tensors out, the operands as they were."""
    v, s = _codes((9, 128), 9)
    vt, st = torch.from_numpy(v), torch.from_numpy(s)
    mom = torch.from_numpy(_blocks((9, 128), 10))
    m = torch.from_numpy(_blocks((9, 128), 13)) * 0.1
    vel = torch.from_numpy(np.abs(_blocks((9, 128), 14))) * 0.01
    x = torch.from_numpy(_blocks((9, 128), 11))
    operands = [vt, st, mom, m, vel, x]
    before = [t.clone() for t in operands]
    _, nm = tq.fused_sgd_apply(vt, st, mom, 0.1, 0.9)
    got = tq.fused_adam_apply(vt, st, m, vel, 1e-3, 0.9, 0.999, 1e-8, 0.1,
                              0.001)
    _, _, res = tq.block_quantize_ef(x)
    for t, b in zip(operands, before):
        assert torch.equal(t, b)
    assert not torch.equal(nm, mom)
    assert not torch.equal(got[1], m) and not torch.equal(got[2], vel)
    assert torch.equal(res, tq.plain_quantize_ef(x)[2])


def test_rounding_is_half_to_even():
    # scale = 127/127 = 1, so x / scale is exactly x: halves go to even
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    vals, scales = tq.block_quantize(x)
    assert float(scales) == 1.0
    assert vals.tolist() == [[0, 2, 2, 0, -2, 127]]


def test_cpu_calls_never_count_launches():
    before = [f.launches for f in tq.LAUNCHERS]
    x = torch.from_numpy(_blocks((4, 256), 12))
    vals, scales, _ = tq.block_quantize_ef(x)
    tq.block_quantize(x)
    tq.block_dequantize(vals, scales)
    tq.fused_sgd_apply(vals, scales, None, 0.1, 0.0)
    tq.fused_sgd_apply(vals, scales, torch.zeros(4, 256), 0.1, 0.9)
    tq.fused_adam_apply(vals, scales, torch.zeros(4, 256),
                        torch.zeros(4, 256), 1e-3, 0.9, 0.999, 1e-8, 0.1,
                        0.001)
    assert [f.launches for f in tq.LAUNCHERS] == before


@pytest.mark.parametrize("call", [
    lambda: tq.block_quantize(torch.zeros(4)),
    lambda: tq.block_quantize(torch.zeros(4, 0)),
    lambda: tq.block_dequantize(torch.zeros(4, 8, dtype=torch.int8),
                                torch.ones(3, 1)),
    lambda: tq.fused_sgd_apply(torch.zeros(4, 8, dtype=torch.int8),
                               torch.ones(4, 1), torch.zeros(4, 9), 0.1, 0.9),
    lambda: tq.fused_adam_apply(torch.zeros(4, 8, dtype=torch.int8),
                                torch.ones(4, 1), torch.zeros(4, 8),
                                torch.zeros(4, 9), 1e-3, 0.9, 0.999, 1e-8,
                                0.1, 0.001),
], ids=["1d", "block0", "scales", "mom", "vel"])
def test_shape_errors(call):
    with pytest.raises(ValueError):
        call()
