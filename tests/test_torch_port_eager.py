"""The port's eager collective API against the JAX package's, on the CPU.

The single-process cases are ``tests/test_collectives_eager.py``'s, each
run through both packages on the same seeded input (the same bytes come
back, in the input's dtype). The multi-rank cases are
``hvd_worker.py``'s and ``quantized_worker.py``'s over gloo worlds of the
port (``torch_port_eager_worker.py``), on the core and on the
``torch.distributed`` plane, plus the timeline spans of the eager
collectives."""

import json
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_eager_worker as ew  # noqa: E402
from torch_port_worker import REPO, build_core, spawn_world  # noqa: E402

EAGER_WORKER = os.path.join(REPO, "tests", "torch_port_eager_worker.py")


@pytest.fixture(scope="module", autouse=True)
def _core_built():
    """The core is built before any world starts (a cold build under load
    must not eat a world's timeout)."""
    build_core()

# (numpy dtype for the JAX package, torch dtype for the port)
DTYPES = [(np.uint8, torch.uint8), (np.int8, torch.int8),
          (np.int32, torch.int32), (np.int64, torch.int64),
          (np.float16, torch.float16), (ml_dtypes.bfloat16, torch.bfloat16),
          (np.float32, torch.float32), (np.float64, torch.float64),
          (np.bool_, torch.bool)]
SHAPES = [(), (0,), (1,), (7, 3), (256,)]


@pytest.fixture
def phvd(hvd, monkeypatch):
    """The port in a world of one beside the JAX package's (``hvd``)."""
    import horovod_tpu_torch as phvd
    phvd.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    phvd.init()
    yield phvd
    phvd.shutdown()


def _to_torch(x: np.ndarray, tdt: torch.dtype) -> torch.Tensor:
    x = np.ascontiguousarray(x).reshape(x.shape)   # keeps a 0-d array 0-d
    if tdt == torch.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[1]))
@pytest.mark.parametrize("shape", SHAPES)
def test_allreduce_dtype_shape_identity(hvd, phvd, dtypes, shape):
    """A world of one: every dtype and shape class comes back as it went,
    in its dtype, for sum, min and max, as from the JAX package."""
    ndt, tdt = dtypes
    n = int(np.prod(shape, dtype=np.int64))
    x = (np.arange(n, dtype=np.int64) % 2).reshape(shape).astype(ndt)
    for jop, pop in ((hvd.Sum, phvd.Sum), (hvd.Min, phvd.Min),
                     (hvd.Max, phvd.Max)):
        ref = np.asarray(hvd.allreduce(x, op=jop))
        out = phvd.allreduce(_to_torch(x, tdt), op=pop)
        assert out.dtype == tdt and tuple(out.shape) == shape
        assert _bytes(out) == ref.tobytes()


@pytest.mark.parametrize("dtypes", DTYPES[4:8], ids=lambda d: str(d[1]))
def test_allreduce_average_identity_floats(hvd, phvd, dtypes):
    ndt, tdt = dtypes
    x = np.arange(6, dtype=np.float64).astype(ndt)
    out = phvd.allreduce(_to_torch(x, tdt), op=phvd.Average)
    assert out.dtype == tdt
    assert _bytes(out) == np.asarray(hvd.allreduce(x, op=hvd.Average)
                                     ).tobytes()


def test_fractional_int_scale_rejected(phvd):
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        phvd.allreduce(x, op=phvd.Sum, prescale_factor=0.5)
    with pytest.raises(ValueError):
        phvd.grouped_allreduce([x], op=phvd.Sum, prescale_factor=0.5)
    with pytest.raises(ValueError):
        phvd.allreduce(x, op=phvd.Average)


def test_allreduce_ops_and_scaling_match_jax(hvd, phvd):
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    for jop, pop in ((hvd.Sum, phvd.Sum), (hvd.Average, phvd.Average),
                     (hvd.Min, phvd.Min), (hvd.Max, phvd.Max),
                     (hvd.Product, phvd.Product)):
        assert _bytes(phvd.allreduce(torch.from_numpy(x), op=pop)) == \
            np.asarray(hvd.allreduce(x, op=jop)).tobytes()
    ref = hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                        postscale_factor=3.0)
    out = phvd.allreduce(torch.from_numpy(x), op=phvd.Sum,
                         prescale_factor=2.0, postscale_factor=3.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        phvd.allreduce(torch.ones(2), average=True, op=phvd.Sum)


def test_grouped_allgather_broadcast_alltoall(hvd, phvd):
    outs = phvd.grouped_allreduce([torch.ones(3), torch.arange(4.0)],
                                  op=phvd.Sum)
    assert len(outs) == 2 and torch.equal(outs[1], torch.arange(4.0))
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(phvd.allgather(x), x)
    assert torch.equal(phvd.broadcast(torch.arange(4.0), root_rank=0),
                       torch.arange(4.0))
    with pytest.raises(ValueError):
        phvd.broadcast(torch.arange(4.0), root_rank=1)
    out, recv = phvd.alltoall(torch.arange(10.0), splits=[10])
    assert torch.equal(out, torch.arange(10.0)) and recv.tolist() == [10]
    rs = phvd.reducescatter(torch.ones(4, 2))
    assert torch.equal(rs, torch.ones(4, 2))


def test_async_handles_join_barrier(phvd):
    h = phvd.allreduce_async(torch.ones(2), op=phvd.Sum)
    assert phvd.poll(h)
    assert torch.equal(phvd.synchronize(h), torch.ones(2))
    assert phvd.join() == 0
    phvd.barrier()
    # a world of one needs no engine: the local backend, no counters
    assert phvd.metrics_snapshot()["engine"] == {}


def test_eager_api_counts_and_records(phvd):
    """Each call counts on ``hvd_collective_calls_total{kind}`` and
    flight-records its enqueue and completion with its span id."""
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.metrics.registry import default_registry
    phvd.allreduce(torch.ones(2), name="counted")
    snap = default_registry().snapshot()
    key = [k for k in snap if k.startswith("hvd_collective_calls_total")
           and "allreduce" in k]
    assert key, sorted(snap)[:20]
    events = [e for e in recorder().events()
              if e.get("name") == "counted"]
    kinds = [e["kind"] for e in events]
    assert "enqueue" in kinds and "complete" in kinds, events
    assert all(e["span"] == "counted#1" for e in events)


@pytest.mark.parametrize("n,plane", [(2, "core"), (3, "core"), (2, "dist")])
def test_hvd_full_stack(tmp_path, n, plane):
    """``hvd_worker.py`` over gloo worlds: allreduce (sum, average),
    broadcast_parameters/object, allgather_object, the eager optimizer,
    ragged allgather, alltoall, a registered set, reducescatter, async
    handles and join (refused by the dist plane)."""
    res = spawn_world(EAGER_WORKER, "hvd", n, tmp_path,
                      extra_env={"HVD_TPU_EAGER_BACKEND": plane}, timeout=90)
    for r in range(n):
        np.testing.assert_array_equal(
            res[r]["x"], sum(np.arange(8.0, dtype=np.float32) + k
                             for k in range(n)))


@pytest.mark.parametrize("plane", ["core", "dist"])
def test_quantized_allreduce_matches_the_jax_codec(tmp_path, plane):
    """``quantized_worker.py``: the int8 quantized allreduce is the sum
    over ranks of each contribution's quantize-dequantize by the JAX codec
    (rtol 1e-5, atol 1e-5, as there), and the average of a group."""
    import horovod_tpu.compression as jc
    import jax.numpy as jnp
    res = spawn_world(EAGER_WORKER, "quantized", 2, tmp_path,
                      extra_env={"HVD_TPU_EAGER_BACKEND": plane}, timeout=90)
    q = jc.BlockInt8Quantizer(interpret=True)

    def qdq(x):
        return np.asarray(q.qdq(jnp.asarray(x)))

    expect = sum(qdq(ew.rank_tensor(r)) for r in range(2))
    expect_y = sum(qdq(ew.rank_tensor(r, seed=100)) for r in range(2)) / 2
    for r in range(2):
        np.testing.assert_allclose(res[r]["sum"], expect, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res[r]["avg_y"].reshape(-1), expect_y,
                                   rtol=1e-5, atol=1e-5)


def test_eager_collectives_leave_spans_on_the_timeline(tmp_path):
    """With ``HVD_TPU_TIMELINE_ALL_RANKS`` each rank's shard holds a
    begin/end span per eager collective on the tensor's track, and the
    ranks give one collective the same span id."""
    tl = tmp_path / "tl.json"
    spawn_world(EAGER_WORKER, "spans", 2, tmp_path, extra_env={
        "HVD_TPU_TIMELINE": str(tl), "HVD_TPU_TIMELINE_ALL_RANKS": "1"},
        timeout=90)
    spans = {}
    for r in range(2):
        text = (tmp_path / f"tl.json.rank{r}.json").read_text().strip()
        events = json.loads(text if text.endswith("]") else
                            text.rstrip(",") + "]")
        begins = {(e["tid"], e["args"]["span"]) for e in events
                  if e.get("ph") == "B" and e.get("cat") == "collective"}
        ends = {(e["tid"], e["args"]["span"]) for e in events
                if e.get("ph") == "E" and e.get("cat") == "collective"}
        assert begins == ends and len(begins) == 5, events
        spans[r] = begins
    assert spans[0] == spans[1]
    assert ("step.2", "step.2#1") in spans[0]
