"""The port's metrics plane against the JAX package's, on the CPU.

Each test drives a JAX module and its copy in ``horovod_tpu_torch`` with
the same inputs (numpy seeds, or a fixed script of events under a scripted
clock) and holds the two to each other: the registry (snapshots and the
Prometheus text, byte for byte), the step time series (the JSONL apart
from ``ts``, and each side reading the other's directory), the goodput
ledger (closed-window records), the anomaly engine (the findings), the
compression byte counters (against ``device_allreduce(compression=int8)``
on a dp=2 mesh, the port over a 2-rank gloo world), the bucket gauges, the
guard's skip counter and flight event, and the MFU helpers.

Every test starts and ends with fresh process-wide state: the port's
registry, flight ring, time series, goodput ledger, anomaly engine and
profile manager, and the JAX package's time series, goodput ledger and
anomaly engine. The state is global, and a value left behind by one test
must not decide another. The JAX registry is not cleared (its compression
metrics keep their instruments beyond it, and later JAX tests in the same
process read them): JAX-side checks read fresh ``Registry`` objects, values
that are set, or differences.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.diagnostics import flight_recorder as j_flight
from horovod_tpu.metrics import anomaly as j_anomaly
from horovod_tpu.metrics import goodput as j_goodput
from horovod_tpu.metrics import registry as j_registry
from horovod_tpu.metrics import timeseries as j_timeseries
from horovod_tpu import profiling as j_profiling
from horovod_tpu_torch.diagnostics import flight_recorder as t_flight
from horovod_tpu_torch.metrics import anomaly as t_anomaly
from horovod_tpu_torch.metrics import goodput as t_goodput
from horovod_tpu_torch.metrics import registry as t_registry
from horovod_tpu_torch.metrics import timeseries as t_timeseries
from horovod_tpu_torch import profiling as t_profiling

PACKAGES = {
    "jax": (j_registry, j_flight, j_timeseries, j_goodput, j_anomaly,
            j_profiling),
    "torch": (t_registry, t_flight, t_timeseries, t_goodput, t_anomaly,
              t_profiling),
}


def reset_observability():
    t_registry.default_registry().clear()
    t_flight.recorder().clear()
    t_profiling.reset()
    for _, _, ts, gp, an, _ in PACKAGES.values():
        ts.reset()
        gp.reset()
        an.reset()


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_PROFILE_ON_ANOMALY", "0")
    monkeypatch.setenv("HVD_TPU_AUTOPILOT", "off")
    monkeypatch.setenv("HVD_TPU_PROFILE_DIR", str(tmp_path / "profile"))
    monkeypatch.delenv("HVD_TPU_OBS_DIR", raising=False)
    monkeypatch.delenv("HVD_TPU_GOODPUT_WINDOW", raising=False)
    reset_observability()
    yield
    reset_observability()


# -- registry -------------------------------------------------------------------

def _drive_registry(mod, seed):
    """One fixed script of operations on a fresh registry: counters,
    gauges of every aggregation, histograms (default and custom bounds,
    values past the last bound), labels that need escaping."""
    rng = np.random.RandomState(seed)
    reg = mod.Registry()
    c = reg.counter("hvd_steps_total", help="training steps completed")
    for v in rng.randint(0, 5, 7):
        c.inc(float(v))
    lab = {"codec": 'in"t8\\x', "rank": "3"}
    reg.counter("hvd_compression_pre_bytes_total", help="bytes",
                labels=lab).inc(float(rng.randint(1, 1 << 30)))
    for agg in (None, "sum", "max", "min", "mean"):
        g = reg.gauge(f"hvd_g_{agg or 'last'}", help="a gauge", agg=agg)
        g.set(float(rng.randn()))
        g.inc(0.25)
    h = reg.histogram("hvd_step_time_seconds", help="training step wall time")
    for v in np.abs(rng.randn(50)) * 10.0 ** rng.randint(-4, 3, 50):
        h.observe(float(v))
    h.observe(1e6)                                   # the +Inf slot
    hc = reg.histogram("hvd_compile_seconds", labels={"function": "f"},
                       buckets=(0.5, 0.1, 2.0))
    for v in (0.05, 0.1, 0.3, 3.0):
        hc.observe(v)
    reg.gauge("hvd_unhelped")
    return reg


def test_registry_snapshot_and_text_are_the_jax_packages():
    """The same operations give equal snapshots and byte-identical
    Prometheus text; merging two workers' snapshots agrees too (counters
    and histograms add, gauges by their agg)."""
    snaps = {}
    for name, mods in PACKAGES.items():
        reg_mod = mods[0]
        a, b = _drive_registry(reg_mod, 0), _drive_registry(reg_mod, 1)
        snaps[name] = (a.snapshot(), b.snapshot())
        merged = reg_mod.Registry.merge(snaps[name])
        snaps[name] += (merged, reg_mod.render_prometheus(snaps[name][0]),
                        reg_mod.render_prometheus(merged))
    for j, t in zip(snaps["jax"], snaps["torch"]):
        assert j == t
    text = snaps["torch"][3]
    assert 'hvd_compression_pre_bytes_total{codec="in\\"t8\\\\x",rank="3"}' \
        in text
    assert 'hvd_step_time_seconds_bucket{le="+Inf"} 51' in text


@pytest.mark.parametrize("conflict", ["type", "agg", "buckets"])
def test_registry_refuses_the_same_conflicts(conflict):
    for name, mods in PACKAGES.items():
        reg = mods[0].Registry()
        reg.gauge("hvd_x", agg="sum")
        reg.histogram("hvd_h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            if conflict == "type":
                reg.counter("hvd_x")
            elif conflict == "agg":
                reg.gauge("hvd_x", agg="max")
            else:
                reg.histogram("hvd_h", buckets=(1.0, 3.0))
        assert reg.get("hvd_x").agg == "sum"
        assert reg.get("hvd_missing") is None


def test_registry_merge_rejects_mismatched_histograms():
    for mods in PACKAGES.values():
        reg_mod = mods[0]
        a = reg_mod.Registry()
        a.histogram("hvd_h", buckets=(1.0,)).observe(0.5)
        b = reg_mod.Registry()
        b.histogram("hvd_h", buckets=(2.0,)).observe(0.5)
        with pytest.raises(ValueError):
            reg_mod.Registry.merge([a.snapshot(), b.snapshot()])


# -- time series ------------------------------------------------------------------

def _series_script(mod):
    rng = np.random.RandomState(5)
    for step in range(1, 9):
        mod.record_step(step, float(rng.uniform(0.01, 0.2)),
                        units=2048.0 if step % 3 else 0.0,
                        exposed=float(rng.uniform(0, 0.01)), skipped=None)
    mod.record_point({"goodput": {"compute": 1.25, "input_wait": 0.5},
                      "goodput_fraction": 0.7143})


def _lines_without_ts(path):
    with open(path) as f:
        docs = [json.loads(line) for line in f]
    for d in docs:
        d.pop("ts")
    return docs


def test_series_files_are_the_jax_format_both_ways(tmp_path, monkeypatch):
    """The same script of steps (and one free-form point) writes the same
    JSONL apart from ``ts``; each package's ``read_series`` reads the
    other's directory to the same points."""
    dirs = {}
    for name, mods in PACKAGES.items():
        d = tmp_path / name
        monkeypatch.setenv("HVD_TPU_OBS_DIR", str(d))
        ts_mod = mods[2]
        ts_mod.reset()
        _series_script(ts_mod)
        ts_mod.reset()                       # closes the file
        dirs[name] = d
    assert _lines_without_ts(dirs["jax"] / "obs_rank0.jsonl") == \
        _lines_without_ts(dirs["torch"] / "obs_rank0.jsonl")
    for d in dirs.values():
        j_pts = j_timeseries.read_series(str(d))
        t_pts = t_timeseries.read_series(str(d))
        assert j_pts == t_pts and len(t_pts) == 9
        assert j_timeseries.read_series(str(d), rank=0) == \
            t_timeseries.read_series(str(d), rank=0)


def test_series_rotation_and_torn_tail_read_alike(tmp_path):
    """A writer over its byte budget rotates to ``.1``; a torn last line is
    skipped; both readers agree."""
    w = t_timeseries.SeriesWriter(str(tmp_path), rank=2, max_bytes=200)
    for i in range(12):
        assert w.write({"ts": float(i), "step": i, "step_time_s": 0.5})
    w.close()
    assert os.path.exists(tmp_path / "obs_rank2.jsonl.1")
    with open(tmp_path / "obs_rank2.jsonl", "a") as f:
        f.write('{"ts": 99, "ste')
    got = t_timeseries.read_series(str(tmp_path))
    assert got == j_timeseries.read_series(str(tmp_path))
    steps = [p["step"] for p in got]
    assert steps == sorted(steps) and steps[-1] == 11 and len(steps) < 12
    assert all(p["rank"] == 2 for p in got)


# -- goodput ----------------------------------------------------------------------

class _Clock:
    """A scripted ``time`` module: ``perf_counter`` advances only when the
    script says so."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


# (gap before the step, step seconds, exposed comm, guard skip?, compile s)
GOODPUT_SCRIPT = [
    (0.0, 0.50, 0.00, False, 0.30),    # first step builds a kernel library
    (0.02, 0.10, 0.01, False, 0.0),
    (0.30, 0.10, 0.02, False, 0.0),    # a slow loader
    (0.01, 0.12, 0.03, True, 0.0),     # the guard threw the update away
    (0.01, 0.10, 0.20, False, 0.0),    # exposed past the step: clamped
    (0.05, 0.11, 0.01, False, 0.05),   # a build between steps
    (0.01, 0.10, 0.00, False, 0.0),
]


def _run_goodput(mods, monkeypatch):
    reg_mod, gp = mods[0], mods[3]
    clock = _Clock()
    compiled = [0.0]
    monkeypatch.setattr(gp, "time", clock)
    monkeypatch.setattr(gp, "_compile_seconds_total", lambda: compiled[0])
    reg = reg_mod.default_registry()
    led = gp.GoodputLedger(window_steps=3, tolerance=0.01)
    guard = reg.counter("hvd_guard_skipped_steps_total")
    exposed = reg.gauge("hvd_overlap_exposed_comm_seconds")
    for gap, dt, exp, skip, comp in GOODPUT_SCRIPT:
        clock.t += gap
        if gap and comp:
            compiled[0] += comp          # landed between the steps
        led.note_step_begin()
        clock.t += dt
        if not gap and comp:
            compiled[0] += comp          # landed inside the step
        exposed.set(exp)
        if skip:
            guard.inc()
        led.note_step_end(dt)
    last = led.flush()
    return list(led.recent), led.snapshot(), last


def test_goodput_windows_are_the_jax_packages(monkeypatch):
    """Under one scripted clock and the same feeds (step envelopes, the
    exposed-comm gauge, the guard counter, compile seconds) both ledgers
    close the same windows: equal records, category by category."""
    got = {name: _run_goodput(mods, monkeypatch)
           for name, mods in PACKAGES.items()}
    assert got["jax"] == got["torch"]
    recent, snap, _ = got["torch"]
    assert snap["windows"] == 3 and snap["books_violations"] == 0
    assert recent[0]["seconds"]["compile"] == pytest.approx(0.30)
    assert recent[1]["seconds"]["guard_skipped"] == pytest.approx(0.12)
    assert recent[0]["seconds"]["input_wait"] == pytest.approx(0.32)
    for rec in recent:
        assert sum(rec["seconds"].values()) == pytest.approx(rec["wall_s"])
    reg = t_registry.default_registry().snapshot()
    assert 'hvd_goodput_seconds_total{category="remesh_recovery"}' in reg


# -- anomaly engine ---------------------------------------------------------------

def _series(seed):
    """Step times with a step-time drift and a throughput drop in the
    middle, an exposed-comm fraction that grows late, and goodput
    fractions that fall."""
    rng = np.random.RandomState(seed)
    dt = 0.1 + 0.002 * rng.randn(80)
    dt[30:40] *= 3.0
    exposed = 0.01 + 0.001 * rng.randn(80)
    exposed[60:] = 0.08
    good = np.clip(0.8 + 0.01 * rng.randn(30), 0, 1)
    good[20:] = 0.3
    return dt, exposed, good


@pytest.mark.parametrize("seed", [0, 1])
def test_anomaly_findings_are_the_jax_packages(seed):
    dt, exposed, good = _series(seed)
    found = {}
    for name, mods in PACKAGES.items():
        eng = mods[4].AnomalyEngine(registry=mods[0].Registry())
        for i, (d, e) in enumerate(zip(dt, exposed)):
            eng.observe_step(i + 1, float(d), units_per_s=2048.0 / float(d),
                             exposed_comm_s=float(e) * float(d))
        for g in good:
            eng.observe_goodput(float(g), dominating="input_wait")
        found[name] = [{k: v for k, v in f.items()
                        if k not in ("ts", "trace", "span", "traceparent")}
                       for f in eng.recent_findings()]
    assert found["jax"] == found["torch"]
    kinds = [(f["kind"], f.get("step")) for f in found["torch"]]
    assert ("step_time_drift", 33) in kinds
    assert ("throughput_regression", 33) in kinds
    assert any(k == "exposed_comm_growth" for k, _ in kinds)
    assert any(k == "goodput_regression" for k, _ in kinds)


def test_a_finding_lands_on_counter_flight_and_trace():
    """report_finding takes the engine's path: the counter, the flight
    event (``detector``, stamped with the finding's trace) and the
    findings list."""
    f = t_anomaly.report_finding("hbm_growth", bytes_in_use=5)
    reg = t_registry.default_registry().snapshot()
    assert reg['hvd_anomaly_total{kind="hbm_growth"}']["value"] == 1.0
    ev = [e for e in t_flight.recorder().events() if e["kind"] == "anomaly"]
    assert len(ev) == 1 and ev[0]["detector"] == "hbm_growth"
    assert ev[0]["trace"] == f["trace"] and len(f["trace"]) == 32
    assert t_anomaly.recent_findings()[-1]["bytes_in_use"] == 5


# -- compression byte counters ------------------------------------------------------

@pytest.fixture(scope="module")
def metrics_world(tmp_path_factory):
    from test_torch_port_dp import spawn
    return spawn("metrics", 2, tmp_path_factory.mktemp("metrics"))


@pytest.fixture(scope="module")
def mesh2():
    from horovod_tpu.parallel.mesh import build_mesh
    return build_mesh(dp=2, devices=jax.devices()[:2])


def test_mesh_int8_bytes_are_device_allreduces(metrics_world, mesh2):
    """``preduce_quantized`` on a 2-rank gloo world counts the bytes JAX's
    ``device_allreduce(compression=int8)`` counts on a dp=2 mesh, tensor
    by tensor (padding of the last block included), at the same ratio."""
    from test_torch_port_dp import metric_inputs
    from horovod_tpu.compression.metrics import _codec_instruments
    from horovod_tpu.compression.quantizers import BlockInt8Quantizer
    from horovod_tpu.ops.mesh_collectives import device_allreduce
    from horovod_tpu.ops.reduce_op import ReduceOp
    instruments = _codec_instruments("int8")
    pre, wire, _ = instruments
    saved = [inst.value for inst in instruments]
    try:
        for i, x in enumerate(metric_inputs()):
            before = (pre.value, wire.value)
            device_allreduce(jnp.asarray(x), mesh2, "dp", ReduceOp.AVERAGE,
                             compression=BlockInt8Quantizer(256))
            want = (pre.value - before[0], wire.value - before[1])
            for r in metrics_world:
                got = (float(r[f"mesh{i}_pre_bytes_total"]),
                       float(r[f"mesh{i}_wire_bytes_total"]))
                assert got == want, (i, got, want)
                assert float(r[f"mesh{i}_ratio"]) == want[0] / want[1]
    finally:
        # leave the JAX package's cumulative int8 counters as they were:
        # these small tensors compress worse than block-sized ones, and
        # tests/test_compression.py reads the process's cumulative ratio
        for inst, value in zip(instruments, saved):
            with inst._lock:
                inst._value = value


def test_eager_int8_bytes_are_quantized_grouped_allreduces(metrics_world):
    """The eager optimizer's quantized sync counts each leaf's bytes before
    and the JAX quantizer's payload (values plus scales) after, as
    ``quantized_grouped_allreduce`` does; its sync lands on the overlap
    gauges, exposed seconds within the sync's."""
    from test_torch_port_dp import param_tree
    from horovod_tpu.compression.quantizers import BlockInt8Quantizer
    q = BlockInt8Quantizer(256)
    tree = param_tree(np.random.RandomState(100))
    pre = sum(v.size * v.itemsize for v in tree.values())
    wire = sum(q.quantize(jnp.asarray(v))[0].wire_bytes
               for v in tree.values())
    for r in metrics_world:
        assert float(r["eager_pre_bytes_total"]) == pre
        assert float(r["eager_wire_bytes_total"]) == wire
        assert 0.0 < float(r["eager_exposed"]) <= float(r["eager_sync"])
        assert float(r["eager_bucket_count"]) == 1.0
        assert int(r["codec_events"]) == 1


@pytest.mark.parametrize("codec,shape", [
    ("int8", (1024,)), ("int8", (3, 301)), ("int8", (1,)),
    ("int8_100", (517,)), ("fp8", (33, 7)), ("onebit", (1001,)),
    ("onebit", (8,))])
def test_static_wire_bytes_are_jax_quantized_wire_bytes(codec, shape):
    """Each port quantizer's ``wire_bytes(numel)`` equals JAX's
    ``_quantized_wire_bytes`` (an abstract trace of its quantize) and the
    payload its own ``quantize`` returns."""
    from horovod_tpu.compression import quantizers as jq
    from horovod_tpu.ops.mesh_collectives import _quantized_wire_bytes
    from horovod_tpu_torch.compression import quantizers as tq
    make = {"int8": (lambda m: m.BlockInt8Quantizer(256)),
            "int8_100": (lambda m: m.BlockInt8Quantizer(100)),
            "fp8": (lambda m: m.FP8Quantizer("e4m3")),
            "onebit": (lambda m: m.OneBitQuantizer())}[codec]
    if codec == "fp8" and not (tq.fp8_supported()
                               and hasattr(jnp, "float8_e4m3fn")):
        pytest.skip("no fp8 dtypes in this build")
    want = _quantized_wire_bytes(make(jq), shape, "float32")
    tquant = make(tq)
    n = int(np.prod(shape))
    assert tquant.wire_bytes(n) == want
    q, _ = tquant.quantize(torch.randn(*shape))
    assert q.wire_bytes == want


def test_compression_ratio_is_cumulative_pre_over_wire():
    """Two transfers: the ratio is the byte sums' quotient, on the gauge and
    from ``compression_ratio``; the codec's first transfer alone is a
    ``codec_choice`` event; a codec never seen reads 0.0."""
    from horovod_tpu_torch.compression.metrics import (compression_ratio,
                                                       record_compression)
    codec = "ratio_probe"              # a codec no other test records
    record_compression(codec, 1024, 260)
    record_compression(codec, 4096, 1040)
    assert compression_ratio(codec) == 5120 / 1300
    key = f'hvd_compression_ratio{{codec="{codec}"}}'
    snap = t_registry.default_registry().snapshot()
    assert (snap[key]["value"], snap[key]["agg"]) == (5120 / 1300, "mean")
    events = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
              for e in t_flight.recorder().events()
              if e["kind"] == "codec_choice"]
    assert events == [{"kind": "codec_choice", "codec": codec,
                       "pre_bytes": 1024, "wire_bytes": 260}]
    assert compression_ratio("never_recorded") == 0.0


# -- bucket gauges ------------------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 64 << 10, 1])
def test_plan_gauges_are_the_jax_packages(budget):
    """The tiny flagship's plan in both packages (the port's parameters
    in the JAX flatten order) lands on equal ``hvd_overlap_bucket_*``
    gauges."""
    from __graft_entry__ import _flagship_cfg as jax_cfg
    from horovod_tpu.models import init_params
    from horovod_tpu.train.buckets import plan_buckets as j_plan
    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.models import Transformer, from_jax_params
    from horovod_tpu_torch.train.buckets import plan_buckets as t_plan
    from horovod_tpu_torch.train.overlap import jax_ordered_parameters
    params = init_params(np.random.RandomState(0), jax_cfg(tiny=True), 1)
    model = Transformer(_flagship_cfg(tiny=True), device="cpu")
    model.load_state_dict(from_jax_params(params))
    jp = j_plan(params, budget)
    tp = t_plan(jax_ordered_parameters(model)[1], budget)
    vals = {}
    for name, mods in PACKAGES.items():
        snap = mods[0].default_registry().snapshot()
        vals[name] = (snap["hvd_overlap_bucket_count"]["value"],
                      snap["hvd_overlap_bucket_bytes"]["value"])
    assert vals["jax"] == vals["torch"] == (jp.num_buckets, jp.total_bytes)
    assert tp.num_buckets == jp.num_buckets


# -- guard ----------------------------------------------------------------------------

def test_a_nan_step_is_counted_and_recorded_like_jax():
    """One step whose gradients hold a NaN among clean ones: both guards
    count one skip and record one ``guard_skip`` event (step 1, first in a
    row)."""
    from horovod_tpu.train.guard import GuardedStep as JGuardedStep
    from horovod_tpu.train.guard import GuardSpec as JGuardSpec
    from horovod_tpu.train.guard import grads_ok as j_ok
    from horovod_tpu_torch.train.guard import GuardedStep, GuardSpec, grads_ok
    rng = np.random.RandomState(7)
    steps = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    steps[1][2, 1] = np.nan
    jspec, tspec = JGuardSpec(), GuardSpec()
    j_counter = j_registry.default_registry().counter(
        "hvd_guard_skipped_steps_total")
    j_before = j_counter.value
    j_events = j_flight.recorder().events()
    j_seq = j_events[-1]["seq"] if j_events else 0
    jstep = JGuardedStep(
        lambda p, o, g, inj: (p, o, 0.0, j_ok({"g": jnp.asarray(g)}, jspec)),
        jspec, canary=None)
    tstep = GuardedStep(
        lambda m, o, g: (m, o, 0.0, bool(grads_ok([torch.from_numpy(g)],
                                                  tspec))), tspec)
    for g in steps:
        jstep(None, None, g)
        tstep(None, None, g)
    jstep.flush()
    tstep.flush()
    assert jstep.observer.skipped == tstep.skipped == 1
    assert j_counter.value - j_before == 1.0
    snap = t_registry.default_registry().snapshot()
    assert snap["hvd_guard_skipped_steps_total"]["value"] == 1.0
    ev = {name: [{k: v for k, v in e.items() if k not in ("ts", "seq")}
                 for e in mods[1].recorder().events()
                 if e["kind"] == "guard_skip"
                 and (name == "torch" or e["seq"] > j_seq)]
          for name, mods in PACKAGES.items()}
    assert ev["jax"] == ev["torch"] == [
        {"kind": "guard_skip", "step": 1, "consecutive": 1}]


# -- mfu ------------------------------------------------------------------------------

@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA H100 PCIe", 756e12), ("cpu", None), ("TPU v5 lite", None),
    ("TPU v4", None), ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_table_holds_the_h100_rows_only(name, peak):
    from horovod_tpu_torch.metrics import mfu
    assert mfu.peak_flops(name) == peak


def test_no_peak_without_a_card():
    from horovod_tpu_torch.metrics import mfu
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert mfu.device_peak_flops() is None
    assert mfu.mfu(1e12, 0.1) is None
    assert mfu.mfu(1e12, 0.1, peak=1e14) == pytest.approx(0.1)


def test_flop_count_of_the_tiny_step_against_jax_and_analytic():
    """The port counts the tiny flagship's forward and backward
    (``make_grad_fn``, B 2, S 32) at 62,947,328 FLOPs. JAX's
    ``hlo_flops_per_device`` of the same jitted step gives 21,255,350 on
    this CPU: XLA counts a ``lax.scan`` body once, and the layers are a
    scan, so the two are not comparable (ratio 2.96). The port's count is
    held to the analytic 6·N·T + attention (60,088,320) within 10%
    instead: measured 1.048, the backward recomputing q·kᵀ and skipping
    no diagonal block."""
    from __graft_entry__ import _flagship_cfg as jax_cfg
    from horovod_tpu.metrics.mfu import hlo_flops_per_device
    from horovod_tpu.models import init_params, make_grad_fn as j_grad
    from horovod_tpu.models import shard_batch, shard_params
    from horovod_tpu.parallel.mesh import build_mesh
    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.metrics import mfu
    from horovod_tpu_torch.models import (Transformer, from_jax_params,
                                          make_grad_fn)
    B, S = 2, 32
    jcfg, tcfg = jax_cfg(tiny=True), _flagship_cfg(tiny=True)
    params = init_params(np.random.RandomState(0), jcfg, 1)
    rng = np.random.RandomState(1)
    tok = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    tgt = np.roll(tok, -1, 1)
    mesh = build_mesh(dp=1, devices=jax.devices()[:1])
    hlo = hlo_flops_per_device(
        jax.jit(j_grad(jcfg, mesh)),
        (shard_params(params, jcfg, mesh),
         *shard_batch(jnp.asarray(tok), jnp.asarray(tgt), mesh)))
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    counted = mfu.flops_per_step(make_grad_fn(tcfg), model,
                                 torch.from_numpy(tok).long(),
                                 torch.from_numpy(tgt).long())
    n_params = sum(p.numel() for p in model.parameters())
    analytic = mfu.analytic_flops(n_params, B * S, tcfg.n_layers, S,
                                  tcfg.d_model)
    assert counted == 62947328.0
    assert analytic == 60088320.0
    assert abs(counted / analytic - 1.0) <= 0.10
    assert hlo is not None and counted / hlo == pytest.approx(2.96, rel=0.02)
