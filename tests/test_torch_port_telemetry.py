"""The port's train-loop telemetry against the JAX package's, on the CPU.

``StepTimer``/``TelemetryCallback`` around three steps of the tiny
flagship in both packages (one scripted step clock) give the same
registry; the callback drives the goodput ledger, the time series and a
``torch.profiler`` capture; the FLOP count holds the hand-written kernels
by their formulas (the trap: ``FlopCounterMode`` cannot see a ``ctypes``
launch, and would count the plain versions' ops on the CPU instead); the
kernel builds are compiles; the memory sampler, the attribution, the
trace context and the flight dump follow the JAX modules; and every metric
name the port registers is one the JAX package registers and documents
(``ci/check_metrics_docs.py`` over ``horovod_tpu_torch``).

Every test starts and ends with fresh process-wide state: the port's
registry, flight ring, time series, goodput ledger, anomaly engine and
profile manager, and the JAX package's time series, goodput ledger and
anomaly engine.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.metrics import anomaly as j_anomaly
from horovod_tpu.metrics import goodput as j_goodput
from horovod_tpu.metrics import registry as j_registry
from horovod_tpu.metrics import timeseries as j_timeseries
from horovod_tpu_torch import profiling
from horovod_tpu_torch.diagnostics import flight_recorder
from horovod_tpu_torch.metrics import (anomaly, goodput, mfu, registry,
                                       timeseries)
from horovod_tpu_torch.profiling import compile_watch

B, S = 2, 16


def reset_observability():
    registry.default_registry().clear()
    flight_recorder.recorder().clear()
    profiling.reset()
    for mod in (timeseries, goodput, anomaly, j_timeseries, j_goodput,
                j_anomaly):
        mod.reset()


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


@pytest.fixture(scope="module")
def tiny():
    from __graft_entry__ import _flagship_cfg as jax_cfg
    from horovod_tpu.models import init_params
    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.models import Transformer, from_jax_params
    jcfg, tcfg = jax_cfg(tiny=True), _flagship_cfg(tiny=True)
    params = init_params(np.random.RandomState(0), jcfg, 1)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tokens=tokens,
                targets=targets, model=model)


def _torch_batch(t):
    return (torch.from_numpy(t["tokens"]).long(),
            torch.from_numpy(t["targets"]).long())


class _StepClock:
    """A scripted ``time`` module for the step timers: each read moves on
    by the next of ``deltas``."""

    def __init__(self, deltas):
        self.t, self._d = 50.0, iter(deltas)

    def perf_counter(self):
        self.t += next(self._d)
        return self.t


STEP_CLOCK = [0.0, 0.125, 0.5, 0.0625, 0.25, 3.0]    # begin, end, ...


def test_callback_registry_is_the_jax_callbacks(tiny, monkeypatch):
    """Three steps of the tiny flagship inside each package's
    ``TelemetryCallback`` (the JAX one around the jitted JAX step), one
    scripted step clock: equal registries — the step-time histogram, the
    step and token totals, tokens/s — and no MFU on the CPU in either."""
    from horovod_tpu.models import make_grad_fn as j_grad
    from horovod_tpu.models import shard_batch, shard_params
    from horovod_tpu.parallel.mesh import build_mesh
    from horovod_tpu.train import callbacks as j_callbacks
    from horovod_tpu_torch.models import adamw, init_opt_state, make_train_step
    from horovod_tpu_torch.train import callbacks as t_callbacks
    mesh = build_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jax.jit(j_grad(tiny["jcfg"], mesh))
    jargs = (shard_params(tiny["params"], tiny["jcfg"], mesh),
             *shard_batch(jnp.asarray(tiny["tokens"]),
                          jnp.asarray(tiny["targets"]), mesh))
    model = tiny["model"]
    opt = init_opt_state(adamw, model)
    step = make_train_step(tiny["tcfg"])
    batch = _torch_batch(tiny)
    runs = {"jax": (j_callbacks, j_registry,
                    lambda: float(jstep(*jargs)[0])),
            "torch": (t_callbacks, registry,
                      lambda: float(step(model, opt, *batch)[2]))}
    monkeypatch.setenv("HVD_TPU_COMPILE_METRICS", "0")   # no JAX log hooks
    snaps = {}
    for name, (cb_mod, reg_mod, run) in runs.items():
        monkeypatch.setattr(cb_mod, "time", _StepClock(STEP_CLOCK))
        reg = reg_mod.Registry()
        cb = cb_mod.TelemetryCallback(units_per_step=B * S, unit="tokens",
                                      registry=reg)
        for _ in range(3):
            cb.on_step_begin()
            run()
            cb.on_step_end()
        assert cb.timer.last_mfu is None
        snaps[name] = reg.snapshot()
    assert snaps["jax"] == snaps["torch"]
    snap = snaps["torch"]
    assert snap["hvd_steps_total"]["value"] == 3.0
    assert snap["hvd_tokens_total"]["value"] == 3.0 * B * S
    assert snap["hvd_step_time_seconds"]["count"] == 3
    assert snap["hvd_step_time_seconds"]["sum"] == pytest.approx(3.1875)
    assert snap["hvd_tokens_per_second"]["value"] == pytest.approx(B * S / 3)
    assert "hvd_mfu" not in snap


def test_callback_drives_the_plane_on_the_cpu(tiny, monkeypatch, tmp_path):
    """Five observed steps: the step series on disk, two closed goodput
    windows whose books close, a capture of the first two steps with its
    Chrome trace, the FLOPs counted from ``lowerable`` (no peak on the CPU,
    so no MFU), and the flight ring's begin/end pairs."""
    from horovod_tpu_torch.models import (adamw, init_opt_state,
                                          make_grad_fn, make_train_step)
    obs = tmp_path / "obs"
    monkeypatch.setenv("HVD_TPU_OBS_DIR", str(obs))
    monkeypatch.setenv("HVD_TPU_GOODPUT_WINDOW", "2")
    model, batch = tiny["model"], _torch_batch(tiny)
    opt = init_opt_state(adamw, model)
    step = make_train_step(tiny["tcfg"])
    cb = hvd.TelemetryCallback(
        units_per_step=B * S, unit="tokens",
        lowerable=lambda: (make_grad_fn(tiny["tcfg"]), (model, *batch)),
        profile_steps=2)
    for _ in range(5):
        cb.on_step_begin()
        float(step(model, opt, *batch)[2])
        cb.on_step_end()
    assert cb.flops_source == "counted"
    assert cb.timer.flops_per_step == mfu.flops_per_step(
        make_grad_fn(tiny["tcfg"]), model, *batch)
    assert cb.timer.last_mfu is None
    points = [p for p in timeseries.read_series(str(obs)) if "step" in p]
    assert [p["step"] for p in points] == [1, 2, 3, 4, 5]
    assert all(p["units"] == B * S for p in points)
    gp = goodput.snapshot(flush_open=True)
    assert gp["windows"] == 3 and gp["books_violations"] == 0
    (cap,) = profiling.recent_captures()
    assert (cap["first_step"], cap["last_step"], cap["reason"]) == \
        (1, 2, "telemetry")
    assert cap["bytes"] > 0
    with open(os.path.join(cap["path"], "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    kinds = [(e["kind"], e.get("step")) for e in
             flight_recorder.recorder().events()
             if e["kind"] in ("step_begin", "step_end")]
    assert kinds == [(k, s) for s in range(1, 6)
                     for k in ("step_begin", "step_end")]
    snap = hvd.metrics_snapshot()
    assert set(snap) == {"engine", "derived", "stragglers", "registry"}
    assert snap["engine"] == snap["derived"] == snap["stragglers"] == {}
    reg = snap["registry"]
    assert reg["hvd_profile_captures_total"]["value"] == 1.0
    assert reg['hvd_goodput_seconds_total{category="compute"}']["value"] > 0


def test_analytic_flops_when_the_count_fails():
    def broken():
        raise RuntimeError("no step to count")
    cb = hvd.TelemetryCallback(lowerable=broken, analytic_flops=1e9)
    cb.on_step_begin()
    cb.on_step_end()
    assert (cb.flops_source, cb.timer.flops_per_step) == ("analytic", 1e9)
    given = hvd.TelemetryCallback(flops_per_step=5e8)
    given.on_step_begin()
    given.on_step_end()
    assert given.flops_source is None and given.timer.flops_per_step == 5e8


def test_failed_step_is_not_recorded():
    timer = hvd.StepTimer(unit="img/s")
    with pytest.raises(ValueError):
        with timer.step(units=4):
            raise ValueError("step failed")
    with timer.step(units=4):
        pass
    snap = registry.default_registry().snapshot()
    assert snap["hvd_steps_total"]["value"] == 1.0
    assert snap["hvd_img_s_total"]["value"] == 4.0


# -- the FLOP count: kernels by formula -------------------------------------------

@pytest.mark.parametrize("Sq,Sk,causal", [(64, 64, True), (64, 64, False),
                                         (40, 64, True), (64, 40, True)])
def test_attention_forward_counts_its_formula(Sq, Sk, causal):
    """The forward counts the kernel's products alone: on the CPU the plain
    version (two full-square batched products) is hidden from the counter
    and the formula added, which is what the card adds for a launch."""
    from horovod_tpu_torch.ops import attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, Sq, 4, 16, generator=g)
    k, v = (torch.randn(2, Sk, 4, 16, generator=g) for _ in range(2))
    got = mfu.flops_per_step(attention.flash_attention, q, k, v, causal)
    want = attention.flash_attn_fwd_flops(2, Sq, Sk, 4, 16, causal)
    assert got == want
    if causal and Sq == Sk:
        assert want == 4 * 2 * 4 * 16 * (64 * 65 // 2)


def test_xent_forward_counts_none_of_its_plain_ops():
    from horovod_tpu_torch.ops import xent
    logits, labels = torch.randn(8, 300), torch.randint(0, 300, (8,))
    assert mfu.flops_per_step(xent.fused_softmax_xent, logits, labels) is None
    assert xent.xent_fwd_flops(8, 300) == 0


def test_step_count_is_the_same_on_meta_tensors(tiny):
    """The count needs only shapes: the tiny step counted over meta
    tensors (as chip_smoke counts the flagship's on the CPU) equals the
    count over real ones."""
    from horovod_tpu_torch.models import Transformer, make_grad_fn
    batch = _torch_batch(tiny)
    real = mfu.flops_per_step(make_grad_fn(tiny["tcfg"]), tiny["model"],
                              *batch)
    meta = mfu.flops_per_step(make_grad_fn(tiny["tcfg"]),
                              Transformer(tiny["tcfg"], device="meta"),
                              *(t.to("meta") for t in batch))
    assert real == meta and real > 0


def test_uncounted_is_inert_outside_a_count_and_counts_do_not_nest():
    with mfu.uncounted():
        assert torch.ones(2).sum() == 2
    mfu.count_kernel_flops(123)           # no open count: dropped
    with pytest.raises(RuntimeError, match="nest"):
        mfu.flops_per_step(mfu.flops_per_step, lambda: None)


def test_a_capture_at_a_window_s_first_step_stays_in_the_books(monkeypatch):
    """A capture starting at each step boundary (its profiler start-up is
    step time, here 0.3 s) and 0.3 s between the steps: the window opened
    by the first step holds both start-ups, so the gap is out-of-step time.
    The window used to open after the start-up, and the steps' seconds
    then covered the gap."""
    import time

    from horovod_tpu_torch.train.callbacks import StepTimer
    monkeypatch.setattr(profiling, "on_step_begin",
                        lambda step: time.sleep(0.3))
    timer = StepTimer()
    timer.start_step()
    timer.end_step()
    time.sleep(0.3)
    timer.start_step()
    timer.end_step()
    closed = goodput.flush()
    assert closed["closed"] and closed["seconds"]["input_wait"] > 0.25, \
        closed


def test_analytic_flops_formula():
    assert mfu.analytic_flops(10, 4) == 240.0
    assert mfu.analytic_flops(0, 2, n_layers=1, seq=3, d_model=5) == \
        12.0 * 5 * 2.0 * 2


# -- compile watch: kernel builds ------------------------------------------------

def test_builds_are_compiles_and_feed_goodput(monkeypatch):
    """One batch of two parallel builds: one ``hvd_compile_seconds``
    observation a library, two compiles and cache misses, and the batch's
    wall time once in ``seconds_total`` — what goodput's compile category
    claims from the step it landed in."""
    compile_watch.note_build({"flash_attn_fwd": 30.0, "quantize": 12.0}, 31.0)
    assert compile_watch.totals() == {"compiles": 2, "cache_misses": 2,
                                      "seconds_total": 31.0}
    assert compile_watch.per_function_compiles() == {"flash_attn_fwd": 1,
                                                      "quantize": 1}
    snap = registry.default_registry().snapshot()
    assert snap["hvd_compile_total"]["value"] == 2.0
    assert snap["hvd_compile_cache_miss_total"]["value"] == 2.0
    hist = snap['hvd_compile_seconds{function="flash_attn_fwd"}']
    assert (hist["count"], hist["sum"]) == (1, 30.0)
    assert goodput._compile_seconds_total() == 31.0
    compile_watch.note_build({}, 5.0)           # nothing built: nothing
    monkeypatch.setenv("HVD_TPU_COMPILE_METRICS", "0")
    compile_watch.note_build({"xent_fwd": 1.0}, 1.0)
    assert compile_watch.totals()["compiles"] == 2


def test_build_all_records_nothing_when_every_library_is_built(monkeypatch):
    from horovod_tpu_torch.ops import _build
    monkeypatch.setattr(_build.os.path, "exists", lambda p: True)
    monkeypatch.setattr(_build, "_target", lambda n: f"/built/{n}.so")
    _build.build_all()
    assert compile_watch.totals()["compiles"] == 0


# -- memory ------------------------------------------------------------------------

def test_no_card_no_memory_gauges():
    from horovod_tpu_torch.profiling import memory
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert memory.device_stats() == []
    sampler = memory.MemorySampler()
    assert sampler.on_step(1) is None and sampler._dead
    assert not any(k.startswith("hvd_hbm") for k in
                   registry.default_registry().snapshot())


def test_memory_sampler_is_the_jax_samplers():
    """The same stats (a slow leak) through both samplers: equal gauges
    and the same ``hbm_growth`` finding."""
    from horovod_tpu.profiling import memory as j_memory
    from horovod_tpu_torch.profiling import memory as t_memory
    stats = [[{"bytes_in_use": 1000 + 40 * i, "peak_bytes_in_use": 2000 + i,
               "bytes_limit": 10 ** 6}] for i in range(200)]
    out = {}
    for name, mod, reg_mod in (("jax", j_memory, j_registry),
                               ("torch", t_memory, registry)):
        it = iter(stats)
        reg = reg_mod.Registry()
        sampler = mod.MemorySampler(registry=reg, stats_fn=lambda: next(it))
        findings = [f for f in (sampler.on_step(i) for i in range(200)) if f]
        out[name] = (reg.snapshot(), findings)
    assert out["jax"] == out["torch"]
    assert out["torch"][1][0]["kind"] == "hbm_growth"


# -- profile manager ----------------------------------------------------------------

def test_capture_requests_are_bounded(tmp_path, monkeypatch):
    """One capture at a time; anomaly-rate-limited requests honour the
    cooldown once a trace started; retention drops the oldest capture."""
    from horovod_tpu_torch.profiling.manager import ProfileManager
    monkeypatch.setenv("HVD_TPU_PROFILE_COOLDOWN_S", "3600")
    mgr = ProfileManager(directory=str(tmp_path))
    assert mgr.request_capture(steps=1, reason="anomaly:x",
                               rate_limited=True)
    assert mgr.request_capture(steps=1) is None          # one pending
    mgr.on_step_begin(1)
    assert mgr.status()["active"]["reason"] == "anomaly:x"
    mgr.on_step_end(1)
    assert mgr.request_capture(steps=1, rate_limited=True) is None
    assert mgr.dropped_requests == 2
    first = mgr.recent_captures()[0]["path"]
    monkeypatch.setenv("HVD_TPU_PROFILE_MAX_BYTES", "1")
    os.utime(first, (1, 1))
    assert mgr.request_capture(steps=1, reason="on_demand")
    mgr.on_step_begin(2)
    mgr.on_step_end(2)
    newest = mgr.recent_captures()[-1]["path"]
    assert os.path.isdir(newest) and not os.path.exists(first)


def test_anomaly_finding_arms_a_capture(tmp_path, monkeypatch):
    """With the anomaly hook on, a finding arms a capture whose path is
    stamped into the finding."""
    monkeypatch.setenv("HVD_TPU_PROFILE_ON_ANOMALY", "1")
    f = anomaly.report_finding("step_time_drift", step=7)
    assert f["profile"].startswith(str(tmp_path / "profile"))
    assert profiling.default_manager().status()["pending"]["reason"] == \
        "anomaly:step_time_drift"


def test_annotate_names_a_range():
    @profiling.annotate_fn("hvd.test_range")
    def work():
        return torch.ones(4).sum()

    with torch.profiler.profile() as prof:
        with profiling.annotate("hvd.outer"):
            work()
    names = {e.key for e in prof.key_averages()}
    assert {"hvd.outer", "hvd.test_range"} <= names


# -- attribution, trace context, flight dump ----------------------------------------

def test_attribution_is_the_jax_packages():
    from horovod_tpu.profiling import attribution as j_att
    from horovod_tpu_torch.profiling import attribution as t_att
    acct = {"wall_s": 10.0, "steps": 20,
            "seconds": {"compute": 6.0, "exposed_comm": 1.0, "compile": 2.0,
                        "input_wait": 0.5, "idle_other": 0.5}}
    for kw in ({}, {"mfu": 0.4}, {"flops_per_step": 1e12,
                                  "peak_flops": 989e12}):
        want = j_att.attribute(acct, **kw)
        assert t_att.attribute(acct, **kw) == want
        assert t_att.render_lines(want) == j_att.render_lines(want)
    assert t_att.attribute(None) is None


def test_trace_context_wire_format_and_sampling_are_the_jax_packages(
        monkeypatch):
    from horovod_tpu import tracing as j_tracing
    from horovod_tpu_torch import tracing as t_tracing
    for header in ("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
                   "garbage", "00-" + "0" * 32 + "-" + "cd" * 8 + "-01"):
        a, b = j_tracing.decode(header), t_tracing.decode(header)
        assert (a is None) == (b is None)
        if b is not None:
            assert (b.trace_id, b.span_id) == (a.trace_id, a.span_id)
            assert t_tracing.encode(b) == j_tracing.encode(a)
    ctx = t_tracing.new_trace("test")
    with t_tracing.activate(ctx):
        flight_recorder.record_event("probe")
    ev = flight_recorder.recorder().events()[-1]
    assert (ev["trace"], ev["span"]) == (ctx.trace_id, ctx.span_id)
    kid = t_tracing.child(ctx, "test")
    t_tracing.record_span("test", "work", kid, start=10.0, dur_s=0.25,
                          step=3, skipped=None)
    ev = flight_recorder.recorder().events()[-1]
    assert {k: v for k, v in ev.items() if k not in ("ts", "seq")} == {
        "kind": "trace_span", "plane": "test", "name": "work", "start": 10.0,
        "dur_s": 0.25, "trace": ctx.trace_id, "span": kid.span_id,
        "parent": ctx.span_id, "step": 3}
    snap = registry.default_registry().snapshot()
    assert snap['hvd_trace_spans_total{plane="test"}']["value"] == 2.0
    monkeypatch.setenv("HVD_TPU_TRACE", "0")
    assert t_tracing.new_trace() is None


def test_flight_dump_has_the_jax_documents_keys():
    from horovod_tpu.diagnostics.flight_recorder import (
        FlightRecorder as JRecorder)
    from horovod_tpu_torch.diagnostics.flight_recorder import FlightRecorder
    j, t = JRecorder(capacity=2), FlightRecorder(capacity=2)
    for rec in (j, t):
        for i in range(3):
            rec.record("step_end", step=i)
    jd, td = j.dump(), t.dump()
    assert set(jd) == set(td)
    assert td["dropped"] == jd["dropped"] == 1
    assert [e["step"] for e in td["events"]] == [1, 2]


# -- metric names ----------------------------------------------------------------------

def test_every_port_metric_is_the_jax_packages_and_documented(monkeypatch):
    """``ci/check_metrics_docs.py``'s extraction over the port: each name
    it registers is registered by the JAX package and documented in
    docs/OBSERVABILITY.md."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "ci"))
    import check_metrics_docs as lint
    jax_names = lint.code_metrics()
    docs = lint.doc_metrics()
    monkeypatch.setattr(lint, "SCAN_ROOTS", ("horovod_tpu_torch",))
    monkeypatch.setattr(lint, "SCAN_FILES", ())
    port = lint.code_metrics()
    assert len(port) >= 25
    for name, sites in port.items():
        assert name in jax_names, (name, sites)
        assert any(lint._doc_covers_code(name, d) for d in docs), \
            (name, sites)
