"""Train-loop telemetry: ``StepTimer`` and ``TelemetryCallback``.

Mirrors ``StepTimer`` and ``TelemetryCallback`` of
``horovod_tpu/train/callbacks.py``: the same metric names, flight events
and seams (profiling, goodput, time series, anomaly engine), in the same
order. Three seams of the JAX callbacks wait for slices that are not
ported yet (ROADMAP queue 1): the hang watchdog that ``TelemetryCallback``
arms and ``StepTimer.end_step`` feeds (with the autopsy), the elastic
re-mesh timeline's ``note_step_end`` and the chaos ``step_tick`` (with the
control plane). The file's other callbacks (broadcast, metric averaging,
checkpointing, LR warmup) arrive with the training-loop services.

On the card a step's kernels run after the host has queued them: end a
step once its results are read (``float(loss)``, as a loop that logs its
loss does), or the timer measures the host's queueing only.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, Optional

from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.metrics.registry import Gauge, Registry, default_registry


class StepTimer:
    """Step-time + throughput recorder feeding the metrics registry.

    Records every step into ``hvd_step_time_seconds`` (log-scale
    histogram), counts steps and processed units (images / tokens /
    sequences — your choice of ``unit``), and keeps live gauges for
    units/s and, when FLOPs are known, MFU. Everything it writes appears
    in ``hvd.metrics_snapshot()["registry"]``.

    Use directly::

        timer = StepTimer(unit="tokens")
        for batch in data:
            with timer.step(units=tokens_per_batch):
                loss = float(train_step(model, opt, *batch)[2])
            # or: timer.start_step(); ...; timer.end_step(units=...)

    ``flops_per_step`` is the device's FLOPs for ONE step (see
    :func:`horovod_tpu_torch.metrics.mfu.flops_per_step`); the peak is
    looked up from the card on first use (None on the CPU or an unknown
    card, and then no MFU).
    """

    def __init__(self, unit: str = "examples",
                 flops_per_step: Optional[float] = None,
                 registry: Optional[Registry] = None) -> None:
        reg = registry or default_registry()
        self._reg = reg
        self.unit = unit
        # "tokens/s" or "img-sec" would break the Prometheus metric-name
        # charset and take the whole /metrics response down with it
        metric_unit = re.sub(r"[^a-zA-Z0-9_]", "_", unit)
        self.step_time = reg.histogram(
            "hvd_step_time_seconds", help="training step wall time")
        self.steps = reg.counter("hvd_steps_total",
                                 help="training steps completed")
        self.units = reg.counter(f"hvd_{metric_unit}_total",
                                 help=f"{unit} processed")
        self.throughput = reg.gauge(
            f"hvd_{metric_unit}_per_second",
            help=f"{unit}/s over the last step (sum across workers)",
            agg="sum")
        # registered lazily on the first computed MFU: an eager gauge
        # would export 0.0 from workers that never compute MFU and drag
        # the mean-merged fleet value toward zero
        self.mfu_gauge: Optional[Gauge] = None
        self.flops_per_step = flops_per_step
        self._peak: Any = _UNSET
        self._t0: Optional[float] = None
        self.last_step_seconds: Optional[float] = None
        # MFU actually computed for the most recent step, None when it
        # could not be (flops or device peak unknown) — the gauge's 0.0
        # default is indistinguishable from a measured zero
        self.last_mfu: Optional[float] = None

    def set_flops_per_step(self, flops: Optional[float]) -> None:
        self.flops_per_step = flops

    def start_step(self) -> None:
        self._t0 = time.perf_counter()
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        # +1: number the step being ENTERED, matching the post-increment
        # number its step_end will carry (begin/end pairs must agree)
        step_no = int(self.steps.value) + 1
        record_event("step_begin", step=step_no)
        # deep-profiling seam: a pending capture request opens its
        # torch.profiler window at this step boundary; no-op otherwise
        from horovod_tpu_torch import profiling
        profiling.on_step_begin(step_no)
        # goodput ledger: the step envelope is the ledger's spine —
        # begin/end bracket the in-step account, the gap between them is
        # the out-of-step one
        from horovod_tpu_torch.metrics import goodput
        goodput.note_step_begin()

    def end_step(self, units: float = 0.0) -> Optional[float]:
        """Close the step opened by :meth:`start_step`; returns the step
        seconds (None if no step was open)."""
        if self._t0 is None:
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.last_step_seconds = dt
        self.step_time.observe(dt)
        self.steps.inc()
        step_no = int(self.steps.value)
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        record_event("step_end", step=step_no, seconds=round(dt, 6))
        # (the JAX timer also feeds the hang watchdog here; the port's
        # watchdog arrives with the autopsy slice)
        # step-aligned history: the bounded ring (always) + the
        # HVD_TPU_OBS_DIR JSONL (when set)
        from horovod_tpu_torch.metrics import timeseries
        timeseries.record_step(step_no, dt, units)
        # deep-profiling seam: close an active capture window when its
        # step budget is spent, and sample the memory gauges (the JAX
        # timer then closes the re-mesh timeline's first_step phase,
        # which arrives with the elastic slice)
        from horovod_tpu_torch import profiling
        profiling.on_step_end(step_no)
        from horovod_tpu_torch.metrics import goodput
        goodput.note_step_end(dt)
        if units:
            self.units.inc(units)
            if dt > 0:
                self.throughput.set(units / dt)
        self.last_mfu = None
        if self.flops_per_step and dt > 0:
            if self._peak is _UNSET:
                from horovod_tpu_torch.metrics.mfu import device_peak_flops
                try:
                    self._peak = device_peak_flops()
                except Exception:
                    self._peak = None
            if self._peak:
                self.last_mfu = self.flops_per_step / dt / self._peak
                if self.mfu_gauge is None:
                    self.mfu_gauge = self._reg.gauge(
                        "hvd_mfu",
                        help="model FLOPs utilization of the last step",
                        agg="mean")
                self.mfu_gauge.set(self.last_mfu)
        return dt

    class _StepCtx:
        def __init__(self, timer: "StepTimer", units: float) -> None:
            self._timer = timer
            self._units = units

        def __enter__(self):
            self._timer.start_step()
            return self._timer

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                self._timer.end_step(self._units)
            else:
                self._timer._t0 = None  # failed step: don't pollute stats
            return False

    def step(self, units: float = 0.0) -> "StepTimer._StepCtx":
        return StepTimer._StepCtx(self, units)


_UNSET = object()


class TelemetryCallback:
    """Train-loop hook bundle around :class:`StepTimer`.

    Call ``on_step_begin()`` / ``on_step_end()`` from any loop. FLOPs for
    MFU are resolved lazily on the first completed step from
    ``lowerable`` — a zero-arg callable returning ``(fn, args)``, counted
    by :func:`horovod_tpu_torch.metrics.mfu.flops_per_step`, which runs
    ``fn(*args)`` once (give a side-effect-free forward and backward such
    as ``(make_grad_fn(cfg), (model, tokens, targets))``; the JAX
    callback's ``(jitted, args)`` is lowered instead). When that fails or
    is not given, ``analytic_flops`` (a number, e.g. from
    :func:`~horovod_tpu_torch.metrics.mfu.analytic_flops`) is used.
    ``flops_source`` says which: ``"counted"``, ``"analytic"``, or None
    (``flops_per_step`` given, or no FLOPs). A failure never breaks the
    loop; it leaves MFU unset.

    ``log_every_n_steps`` > 0 logs a one-line telemetry summary (step
    time, units/s, MFU) through the rank-tagged logger.

    ``profile_steps`` > 0 schedules a ProfileManager device-trace
    capture of the FIRST ``profile_steps`` training steps; independent
    of it, the anomaly engine can fire captures later in the run
    (``HVD_TPU_PROFILE_ON_ANOMALY``).

    (The JAX callback also arms the hang watchdog here; the port's arrives
    with the autopsy slice.)
    """

    def __init__(self, units_per_step: float = 0.0,
                 unit: str = "examples",
                 lowerable: Optional[Callable[[], tuple]] = None,
                 flops_per_step: Optional[float] = None,
                 analytic_flops: Optional[float] = None,
                 log_every_n_steps: int = 0,
                 profile_steps: int = 0,
                 registry: Optional[Registry] = None) -> None:
        self.timer = StepTimer(unit=unit, flops_per_step=flops_per_step,
                               registry=registry)
        self.units_per_step = units_per_step
        self._lowerable = lowerable
        self._analytic = analytic_flops
        self.flops_source: Optional[str] = None
        self._log_every = log_every_n_steps
        self._steps = 0
        # online anomaly engine (HVD_TPU_ANOMALY=0 disables): every
        # completed step feeds the drift detectors — a degradation is
        # flagged as an hvd_anomaly_total{kind} counter + flight event
        # while the job still runs
        from horovod_tpu_torch.metrics.anomaly import default_engine
        self.anomaly_engine = default_engine()
        if profile_steps > 0:
            # armed now, opens at the first step boundary
            from horovod_tpu_torch.profiling import default_manager
            default_manager().request_capture(steps=profile_steps,
                                              reason="telemetry")

    def on_train_begin(self, *args, **kwargs):
        return args[0] if len(args) == 1 else (args or None)

    def on_step_begin(self) -> None:
        # (the JAX callback calls the chaos step_tick after this, inside
        # the timed window; the chaos harness arrives with the control
        # plane)
        self.timer.start_step()

    def on_step_end(self, units: Optional[float] = None) -> None:
        dt = self.timer.end_step(
            self.units_per_step if units is None else units)
        self._steps += 1
        if self.anomaly_engine is not None and dt is not None:
            # the exposed-comm gauge is optional (eager sync path only);
            # Registry.get never creates — absent stays absent
            exposed = self.timer._reg.get(
                "hvd_overlap_exposed_comm_seconds")
            thr = self.timer.throughput.value or None
            try:
                self.anomaly_engine.observe_step(
                    int(self.timer.steps.value), dt, units_per_s=thr,
                    exposed_comm_s=exposed.value
                    if exposed is not None else None)
            except Exception:
                pass  # detection must never break the loop
        if self.timer.flops_per_step is None and \
                (self._lowerable is not None or self._analytic):
            self._resolve_flops()
        if self._log_every > 0 and self._steps % self._log_every == 0 \
                and dt is not None:
            get_logger().info(
                "telemetry: step %d took %.4fs (%.1f %s/s, mfu=%s)",
                self._steps, dt,
                self.timer.throughput.value, self.timer.unit,
                f"{self.timer.last_mfu:.3f}"
                if self.timer.last_mfu is not None else "n/a")

    def _resolve_flops(self) -> None:
        """One attempt to count the step's FLOPs (running the step is not
        free), then the analytic fallback."""
        lowerable, self._lowerable = self._lowerable, None
        if lowerable is not None:
            from horovod_tpu_torch.metrics.mfu import flops_per_step
            try:
                fn, fargs = lowerable()
                flops = flops_per_step(fn, *fargs)
            except Exception as e:
                get_logger().warning("telemetry: FLOP count failed: %r", e)
                flops = None
            if flops:
                self.timer.set_flops_per_step(flops)
                self.flops_source = "counted"
                return
        if self._analytic:
            self.timer.set_flops_per_step(float(self._analytic))
            self.flops_source = "analytic"
        self._analytic = None

    def on_epoch_end(self, logs: Dict[str, Any]) -> Dict[str, Any]:
        """Pass-through hook so the callback can ride a list of
        callbacks."""
        return logs

    def on_train_end(self, *args, **kwargs) -> None:
        """(The JAX callback stands the hang watchdog down here.)"""
