"""Training-loop callbacks.

Mirrors ``horovod_tpu/train/callbacks.py`` (reference:
``horovod/_keras/callbacks.py`` — ``BroadcastGlobalVariables`` (:23-47),
``MetricAverageCallback`` (:49-93), ``LearningRateWarmupCallback``
(:118-192)): framework-neutral hooks for a torch training loop, called as
``on_train_begin`` / ``on_step_end`` / ``on_epoch_end`` / ``on_train_end``
or used directly. ``StepTimer`` and ``TelemetryCallback`` carry the JAX
callbacks' metric names, flight events and seams (profiling, goodput, time
series, anomaly engine, the hang watchdog that ``TelemetryCallback`` arms
and ``StepTimer.end_step`` feeds), in the same order;
``CheckpointCallback`` saves through the native sharded store.
``TelemetryCallback.on_step_begin`` fires the chaos ``step`` seam
(``chaos.step_tick``) inside the timed window, as the JAX callback does.

On the card a step's kernels run after the host has queued them: end a
step once its results are read (``float(loss)``, as a loop that logs its
loss does), or the timer measures the host's queueing only.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch.common.basics import is_initialized, size
from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.metrics.registry import Gauge, Registry, default_registry


class BroadcastGlobalVariablesCallback:
    """Broadcast the parameters (and the optimizer state) from root at
    training start (reference: ``BroadcastGlobalVariablesCallbackImpl:
    23-47``), in place, over
    :func:`~horovod_tpu_torch.train.optimizer.broadcast_parameters` and
    :func:`~horovod_tpu_torch.train.optimizer.broadcast_optimizer_state`."""

    def __init__(self, root_rank: int = 0) -> None:
        self.root_rank = root_rank

    def on_train_begin(self, params, optimizer=None):
        """``params``: a module, a ``state_dict`` or named parameters.
        Returns ``params``, or ``(params, optimizer)`` with an optimizer."""
        from horovod_tpu_torch.train.optimizer import (
            broadcast_optimizer_state, broadcast_parameters)
        params = broadcast_parameters(params, self.root_rank)
        if optimizer is not None:
            optimizer = broadcast_optimizer_state(optimizer, self.root_rank)
            return params, optimizer
        return params


class MetricAverageCallback:
    """Average logged metrics across workers at epoch end (reference:
    ``MetricAverageCallbackImpl:49-93``): every numeric value, in fp64,
    over the world, in one ``torch.distributed`` allreduce (keys in sorted
    order, so every rank sums the same metrics together). The JAX callback
    takes one eager allreduce a metric; this one stays on the process
    group, so a loop that uses no eager collective starts no eager
    engine for its metrics."""

    def on_epoch_end(self, logs: Dict[str, Any]) -> Dict[str, Any]:
        if not is_initialized() or size() == 1:
            return dict(logs)
        import torch.distributed as dist

        from horovod_tpu_torch.common.basics import backend, device
        keys = sorted(k for k, v in logs.items() if isinstance(
            v, (int, float, np.floating, np.integer))
            and not isinstance(v, bool))
        dev = device() if backend() == "nccl" else torch.device("cpu")
        vals = torch.tensor([float(logs[k]) for k in keys],
                            dtype=torch.float64, device=dev)
        dist.all_reduce(vals)
        mean = (vals / size()).tolist()
        out = dict(logs)
        out.update(zip(keys, mean))
        return out


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
        # goodput ledger: the step envelope is the ledger's spine —
        # begin/end bracket the in-step account, the gap between them is
        # the out-of-step one. It opens with the step's own clock, so a
        # capture that starts below (its profiler start-up is step time)
        # lies inside the window that a window's first step opens
        from horovod_tpu_torch.metrics import goodput
        goodput.note_step_begin()
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        # +1: number the step being ENTERED, matching the post-increment
        # number its step_end will carry (begin/end pairs must agree)
        step_no = int(self.steps.value) + 1
        record_event("step_begin", step=step_no)
        # deep-profiling seam: a pending capture request opens its
        # torch.profiler window at this step boundary; no-op otherwise
        from horovod_tpu_torch import profiling
        profiling.on_step_begin(step_no)

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
        # a completed step IS forward progress: feed the hang watchdog
        # and the flight recorder (JAX train/callbacks.py:146-151)
        from horovod_tpu_torch.diagnostics.flight_recorder import record_event
        from horovod_tpu_torch.diagnostics.watchdog import notify_progress
        record_event("step_end", step=step_no, seconds=round(dt, 6))
        notify_progress(step_no)
        # step-aligned history: the bounded ring (always) + the
        # HVD_TPU_OBS_DIR JSONL (when set)
        from horovod_tpu_torch.metrics import timeseries
        timeseries.record_step(step_no, dt, units)
        # deep-profiling seam: close an active capture window when its
        # step budget is spent, and sample the memory gauges; a completed
        # step also closes the re-mesh timeline's first_step phase
        # (horovod_tpu/train/callbacks.py:163-164)
        from horovod_tpu_torch import profiling
        profiling.on_step_end(step_no)
        from horovod_tpu_torch.elastic import remesh
        remesh.note_step_end(step_no)
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

    Creating the callback also arms the process-wide hang watchdog
    (``HVD_TPU_WATCHDOG_SECONDS``, default 600; 0 disarms): if no step
    completes for that long, an autopsy bundle is written
    (:mod:`horovod_tpu_torch.diagnostics.autopsy`).
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
        # armed-by-default (JAX train/callbacks.py:261-262): a training
        # loop with telemetry gets hang autopsies for free (None when
        # WATCHDOG_SECONDS=0). Only for an INITIALIZED process: a
        # callback constructed without init (unit tests) has no world to
        # autopsy, and a leaked 600s daemon in a long pytest process
        # would eventually fire mid-suite.
        from horovod_tpu_torch.diagnostics.watchdog import ensure_watchdog
        self.watchdog = ensure_watchdog() if is_initialized() else None
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
        self.timer.start_step()
        # chaos `step` seam (horovod_tpu/train/callbacks.py:292): after
        # start_step, so an injected stall lands inside the timed window
        # and the step-time series and anomaly engine see a slow step
        from horovod_tpu_torch import chaos
        chaos.step_tick(self._steps)

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
        """Stand down the hang watchdog (JAX train/callbacks.py:337):
        after the last step, a long eval/export phase with no step
        completions is legitimate, not a hang (the watchdog is
        suspended, not dropped — a later ``init`` or ``ensure_watchdog``
        re-arms it)."""
        from horovod_tpu_torch.diagnostics import watchdog as _wd
        _wd.suspend()


class CheckpointCallback:
    """Durable periodic checkpointing through the native sharded store
    (:class:`horovod_tpu_torch.checkpoint.ShardedCheckpointer`). Every rank
    must run the callback — each writes only its shard of the state.

    Hooks follow this module's convention::

        ckpt = CheckpointCallback("/ckpt/run1", every_n_steps=200)
        state = ckpt.on_train_begin(state)      # resume if possible
        for step in range(ckpt.next_step, total_steps):
            train_step(...)
            ckpt.on_step_end(step, state_now())  # async save every N
        ckpt.on_train_end(step, state_now())    # final synchronous save

    ``state`` is a tree of tensors (the cut is taken when ``save`` is
    called: the tensors may be updated in place right after), e.g.
    ``{"model": model_state(model), "optim": optimizer_state(opt, model),
    "data": ds.state_dict(), "step": step}``; the restore's ``like`` is the
    same tree of a fresh run (``init_optimizer_state`` first). Saves are
    asynchronous; save/restore bytes + durations land on the metrics
    registry. ``directory`` defaults to the ``CHECKPOINT_DIR`` knob.
    """

    def __init__(self, directory: Optional[str] = None,
                 every_n_steps: int = 100,
                 max_to_keep: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 store=None) -> None:
        if store is None:
            from horovod_tpu_torch.checkpoint import ShardedCheckpointer
            from horovod_tpu_torch.common.config import env_str
            directory = directory or env_str("CHECKPOINT_DIR")
            if not directory:
                raise ValueError(
                    "CheckpointCallback needs a directory (argument or "
                    "the CHECKPOINT_DIR / HVD_TPU_CHECKPOINT_DIR env "
                    "knob)")
            store = ShardedCheckpointer(directory, max_to_keep=max_to_keep,
                                        max_inflight=max_inflight)
        self.store = store
        self.every_n_steps = int(every_n_steps)
        self.restored_step: Optional[int] = None
        self._last_saved = -1

    @property
    def next_step(self) -> int:
        """First step the loop should run: 0 on a fresh start,
        ``restored_step + 1`` after a restore (restored_step can BE 0)."""
        return 0 if self.restored_step is None else self.restored_step + 1

    def on_train_begin(self, state):
        """Restore the latest checkpoint onto the CURRENT layout (``state``
        is the ``like=`` template) or return ``state`` untouched."""
        step, out = self.store.restore_latest(like=state, return_step=True)
        if out is None:
            return state
        self.restored_step = step
        self._last_saved = step
        return out

    def on_step_end(self, step: int, state) -> None:
        if self.every_n_steps > 0 and step > self._last_saved \
                and step % self.every_n_steps == 0:
            self.store.save(step, state)
            self._last_saved = step

    def on_epoch_end(self, logs: Dict[str, Any]) -> Dict[str, Any]:
        """Pass-through so the callback rides the same list as
        :class:`MetricAverageCallback`."""
        return logs

    def on_train_end(self, step: Optional[int] = None,
                     state: Any = None) -> None:
        """Final synchronous save (when ``step``/``state`` are given and
        newer than the last save), then drain the writer."""
        if state is not None and step is not None \
                and step > self._last_saved:
            self.store.save(step, state)
            self._last_saved = step
        self.store.wait()

    def close(self) -> None:
        self.store.close()


class LearningRateWarmupCallback:
    """Exponential LR warmup from ``initial_lr`` to ``initial_lr * size``
    over the warmup epochs (reference: ``LearningRateWarmupCallbackImpl:
    118-192`` — the "facebook 1-hour" scaling recipe), the JAX callback's
    schedule: ``lr(step) = initial_lr * size ** min(step / warm_steps,
    1)``. The JAX callback's ``momentum_correction`` and ``verbose``
    change nothing there, and are left out here."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 steps_per_epoch: int = 1) -> None:
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch

    def schedule(self) -> Callable[[int], float]:
        """``step → learning rate``."""
        scale = size()
        warm_steps = max(1, self.warmup_epochs * self.steps_per_epoch)
        base = self.initial_lr

        def fn(step):
            # exponential ramp from lr to lr*size (the reference ramps
            # lr * size ** (epoch / warmup) per batch)
            return base * scale ** min(step / warm_steps, 1.0)

        return fn

    def scheduler(self, optimizer: torch.optim.Optimizer
                  ) -> torch.optim.lr_scheduler.LambdaLR:
        """A ``LambdaLR`` over ``optimizer`` from ``initial_lr`` (set on
        every group): the learning rates it sets are :meth:`schedule`'s."""
        for g in optimizer.param_groups:
            g["lr"] = self.initial_lr
        fn = self.schedule()
        return torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda step: fn(step) / self.initial_lr)
