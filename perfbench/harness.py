"""The benchmark's run of one cell on one rank, and the pieces it finds by
name.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix. Everything that belongs to one of them
sits in files of its own, found by that name:

* ``configs/<config>.py`` and the JSON file ``BENCHMARK.json`` gives for
  it: the program's model, optimizer and step, the benchmark's
  initializer, the operation and byte counts, the modules whose device
  time a traced run books to a layer, and the plain reference;
* ``traffic/<traffic>.json``: the parameters the general generator
  (``generator.py``) reads, the ranks and the launcher;
* ``limits/<cell>.json``: the limit of each number the comparison checks;
* ``metrics/<metric>.py``: one reader of a per-layer metric.

A run on one rank (:func:`run_rank`):

1. set-up: ``hvd.init()`` and ``hvd.build_mesh(dp=world)``, the program's
   model, optimizer and step, the weights and a pool of distinct global
   batches drawn on the card from the seed;
2. the checked steps: the window's own call on the first batches of the
   pool, read for the comparison (losses, the first gradient from the
   optimizer's state, each leaf's change);
3. warm-up steps, then the peak memory counter is reset;
4. the window: steps on the pool in turn until ``seconds`` have passed on
   the host clock (every rank stops at the same step), a CUDA event
   recorded after each step and read after the closing synchronize;
5. with ``trace``: a few steps timed on the host from an idle card, then
   a few under the profiler (``trace.py``);
6. the program's state is freed; rank 0 runs the plain reference over the
   checked steps and compares (``judge.py``).
"""

from __future__ import annotations

import datetime
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def banned_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must never
    load, compared as a whole name (``horovod_tpu_torch`` is not
    ``horovod_tpu``)."""
    return sorted({m.split(".")[0] for m in modules} & set(BANNED))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One cell of ``BENCHMARK.json`` with its configuration, traffic,
    limits and metric readers. ``cfg`` and ``traffic`` may be overridden
    key by key (the CPU tests shrink them)."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 cfg: Optional[dict] = None, traffic: Optional[dict] = None):
        bench = bench if bench is not None else load_json(
            ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; it "
                             f"has {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.entry["config"])
        self.cfg = {**load_json(ROOT / conf["file"]), **(cfg or {})}
        self.module = load_module(HERE / "configs" / f"{conf['name']}.py")
        self.traffic = {**load_json(HERE / "traffic"
                                    / f"{self.entry['traffic']}.json"),
                        **(traffic or {})}
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
        self.ranks = self.traffic["ranks"]

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py").read


class _Sync:
    """The device's synchronize and step clock: CUDA events on a card, the
    host clock on the CPU (the CPU tests)."""

    def __init__(self, device):
        import torch
        self.torch, self.cuda = torch, device.type == "cuda"
        self.marks: list = []

    def __call__(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [m[i - 1].elapsed_time(m[i]) for i in range(1, len(m))]
        return [1e3 * (m[i] - m[i - 1]) for i in range(1, len(m))]


class _Control:
    """The ranks' agreement on the host, over a gloo group of the
    benchmark's own (host tensors only: it never waits on the card)."""

    def __init__(self, world: int):
        self.group = None
        if world > 1:
            import torch.distributed as dist
            self.dist = dist
            self.group = dist.new_group(
                backend="gloo", timeout=datetime.timedelta(seconds=900))

    def barrier(self):
        if self.group is not None:
            self.dist.barrier(group=self.group)

    def any(self, flag: bool) -> bool:
        if self.group is None:
            return flag
        import torch
        t = torch.tensor([int(flag)])
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def _norms(pairs) -> Dict[str, float]:
    """Each ``(name, tensor)``'s L2 norm in float64; the pairs may be made
    one at a time, so a difference of two models never exists whole."""
    import torch
    names, vals = [], []
    for n, t in pairs:
        names.append(n)
        vals.append(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))
    return dict(zip(names, torch.stack(vals).tolist())) if names else {}


def first_grads(optimizer, named: Dict[str, "object"], spec: dict):
    """Each leaf's gradient as the optimizer got it at its first step,
    worked out from its state, one leaf at a time: SGD's momentum buffer
    is the gradient; Adam's first moment is ``(1 − β1)`` times it. A leaf
    with no state reads as zero."""
    import torch
    if spec["kind"] == "sgd_momentum":
        key, scale = "momentum_buffer", 1.0
    elif spec["kind"] == "adamw":
        key, scale = "exp_avg", 1.0 / (1.0 - spec["betas"][0])
    else:
        raise ValueError(f"unknown optimizer {spec['kind']!r}")
    for n, p in named.items():
        g = optimizer.state.get(p, {}).get(key)
        yield n, (g * scale if g is not None else torch.zeros_like(p))


def vector_diffs(a: dict, b: dict, device) -> Dict[str, Dict[str, float]]:
    """Each leaf's norm of ``a``'s first gradient minus ``b``'s (host
    tensors, moved to ``device`` one leaf at a time)."""
    return {"grad": _norms((n, a["grad"][n].to(device)
                            - b["grad"][n].to(device)) for n in b["grad"])}


def replica_digest(model) -> List[int]:
    """Each leaf's bits summed as integers: equal on two replicas only if
    (to a vanishing chance) their bits are."""
    import torch
    out = []
    for _, t in sorted(model.state_dict().items()):
        v = t.detach().contiguous()
        bits = v.view(torch.int32) if v.element_size() == 4 else \
            v.view(torch.int16)
        out.append(bits.sum(dtype=torch.int64))
    return torch.stack(out).tolist()


def build_program(cell: Cell, mesh, device) -> dict:
    """The program's model, optimizer, step call and sharding, from the
    configuration's module."""
    model, optimizer, call, local = cell.module.build(cell.cfg, mesh, device)
    return {"model": model, "optimizer": optimizer, "call": call,
            "local": local}


def load_weights(cell: Cell, prog: dict, seed: int, device) -> None:
    """The benchmark's weights for ``seed`` and fresh running statistics
    into the program's model."""
    from perfbench import generator
    ref, cfg = cell.module.reference, cell.cfg
    state = generator.draw_weights(
        ref.param_shapes(cfg), lambda s, r: cell.module.init(s, r, cfg),
        seed, device)
    state.update(ref.init_buffers(cfg, device))
    prog["model"].load_state_dict(state, strict=True)


def checked_steps(cell: Cell, prog: dict, feeds: list, seed: int,
                  device, keep: bool = False) -> dict:
    """The first steps through the window's own call, each on another
    batch: the program's readings for the comparison. ``keep`` also keeps
    the first gradient itself, on the host, under ``"vectors"``."""
    from perfbench import generator
    model, opt = prog["model"], prog["optimizer"]
    named = dict(model.named_parameters())
    losses, grad, vectors = [], None, {"grad": {}}
    for i in range(cell.traffic["checked_steps"]):
        losses.append(prog["call"](model, opt, feeds[i]))
        if i == 0:
            pairs = first_grads(opt, named, cell.cfg["optimizer"])
            if keep:
                pairs = list(pairs)
                vectors["grad"] = {n: g.cpu() for n, g in pairs}
            grad = _norms(pairs)
    ref, cfg = cell.module.reference, cell.cfg
    start = generator.draw_weights(
        ref.param_shapes(cfg), lambda s, r: cell.module.init(s, r, cfg),
        seed, device)
    start.update(ref.init_buffers(cfg, device))
    now = model.state_dict()
    change = _norms((n, now[n].float() - start[n]) for n in start)
    del start
    out = {"losses": [float(x) for x in losses], "grad": grad,
           "change": change}
    if keep:
        out["vectors"] = vectors
    return out


@contextmanager
def _strict_fp32():
    import torch
    from perfbench.reference.common import strict_fp32
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    strict_fp32()
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_steps(cell: Cell, seed: int, device, mode: str = "fp32",
                    keep: bool = False) -> dict:
    """The plain reference over the checked steps, from the same weights
    and batches, in ``mode`` (``fp32``, or ``fp8`` for the control);
    ``keep`` as :func:`checked_steps`."""
    import torch
    from perfbench import generator
    from perfbench.reference.common import make_optimizer
    ref, cfg, traffic = cell.module.reference, cell.cfg, cell.traffic
    kw = {}
    if traffic.get("reference_block_rows"):
        kw["block_rows"] = traffic["reference_block_rows"]
    with _strict_fp32():
        params = generator.draw_weights(
            ref.param_shapes(cfg), lambda s, r: cell.module.init(s, r, cfg),
            seed, device)
        stats = ref.init_buffers(cfg, device)
        start = {k: v.clone() for k, v in {**params, **stats}.items()}
        opt = make_optimizer(cfg["optimizer"])
        losses, grad, vectors = [], None, {}
        for i in range(traffic["checked_steps"]):
            batch = generator.batch(traffic, cfg, seed, i, device)
            loss, g = ref.grads(params, stats, batch, cfg, mode, **kw)
            if i == 0:
                grad = _norms(g.items())
                if keep:
                    vectors["grad"] = {k: v.cpu() for k, v in g.items()}
            opt.step(params, g)
            losses.append(loss)
            del g, batch
        change = _norms((k, v - start[k])
                        for k, v in {**params, **stats}.items())
    del params, stats, start, opt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"losses": losses, "grad": grad, "change": change,
           "matrices": [n for n, (shape, _) in ref.param_shapes(cfg).items()
                        if len(shape) >= 2]}
    if keep:
        out["vectors"] = vectors
    return out


def _p90(ms: List[float]) -> float:
    s = sorted(ms)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool,
             device=None, fault: Optional[str] = None,
             shutdown: bool = True) -> dict:
    """One rank's run of ``cell``; the record :func:`summarize` and
    ``run.py`` read. ``device`` None is the rank's card; ``fault`` one of
    ``faults.NAMES`` planted underneath the timed path; ``shutdown``
    False leaves the world up for another run in this process. The
    record's ``setup_marks`` are the host clock's readings at the end of
    each phase of set-up."""
    import torch

    import horovod_tpu_torch as hvd
    from perfbench import faults, generator
    from perfbench import trace as tracing

    marks = {"imported": time.time()}
    hvd.init()
    rank, world = hvd.rank(), hvd.size()
    if world != cell.ranks:
        raise RuntimeError(f"{cell.name} runs on {cell.ranks} ranks; this "
                           f"world has {world}")
    mesh = hvd.build_mesh(dp=world)
    dev = hvd.device() if device is None else torch.device(device)
    ctl, sync = _Control(world), _Sync(dev)
    traffic, cfg, mod = cell.traffic, cell.cfg, cell.module

    marks["init"] = time.time()
    prog = build_program(cell, mesh, dev)
    marks["built"] = time.time()
    load_weights(cell, prog, seed, dev)
    pool = [generator.batch(traffic, cfg, seed, i, dev)
            for i in range(traffic["pool"])]
    sync()
    marks["drawn"] = time.time()
    record: dict = {"rank": rank, "world": world, "setup_marks": marks}
    with ExitStack() as stack:
        faults.plant(fault, stack, prog)
        feeds = [prog["local"](b) for b in pool]
        model, opt, call = prog["model"], prog["optimizer"], prog["call"]
        P = len(feeds)

        record["program"] = checked_steps(cell, prog, feeds, seed, dev,
                                          keep=rank == 0)
        record["digest_checked"] = replica_digest(model) if world > 1 \
            else []
        sync()
        marks["checked"] = time.time()
        i = traffic["checked_steps"]
        for _ in range(traffic["warmup_steps"]):
            call(model, opt, feeds[i % P])
            i += 1
        sync()
        marks["warm"] = time.time()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        # the window
        losses = []
        ctl.barrier()
        sync()
        sync.mark()
        t0, wall0 = time.perf_counter(), time.time()
        while True:
            losses.append(call(model, opt, feeds[i % P]))
            sync.mark()
            i += 1
            if ctl.any(time.perf_counter() - t0 >= seconds):
                break
        sync()
        window_s = time.perf_counter() - t0
        step_ms = sync.intervals_ms()
        steps = len(step_ms)
        record.update(
            window_start_wall=wall0, window_s=window_s, steps=steps,
            step_ms=step_ms, step_ms_p90=_p90(step_ms),
            samples=steps * traffic["rows_per_rank"],
            window_nonfinite=int((~torch.isfinite(
                torch.stack(losses).float())).sum()),
            memory_peak_bytes=torch.cuda.max_memory_allocated()
            if dev.type == "cuda" else 0,
            flops_per_step=statistics.fmean(
                mod.flops(cfg, generator.rank_block(b, rank, world))
                for b in pool))

        if trace:
            host_ms = []
            for _ in range(traffic["host_steps"]):
                sync()
                t = time.perf_counter()
                call(model, opt, feeds[i % P])
                host_ms.append(1e3 * (time.perf_counter() - t))
                i += 1
            sync()
            first = i
            K = traffic["profile_steps"]
            t = tracing.capture(
                lambda k: call(model, opt, feeds[(first + k) % P]), K,
                mod.ranges(model), opt, ctl.barrier)
            # the ranges are read in the second traced span: its batches
            works = [mod.work(cfg, generator.rank_block(
                pool[(first + K + k) % P], rank, world)) for k in range(K)]
            record["trace"] = t
            record["host_step_ms"] = host_ms
            record["work"] = {key: statistics.fmean(w[key] for w in works)
                              for key in works[0]}
        record["digest_end"] = replica_digest(model) if world > 1 else []
    del prog, model, opt, call, feeds, pool, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if rank == 0:
        ref = reference_steps(cell, seed, dev, keep=True)
        record["program"]["diff"] = vector_diffs(
            record["program"].pop("vectors"), ref.pop("vectors"), dev)
        record["reference"] = ref
    ctl.barrier()
    if dev.type == "cuda":
        record["device_kind"] = torch.cuda.get_device_name(dev)
    if shutdown:
        hvd.shutdown()
    return record


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it: a card set below
    its maximum runs slower under load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def peak_of(kind: str) -> Optional[dict]:
    return load_json(HERE / "peaks.json").get(kind)


def per_layer(cell: Cell, rec: dict, peak: Optional[dict]) -> Dict[str, float]:
    """The per-layer metrics one rank's traced run gives."""
    view = {"window": {"steps": rec["steps"], "window_s": rec["window_s"],
                       "flops_per_step": rec["flops_per_step"]},
            "trace": rec.get("trace"), "host_step_ms": rec.get("host_step_ms",
                                                               []),
            "work": rec.get("work", {}), "peak": peak}
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"])(view)
        if v is not None:
            out[m["name"]] = v
    return out


def summarize(cell: Cell, records: List[dict], t_start: float, trace: bool,
              kind: str) -> dict:
    """The result line's fields from every rank's record: rates over all
    ranks' samples, rank 0's steps for the percentile, the fullest card's
    peak, per-layer metrics and device activity averaged over the ranks,
    and the comparison."""
    from perfbench import judge
    records = sorted(records, key=lambda r: r["rank"])
    r0 = records[0]
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    peak_bytes = max(r["memory_peak_bytes"] for r in records)
    numbers = judge.compare(r0["program"], r0["reference"])
    numbers["window_nonfinite"] = float(sum(r["window_nonfinite"]
                                            for r in records))
    if len(records) > 1:
        numbers["replicas_differ"] = float(sum(
            r["digest_checked"] != r0["digest_checked"]
            or r["digest_end"] != r0["digest_end"] for r in records[1:]))
    correct, checks = judge.verdict(numbers, cell.limits)
    device = {"platform": "gpu", "kind": kind, "count": len(records),
              "memory_peak_bytes": peak_bytes}
    if trace:
        peak = peak_of(kind)
        layers = [per_layer(cell, r, peak) for r in records]
        values = {m["name"]: statistics.fmean(x[m["name"]] for x in layers)
                  for m in cell.per_layer
                  if all(m["name"] in x for x in layers)}
        device["busy_s"] = statistics.fmean(r["trace"]["busy_s"]
                                            for r in records)
        device["window_s"] = statistics.fmean(r["trace"]["window_s"]
                                              for r in records)
    else:
        samples = sum(r["samples"] for r in records)
        values = {
            "samples_per_s": samples / r0["window_s"],
            "step_ms_p90": r0["step_ms_p90"],
            "peak_mem_gb": peak_bytes / 1e9,
            "setup_s": max(r["window_start_wall"] for r in records)
            - t_start}
        values = {k: v for k, v in values.items() if k in units}
    out = {"correct": correct, "attempted": r0["steps"],
           "failed": int(numbers["window_nonfinite"]),
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()},
           "device": device}
    if trace:
        out["breakdown"] = r0["trace"]["breakdown"]
    out["checks"] = checks
    return out
