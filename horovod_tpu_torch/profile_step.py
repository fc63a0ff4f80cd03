"""Where the flagship train step's time goes on the card.

    python -m horovod_tpu_torch.profile_step [--steps N] [--out FILE]
        [--optimizer adamw|ef_adamw|fused_adam|fused_sgd_momentum|fused_sgd]
        [--dp [--compression none|int8]]

Runs ``entry()``'s model through ``make_train_step`` with one of
``OPTIMIZERS`` (AdamW by default; the others are the int8 error-feedback
paths chip_smoke.py drives: ``ef_adamw`` is ``DistributedOptimizer(adamw,
compression=ErrorFeedback(Compression.int8))``, the ``fused_*`` ones the
fused int8 optimizers). With ``--dp`` the step is instead the data-parallel
one of chip_smoke.py's ``[dp_nccl]`` phase: ``init()`` (an NCCL process
group over the launched world, one process by default), ``build_mesh``
and ``make_overlap_train_step`` with ``DP_MICRO`` microbatches and the
default 64 MiB buckets, the gradients int8-quantized on the wire with
``--compression int8``. Three warm-up steps, N steps timed on the host
clock, then N steps under ``torch.profiler`` (CPU and CUDA activity).
Prints one JSON object: the wall time per step without and with the
profiler, the device time per step summed over the kernels (NCCL's
kernels run on their own stream, so with ``--dp`` the sum can exceed the
busy time by their overlap), the device's idle share of the wall time,
kernel launches per step, the device time of the kernels issued inside the
library's marked ranges (the step's phases ``hvd.step``, ``hvd.forward``,
``hvd.backward``, ``hvd.sync_grads`` and ``hvd.optimizer``; ``hvd.pack``:
bucket packing; ``hvd.reduce``: issuing the collectives, with the quantize
kernels of the int8 path; ``hvd.unpack``: each bucket's wait and unpack;
``hvd.accumulate``: the microbatch sums; ``hvd.guard``: the guard's
verdict), and the kernels ranked by device time, each with its share and
the group it belongs to (the port's own kernels, NCCL, ``torch.cat``,
matrix products, the rest). Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import (DistributedOptimizer, ErrorFeedback,
                               fused_adam, fused_sgd)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.models import (adamw, init_opt_state, lm_loss,
                                      make_train_step)

_QUANTIZE_KERNELS = ("quantize_kernel", "fused_sgd0_kernel",
                     "fused_sgd_kernel", "fused_adam_kernel")


def kernel_group(name: str) -> str:
    """The group a kernel's device time is booked to, by its name."""
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "port: flash_attn_fwd"
    if "xent_fwd_kernel" in name:
        return "port: xent_fwd"
    if "nccl" in low:
        return "nccl"
    if "catarraybatchedcopy" in low:
        return "torch.cat (bucket packing and RoPE)"
    if any(k in name for k in _QUANTIZE_KERNELS):   # dequantize_kernel too
        return "port: quantize.cu"
    if any(s in low for s in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet", "sm90_")):
        return "matmul (cuBLAS)"
    if "adam" in low or "multi_tensor" in low:
        return "optimizer"
    return "other (elementwise, reductions, copies)"


ADAM_LR = 1e-3
# microbatches of the data-parallel step (chip_smoke's [dp_nccl] phases)
DP_MICRO = 2
# SGD's learning rate for the fused_sgd paths: at 1.0 the flagship's loss
# falls at every one of 5 steps on one batch, with momentum 0.9 and without
# (0.3 and 0.5 bounce without momentum)
SGD_LR = 1.0
SGD_MOMENTUM = 0.9
_EF8 = ErrorFeedback(Compression.int8)

# name: (the optimizer factory ``init_opt_state`` takes, the quantize
# kernels a step launches once for each parameter)
OPTIMIZERS = {
    "adamw": (adamw, ()),
    "ef_adamw": (lambda ps: DistributedOptimizer(adamw(ps),
                                                 compression=_EF8),
                 ("quantize", "dequantize")),
    "fused_adam": (lambda ps: DistributedOptimizer(fused_adam(ADAM_LR), ps,
                                                   compression=_EF8),
                   ("quantize_ef", "fused_adam")),
    "fused_sgd_momentum": (lambda ps: DistributedOptimizer(
        fused_sgd(SGD_LR, momentum=SGD_MOMENTUM), ps, compression=_EF8),
        ("quantize_ef", "fused_sgd")),
    "fused_sgd": (lambda ps: DistributedOptimizer(fused_sgd(SGD_LR), ps,
                                                  compression=_EF8),
                  ("quantize_ef", "fused_sgd0")),
}


def _dp_step(model, opt, tokens, targets, compression: str):
    """The [dp_nccl] step over the launched world (rows of the batch per
    rank)."""
    hvd.init()
    mesh = hvd.build_mesh(dp=-1)
    ostep = hvd.make_overlap_train_step(
        lm_loss, mesh, "dp", n_micro=DP_MICRO,
        compression=Compression.int8 if compression == "int8" else None)
    batch = hvd.shard_batch(tokens, targets, mesh)
    return lambda: ostep(model, opt, batch)


def profile(steps: int, optimizer: str = "adamw", dp: bool = False,
            compression: str = "none") -> dict:
    from horovod_tpu_torch.entry import entry

    _, (model, tokens, targets) = entry()
    opt = init_opt_state(OPTIMIZERS[optimizer][0], model)
    if dp:
        run = _dp_step(model, opt, tokens, targets, compression)
    else:
        step = make_train_step(model.cfg)
        run = lambda: step(model, opt, tokens, targets)   # noqa: E731
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    plain_wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # device activity only; the optimizer's step annotation is also on the
    # device timeline, overlapping the kernels it names
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)   # us
    busy_us = sum(t for t, _ in by_name.values())
    groups: dict = {}
    for name, (t, _) in by_name.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + t
    # device time of the kernels issued inside the library's marked ranges
    # (the step's phases, hvd.pack, hvd.reduce, hvd.unpack, hvd.accumulate,
    # hvd.guard), whatever their name
    ranges: dict = {}
    for e in prof.events():
        if e.name.startswith("hvd.") and \
                e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    wall_ms = 1e3 * wall_s / steps
    busy_ms = busy_us / 1e3 / steps
    return {
        "device": torch.cuda.get_device_name(0),
        "optimizer": optimizer,
        "step": (f"dp overlap, world {hvd.size()}, n_micro {DP_MICRO}, "
                 f"compression {compression}" if dp else "make_train_step"),
        "steps": steps,
        "tokens_per_step": tokens.numel(),
        "wall_ms_per_step_unprofiled": plain_wall_ms,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": len(kernels) / steps,
        "groups_ms_per_step": {g: t / 1e3 / steps for g, t in
                               sorted(groups.items(), key=lambda kv: -kv[1])},
        "ranges_device_ms_per_step": {k: t / 1e3 / steps for k, t in
                                      sorted(ranges.items())},
        "top_kernels": [{"name": name[:120], "ms_per_step": t / 1e3 / steps,
                         "calls_per_step": n / steps,
                         "share": t / busy_us, "group": kernel_group(name)}
                        for name, (t, n) in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--optimizer", default="adamw", choices=list(OPTIMIZERS))
    ap.add_argument("--dp", action="store_true",
                    help="profile the data-parallel overlap step")
    ap.add_argument("--compression", default="none", choices=["none", "int8"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    doc = profile(args.steps, args.optimizer, args.dp, args.compression)
    hvd.shutdown()
    text = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
