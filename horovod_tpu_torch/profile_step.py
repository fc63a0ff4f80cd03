"""Where the flagship train step's time goes on the card.

    python -m horovod_tpu_torch.profile_step [--steps N] [--out FILE]

Runs ``entry()``'s model through ``make_train_step`` with AdamW: three
warm-up steps, N steps timed on the host clock, then N steps under
``torch.profiler`` (CPU and CUDA activity). Prints one JSON object: the
wall time per step without and with the profiler, the device time
per step summed over the kernels (one stream, so the kernels do not
overlap), the device's idle share of the wall time, kernel launches per
step, and the kernels ranked by device time, each with its share and the
group it belongs to (the port's own kernels, matrix products, the rest).
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "port: flash_attn_fwd"
    if "xent_fwd_kernel" in name:
        return "port: xent_fwd"
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet", "sm90_")):
        return "matmul (cuBLAS)"
    if "adam" in low or "multi_tensor" in low:
        return "optimizer"
    return "other (elementwise, reductions, copies)"


def profile(steps: int) -> dict:
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models import adamw, init_opt_state, make_train_step

    _, (model, tokens, targets) = entry()
    opt = init_opt_state(adamw, model)
    step = make_train_step(model.cfg)
    for _ in range(3):
        step(model, opt, tokens, targets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(model, opt, tokens, targets)
    torch.cuda.synchronize()
    plain_wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(model, opt, tokens, targets)
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
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    wall_ms = 1e3 * wall_s / steps
    busy_ms = busy_us / 1e3 / steps
    return {
        "device": torch.cuda.get_device_name(0),
        "steps": steps,
        "tokens_per_step": tokens.numel(),
        "wall_ms_per_step_unprofiled": plain_wall_ms,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": len(kernels) / steps,
        "groups_ms_per_step": {g: t / 1e3 / steps for g, t in
                               sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": name[:120], "ms_per_step": t / 1e3 / steps,
                         "calls_per_step": n / steps,
                         "share": t / busy_us, "group": _group(name)}
                        for name, (t, n) in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    doc = profile(args.steps)
    text = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
