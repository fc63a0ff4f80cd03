#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the flagship's
training step gives it, and times both beside a PyTorch library call and
the card's bound. Then it drives the main path through the entry points a
user calls: the flagship transformer's forward at full width from
``entry()`` (held against the same model in fp32 on the CPU), and five
AdamW steps of ``make_train_step`` on one batch, whose loss must fall.
Kernel launch counters are zeroed just before the main path and read just
after: every kernel must have run there, four attention launches (one per
layer) and one cross-entropy launch per forward.

Every phase prints one line; any failure raises and exits non-zero, and
nothing falls back to the CPU. The last lines are the card's name and
power limit, a JSON line with each kernel's numbers, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12    # dense bf16 tensor cores
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
TRAIN_STEPS = 5


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls.
    A spin kernel holds the stream while the host queues the calls, so
    the host's time per call (Python, argument checks, the launch) does
    not leave the card idle inside the timed window."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)   # about 50 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_flash(torch, attention, dev):
    """flash_attn_fwd against plain_attention_with_lse; timed at the
    flagship's shape (B 8, S 256, H 8, D 64, bf16, causal)."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [  # B, S, H, D, dtype, causal, tolerance
        (8, 256, 8, 64, torch.bfloat16, True, 2e-2),   # the main path's call
        (8, 256, 8, 64, torch.float32, True, 1e-4),
        (8, 256, 8, 64, torch.float32, False, 1e-4),
        (8, 200, 8, 64, torch.bfloat16, True, 2e-2),   # ragged S
        (8, 200, 8, 64, torch.float32, False, 1e-4),
        (4, 256, 8, 128, torch.bfloat16, True, 2e-2),  # D = 128
        (4, 200, 8, 128, torch.float32, True, 1e-4),
    ]
    main_err = None
    for B, S, H, D, dt, causal, tol in cases:
        q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
                   for _ in range(3))
        scale = 1.0 / D ** 0.5
        o, lse = attention.flash_attn_fwd_cuda(q, k, v, causal, scale)
        o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal,
                                                            scale)
        torch.cuda.synchronize()
        e_o, e_lse = max_err(o, o_ref), max_err(lse, lse_ref)
        say("flash_attention_fwd", shape=f"{B}x{S}x{H}x{D}",
            dtype=str(dt).split(".")[-1], causal=causal, max_abs_err_o=e_o,
            max_abs_err_lse=e_lse, tol=tol)
        check(e_o <= tol and e_lse <= tol,
              f"flash_attn_fwd disagrees with the plain version at "
              f"{(B, S, H, D, dt, causal)}: {e_o}, {e_lse} > {tol}")
        if main_err is None:
            main_err = max(e_o, e_lse)

    B, S, H, D = 8, 256, 8, 64
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = 1.0 / D ** 0.5
    ms = time_ms(lambda: attention.flash_attn_fwd_cuda(q, k, v, True, scale))
    plain = time_ms(lambda: attention.plain_attention_with_lse(q, k, v, True,
                                                               scale))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    n_bytes = 4 * B * S * H * D * 2 + B * H * S * 4   # q, k, v in; o, lse out
    pairs = S * (S + 1) // 2                          # causal (q, k) pairs
    n_ops = B * H * pairs * D * 4                     # q.k and p.v, 2 each
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    say("flash_attention_fwd", timed="8x256x8x64 bf16 causal", ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    return dict(name="flash_attention_fwd", route="cuda",
                source="horovod_tpu_torch/csrc/flash_attn_fwd.cu",
                replaces="horovod_tpu/ops/pallas_attention.py:41",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


def phase_xent(torch, xent, dev):
    """xent_fwd against plain_xent at the flagship's [2048, 32000], with
    labels -1 and V mixed in; timed in bf16."""
    N, V = 2048, 32000
    g = torch.Generator(device=dev).manual_seed(1)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::97] = -1
    labels[5::89] = V
    tol = 1e-5   # relative: both compute in fp32 from the same inputs
    main_err = None
    for dt in (torch.bfloat16, torch.float32):
        logits = (torch.randn(N, V, generator=g, device=dev) * 2.0).to(dt)
        loss, lse = xent.xent_fwd_cuda(logits, labels)
        loss_ref, lse_ref = xent.plain_xent(logits, labels)
        torch.cuda.synchronize()
        e = max(max_err(loss, loss_ref), max_err(lse, lse_ref))
        rel = float(torch.maximum(
            ((loss - loss_ref).abs() / loss_ref.abs().clamp_min(1e-6)).max(),
            ((lse - lse_ref).abs() / lse_ref.abs()).max()))
        oor = (labels < 0) | (labels >= V)
        say("xent_fwd", shape=f"{N}x{V}", dtype=str(dt).split(".")[-1],
            max_abs_err=e, max_rel_err=rel, tol_rel=tol,
            out_of_range_labels=int(oor.sum()))
        check(rel <= tol, f"xent_fwd disagrees with the plain version in "
                          f"{dt}: relative {rel} > {tol}")
        check(bool(torch.equal(loss[oor], lse[oor])),
              "an out-of-range label must give loss = lse")
        if main_err is None:
            main_err = e

    logits = (torch.randn(N, V, generator=g, device=dev) * 2.0).to(
        torch.bfloat16)
    ms = time_ms(lambda: xent.xent_fwd_cuda(logits, labels))
    plain = time_ms(lambda: xent.plain_xent(logits, labels))
    lib = time_ms(lambda: torch.logsumexp(logits, dim=-1))
    n_bytes = N * V * 2 + N * 8 + 2 * N * 4     # logits, labels in; 2 out
    n_ops = N * V * 4                           # max, subtract, exp, add
    b_ms, b_by = bound_ms(n_bytes, n_ops, FP32_FLOPS)
    say("xent_fwd", timed="2048x32000 bf16", ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    return dict(name="xent_fwd", route="cuda",
                source="horovod_tpu_torch/csrc/xent_fwd.cu",
                replaces="horovod_tpu/ops/pallas_xent.py:43",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          make_forward, make_train_step)
    from horovod_tpu_torch.ops import _build, attention, xent

    # full fp32 in every fp32 comparison (cuBLAS would otherwise be free to
    # pick TF32 for the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)

    # -- build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    _build.build_all()
    say("build", kernels=",".join(_build.KERNELS),
        seconds=time.perf_counter() - t0)

    # -- each kernel against its plain version, and timed
    kernels = [phase_flash(torch, attention, dev),
               phase_xent(torch, xent, dev)]

    # -- the main path: entry() forward, then the trainer
    counters = (attention.flash_attn_fwd_cuda, xent.xent_fwd_cuda)
    for c in counters:
        c.launches = 0
    fn, (model, tokens, targets) = entry()
    check(tokens.is_cuda and next(model.parameters()).is_cuda,
          "entry() did not put the model on the card")
    t0 = time.perf_counter()
    loss = float(fn(model, tokens, targets))
    fwd_s = time.perf_counter() - t0
    after_entry = [c.launches for c in counters]
    n_layers = model.cfg.n_layers
    check(after_entry == [n_layers, 1],
          f"entry forward launched {after_entry}, expected [{n_layers}, 1]")
    check(math.isfinite(loss), f"entry loss {loss} is not finite")

    cfg32 = dataclasses.replace(model.cfg, dtype=torch.float32)
    ref_model = Transformer(cfg32, device="cpu")
    ref_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    ref = float(make_forward(cfg32)(ref_model, tokens.cpu(), targets.cpu()))
    rel = abs(loss - ref) / abs(ref)
    say("entry", width="V32000 M512 H8x64 L4 F2048 S256 B8 bf16", loss=loss,
        cpu_fp32_loss=ref, rel_err=rel, tol_rel=2e-2, first_call_s=fwd_s)
    check(rel <= 2e-2, f"entry loss {loss} vs CPU fp32 {ref}: {rel} > 2e-2")

    opt = init_opt_state(adamw, model)
    step = make_train_step(model.cfg)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, l, _ = step(model, opt, tokens, targets)
        losses.append(float(l))
        step_s.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    forwards = 1 + TRAIN_STEPS
    timed = sorted(step_s[1:])                       # after the warm-up step
    med = timed[len(timed) // 2]
    tokens_per_s = tokens.numel() / med
    say("train", steps=TRAIN_STEPS, losses=",".join(f"{x:.6f}" for x in losses),
        step_ms=",".join(f"{1e3 * s:.3f}" for s in step_s),
        median_step_ms_after_warmup=1e3 * med, tokens_per_s=tokens_per_s)
    check(all(map(math.isfinite, losses)), f"non-finite train loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} "
                                  f"steps: {losses}")
    check(launches == [n_layers * forwards, forwards],
          f"main path launched {launches}, expected "
          f"[{n_layers * forwards}, {forwards}]")
    for k, n in zip(kernels, launches):
        check(n > 0, f"{k['name']} was never launched on the main path")
        k["launches"] = n
    say("main_path", flash_attention_fwd_launches=launches[0],
        xent_fwd_launches=launches[1], forwards=forwards)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
