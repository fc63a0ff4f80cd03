"""Multi-rank dry run: one full train step of the flagship per layout of
the JAX package's dry-run table, in a world of ``n`` ranks.

Mirrors ``__graft_entry__._run_layout`` and ``dryrun_multichip``: each
layout builds its mesh, the seed-0 parameters sliced for this rank, the
seed-1 batch sharded over ``(dp, ep)`` and sp, and takes one AdamW step of
``make_train_step`` (forward, backward, gradient sync, optimizer). The
tiny flagship (V 256, M 64, 4 heads, L 4, F 128, fp32, 2 pipeline
microbatches) at B 8, S 32, with ``n_experts=4`` and one microbatch for
the MoE layouts, as in the JAX table; a layout with pp runs GPipe.

``dryrun_multichip(n)`` starts the world as ``n`` processes of this module
(``python -m horovod_tpu_torch.dryrun --rank``), each with its launcher
identity and a timeout, kills them on the way out, and returns rank 0's
loss per layout. ``device="cpu"`` runs gloo on the CPU (the tests); on the
card each rank drives its own card over NCCL, or, on a host with fewer
cards than ranks, all ranks share ``cuda:0`` over gloo. The JAX
package's ``_scaling_curve`` stays with the benchmark.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

B, S = 8, 32
TIMEOUT_S = 300.0


def layouts(n: int) -> List[Tuple[bool, Dict[str, int]]]:
    """``(moe, mesh sizes)`` per layout for a world of ``n``, the table of
    ``__graft_entry__._dryrun_child``."""
    if n >= 32:
        kw = dict(dp=n // 16, pp=2, sp=2, tp=2, ep=2)
        return [(False, kw), (True, dict(kw))]
    return {16: [(False, dict(dp=2, pp=2, sp=2, tp=2)),
                 (True, dict(dp=2, ep=2, sp=2, tp=2))],
            8: [(False, dict(dp=2, pp=2, tp=2)),
                (True, dict(dp=2, ep=2, sp=2))],
            4: [(False, dict(dp=2, tp=2)), (True, dict(ep=2, sp=2))],
            2: [(False, dict(dp=1, tp=2)), (True, dict(ep=2))],
            }.get(n, [(False, dict(dp=1))])


def _cfg(moe: bool):
    from horovod_tpu_torch.entry import _flagship_cfg
    cfg = _flagship_cfg(tiny=True)
    return dataclasses.replace(cfg, n_experts=4, n_microbatches=1) if moe \
        else cfg


def _run_layout(moe: bool, sizes: Dict[str, int], dev) -> float:
    """One AdamW step of the layout on this rank; the layout's loss."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          init_params, make_train_step,
                                          shard_params)
    cfg = _cfg(moe)
    mesh = hvd.build_mesh(**sizes)
    model = Transformer(cfg, dev, mesh)
    model.load_state_dict(shard_params(
        init_params(np.random.RandomState(0), cfg), cfg, mesh))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, S))
    targets = np.roll(tokens, -1, 1)
    tok, tgt = hvd.shard_batch(torch.from_numpy(tokens).to(dev),
                               torch.from_numpy(targets).to(dev), mesh)
    step = make_train_step(cfg, mesh)
    _, _, loss, _ = step(model, init_opt_state(adamw, model), tok, tgt)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"layout {sizes}: loss {loss}")
    return loss


def _rank_main(n: int, out: str) -> int:
    import horovod_tpu_torch as hvd
    hvd.init()
    dev = torch.device("cpu") if os.environ.get("HVD_DRYRUN_DEVICE") == "cpu" \
        else hvd.device()
    losses = {}
    for moe, sizes in layouts(n):
        losses[json.dumps(sizes)] = _run_layout(moe, sizes, dev)
        if hvd.rank() == 0:
            print(f"[dryrun] mesh={sizes} moe={moe} loss={losses[json.dumps(sizes)]:.6f}",
                  flush=True)
    with open(os.path.join(out, f"rank{hvd.rank()}.json"), "w") as f:
        json.dump(losses, f)
    hvd.shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n: int, device: Optional[str] = None,
                     timeout: float = TIMEOUT_S) -> Dict[str, float]:
    """Run every layout of the table for ``n`` ranks (one train step each)
    and return ``{json mesh sizes: loss}`` (rank 0's; every rank checks
    its own loss is finite). Raises if a rank fails or outlives
    ``timeout``."""
    cpu = device == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the dry run on the CPU explicitly")
    cards = 0 if cpu else torch.cuda.device_count()
    shared = not cpu and cards < n
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out:
        procs, logs = [], []
        for r in range(n):
            # ranks sharing one card are one-card "hosts" over gloo
            local = (0, 1, r, n) if shared else (r, n, 0, 1)
            env = dict(os.environ, HVD_TPU_RANK=str(r), HVD_TPU_SIZE=str(n),
                       HVD_TPU_LOCAL_RANK=str(local[0]),
                       HVD_TPU_LOCAL_SIZE=str(local[1]),
                       HVD_TPU_CROSS_RANK=str(local[2]),
                       HVD_TPU_CROSS_SIZE=str(local[3]),
                       HVD_TPU_RENDEZVOUS_ADDR="127.0.0.1",
                       HVD_TPU_RENDEZVOUS_PORT=str(port),
                       HVD_TPU_GLOO_TIMEOUT_SECONDS=str(int(timeout)),
                       HOROVOD_TPU_OPERATIONS="GLOO" if cpu or shared
                       else "NCCL",
                       PYTHONPATH=os.pathsep.join(
                           [repo] + [p for p in [os.environ.get("PYTHONPATH")]
                                     if p]))
            if cpu:
                env.update(HVD_DRYRUN_DEVICE="cpu", OMP_NUM_THREADS="1")
            log = open(os.path.join(out, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.dryrun", "--rank",
                 str(n), out], env=env, cwd=repo, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(timeout=60)
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        print(texts[0], end="", flush=True)
        failed = [f"rank {r} exited {p.returncode}:\n{t[-3000:]}"
                  for r, (p, t) in enumerate(zip(procs, texts))
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"dryrun_multichip({n}) failed (timeout "
                               f"{timeout:.0f} s):\n" + "\n".join(failed))
        with open(os.path.join(out, "rank0.json")) as f:
            losses = json.load(f)
    return losses


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(_rank_main(int(sys.argv[2]), sys.argv[3]))
    n_ranks = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(json.dumps(dryrun_multichip(n_ranks)))
