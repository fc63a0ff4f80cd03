"""One rank of the tiny flagship trained through a ``horovod.torch``
adapter: ``--pkg jax`` the JAX package's (``horovod_tpu.torch``, numpy
round trips through its core), ``--pkg port`` the port's
(``horovod_tpu_torch.torch`` over the port's core). Both train the port's
torch flagship from the seed-0 weights of ``entry(device="cpu",
tiny=True)`` (the JAX parameters carried across by
``from_jax_params``) on this rank's half of the batch, three AdamW steps
through ``DistributedOptimizer(named_parameters=...)``, and save every
step's loss, synchronized gradients and the final parameters to
``DIR/<pkg>.rank<r>.npz``. Launched by ``test_torch_port_hvd_torch.py``
with a launcher's identity in the environment."""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS = 3


def main(pkg: str, out_dir: str) -> None:
    import torch
    if pkg == "jax":
        import horovod_tpu.torch as hvd
    else:
        import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models import adamw
    from horovod_tpu_torch.models.transformer import forward_loss_spmd

    torch.set_num_threads(1)
    hvd.init()
    rank, size = hvd.rank(), hvd.size()
    _, (model, tokens, targets) = entry(device="cpu", tiny=True)
    rows = tokens.shape[0] // size
    mine = slice(rank * rows, (rank + 1) * rows)
    opt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    res = {}
    for step in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss, aux = forward_loss_spmd(model, tokens[mine], targets[mine])
        (loss + 0.01 * aux).backward()
        opt.step()
        res[f"loss{step}"] = np.asarray([float(loss)])
        for name, p in model.named_parameters():
            res[f"grad{step}.{name}"] = p.grad.detach().numpy().copy()
    for name, p in model.named_parameters():
        res[f"param.{name}"] = p.detach().numpy().copy()
    np.savez(os.path.join(out_dir, f"{pkg}.rank{rank}.npz"), **res)
    hvd.barrier()
    hvd.shutdown()
    if pkg == "port":
        assert not [m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "horovod_tpu")], "the port imported JAX"
    print(f"{pkg} adapter worker {rank}: OK", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", choices=("jax", "port"), required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    main(a.pkg, a.out)
