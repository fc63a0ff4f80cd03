"""Adasum gradient combination on a tiny curve-fitting model.

Run:  python -m horovod_tpu_torch.runner.launch -np 4 python \
          horovod_tpu_torch/examples/adasum/adasum_small_model.py
(``--device cpu`` runs on the CPU, this rank's card otherwise.)

Reference analog: ``examples/adasum/adasum_small_model.py`` — fit a small
polynomial with per-rank disjoint data and combine gradients with
``op=hvd.Adasum`` (VHDD adaptive summation: scales each contribution by
how orthogonal it is to the others, so the effective LR adapts to the
world size instead of requiring manual LR scaling).
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch.torch as hvd


def target(x):
    return 10 * x ** 3 + 5 * x ** 2 - 20 * x - 5


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="where the model runs: this rank's card by "
                        "default, or e.g. cpu")
    args = p.parse_args()

    hvd.init()
    torch.manual_seed(hvd.rank())
    dev = torch.device(args.device) if args.device else \
        torch.device("cuda", hvd.local_rank())

    # each rank fits on a DIFFERENT slice of the input domain —
    # exactly the regime Adasum's orthogonality weighting is built for
    lo = -2.0 + 4.0 * max(hvd.rank(), 0) / max(hvd.size(), 1)
    x = torch.linspace(lo, lo + 4.0 / max(hvd.size(), 1), 256).to(dev)
    y = target(x)

    param = torch.nn.Parameter(torch.tensor([1.0, -1.0, 1.0]).to(dev))
    opt = torch.optim.SGD([param], lr=1e-3)

    hvd.broadcast_parameters({"param": param.data}, root_rank=0)

    for step in range(200):
        opt.zero_grad()
        pred = 10 * x ** 3 + param[0] * x ** 2 + param[1] * x + param[2]
        loss = torch.mean((pred - y) ** 2)
        loss.backward()
        # Adasum-combine the gradient across ranks (reference:
        # hvd.allreduce(..., op=hvd.Adasum))
        param.grad.data = hvd.allreduce(param.grad.data, op=hvd.Adasum,
                                        name="grad")
        opt.step()
        if step % 50 == 0:
            avg = hvd.allreduce(loss.detach(), name="loss")
            if hvd.rank() == 0:
                print(f"step {step}: loss {float(avg):.4f} "
                      f"param {param.data.tolist()}")
    if hvd.rank() == 0:
        print(f"final param {param.data.tolist()} (target [5, -20, -5])")
    hvd.shutdown()


if __name__ == "__main__":
    main()
