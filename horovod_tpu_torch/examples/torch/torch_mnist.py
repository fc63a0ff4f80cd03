"""Drop-in PyTorch training with the torch adapter.

Run on this rank's card:     python horovod_tpu_torch/examples/torch/torch_mnist.py
Run multi-process (2 ranks): python -m horovod_tpu_torch.runner.launch -np 2 \
                                 python horovod_tpu_torch/examples/torch/torch_mnist.py
Run on the CPU:              add ``--device cpu``

Reference analog: ``examples/pytorch/pytorch_mnist.py`` — a reference user
changes ``import horovod.torch as hvd`` to ``import horovod_tpu_torch.torch
as hvd`` and keeps the rest of the script: DistributedOptimizer with
gradient hooks, broadcast of parameters and optimizer state from rank 0,
per-rank data shard, metric allreduce. Synthetic data keeps it hermetic.
The counterpart of ``examples/torch/torch_mnist.py``: the same model,
seeds and printed lines, on a device.
"""

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(64, 128)
        self.fc2 = nn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def make_data(n=4096, d=64, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n, classes)).argmax(-1)
    return torch.from_numpy(x), torch.from_numpy(y)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="where the model runs: this rank's card by "
                        "default, or e.g. cpu")
    args = p.parse_args()

    hvd.init()
    torch.manual_seed(42)
    dev = torch.device(args.device) if args.device else \
        torch.device("cuda", hvd.local_rank())

    x, y = make_data()
    # per-rank shard (reference: DistributedSampler)
    shard = slice(hvd.rank(), None, hvd.size())
    x, y = x[shard].to(dev), y[shard].to(dev)

    model = Net().to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)

    # identical start everywhere, then hook-driven gradient averaging
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16)

    batch = 128
    for epoch in range(3):
        perm = torch.randperm(len(x)).to(dev)
        # shard smaller than one batch: no steps
        loss = torch.zeros((), device=dev)
        for i in range(0, len(x) - batch + 1, batch):
            idx = perm[i:i + batch]
            opt.zero_grad()
            loss = F.cross_entropy(model(x[idx]), y[idx])
            loss.backward()
            opt.step()
        avg = hvd.allreduce(loss.detach(), name="epoch_loss")
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {float(avg):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
