"""Data-parallel MLP training — the hello-world of the framework.

Run on this rank's card:     python horovod_tpu_torch/examples/native/mnist_dp.py
Run multi-process (2 ranks): python -m horovod_tpu_torch.runner.launch -np 2 \
                                 python horovod_tpu_torch/examples/native/mnist_dp.py
Run on the CPU:              add ``--device cpu``

Reference analog: ``examples/pytorch/pytorch_mnist.py`` — per-rank data
shard, DistributedOptimizer, broadcast of initial state from rank 0.
Synthetic data keeps the example hermetic (no downloads). The counterpart
of ``examples/jax/mnist_dp.py`` on the port's own API: the same data,
shard, initial weights and optimizer, the gradient averaged with bf16 on
the wire by the port's ``DistributedOptimizer``.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.data import ShardedDataset


def make_data(n=4096, d=64, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n, classes)).argmax(-1).astype(np.int32)
    return x, y


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="where the model runs: this rank's card by "
                        "default, or e.g. cpu")
    args = p.parse_args()

    hvd.init()
    dev = hvd.device() if args.device is None else torch.device(args.device)
    x, y = make_data()
    ds = ShardedDataset(list(zip(x, y)), rank=max(hvd.rank(), 0),
                        size=hvd.size(), seed=1)

    def leaf(a):
        return torch.tensor(a, dtype=torch.float32, device=dev,
                            requires_grad=True)

    params = {
        "w1": leaf(np.random.RandomState(2).randn(64, 128) * 0.1),
        "b1": leaf(np.zeros(128)),
        "w2": leaf(np.random.RandomState(3).randn(128, 10) * 0.1),
        "b2": leaf(np.zeros(10)),
    }
    # identical start everywhere (reference: broadcast_parameters)
    params = hvd.broadcast_parameters(params, root_rank=0)

    # gradient averaging across workers + bf16 transport compression
    opt = hvd.DistributedOptimizer(torch.optim.Adam(params.values(), lr=1e-3),
                                   compression=hvd.Compression.bf16)

    def loss_fn(p, xb, yb):
        h = torch.tanh(xb @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        return F.cross_entropy(logits, yb.long())

    batch = 128
    for epoch in range(3):
        ds.set_epoch(epoch)
        items = list(ds)
        for i in range(0, len(items) - batch + 1, batch):
            xb = torch.from_numpy(
                np.stack([it[0] for it in items[i:i + batch]])).to(dev)
            yb = torch.from_numpy(
                np.stack([it[1] for it in items[i:i + batch]])).to(dev)
            opt.zero_grad()
            loss = loss_fn(params, xb, yb)
            loss.backward()
            opt.step()
        avg = hvd.allreduce(loss.detach(), name="epoch_loss")
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {float(avg):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
