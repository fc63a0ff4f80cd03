"""Elastic PyTorch training: TorchState + ElasticSampler.

Run with a changing world:
    hvdrun -np 2 --min-np 1 --max-np 4 \
        --host-discovery-script ./discover.sh \
        python horovod_tpu_torch/examples/torch/torch_elastic_mnist.py

(``hvdrun`` is ``python -m horovod_tpu_torch.runner.launch``; ``--device
cpu`` runs on the CPU, this rank's card otherwise.)

Reference analog: ``examples/elastic/pytorch/pytorch_mnist_elastic.py`` —
the ``@hvd.elastic.run`` decorator retries the training function across
world-size changes; ``TorchState`` commits/restores model + optimizer +
sampler; ``ElasticSampler`` re-shards unprocessed indices so no example is
dropped or repeated within an epoch after a resize.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
import horovod_tpu_torch.elastic as elastic
from horovod_tpu_torch.torch.elastic import ElasticSampler, TorchState


def make_data(n=2048, d=32, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w).argmax(-1)
    return torch.from_numpy(x), torch.from_numpy(y)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="where the model runs: this rank's card by "
                        "default, or e.g. cpu")
    args = p.parse_args()

    hvd.init()
    torch.manual_seed(0)
    dev = torch.device(args.device) if args.device else \
        torch.device("cuda", hvd.local_rank())
    x, y = make_data()
    x, y = x.to(dev), y.to(dev)

    model = torch.nn.Sequential(
        torch.nn.Linear(32, 64), torch.nn.Tanh(),
        torch.nn.Linear(64, 10)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters())
    sampler = ElasticSampler(range(len(x)), shuffle=True)
    state = TorchState(model=model, optimizer=opt, sampler=sampler,
                       epoch=0, batch_idx=0)

    @elastic.run
    def train(state):
        batch = 64
        while state.epoch < 3:
            # iterating the sampler re-derives this rank's shard of the
            # indices NOT yet processed this epoch (elastic resume point)
            order = list(sampler)
            loss = None
            for i in range(0, len(order), batch):
                idx = order[i:i + batch]
                opt.zero_grad()
                loss = F.cross_entropy(model(x[idx]), y[idx])
                loss.backward()
                opt.step()
                sampler.record_indices(idx)
                state.batch_idx += 1
                if state.batch_idx % 10 == 0:
                    state.commit()  # host updates surface here
            if hvd.rank() == 0 and loss is not None:
                print(f"epoch {state.epoch}: loss "
                      f"{float(loss.detach()):.4f} world={hvd.size()}")
            state.epoch += 1
            state.batch_idx = 0
            # contract: set_epoch at the END of the epoch clears the
            # processed set (see ElasticSampler docstring)
            sampler.set_epoch(state.epoch)
            state.commit()

    train(state)
    hvd.shutdown()


if __name__ == "__main__":
    main()
