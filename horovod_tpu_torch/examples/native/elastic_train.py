"""Elastic training with committed state (reference analog:
``examples/elastic/pytorch/pytorch_mnist_elastic.py``).

Run:  python -m horovod_tpu_torch.runner.launch --min-np 2 \\
          --host-discovery-script ./discover.sh \\
          python horovod_tpu_torch/examples/native/elastic_train.py
where discover.sh prints lines like "localhost:2" (``--device cpu`` runs
on the CPU, this rank's card otherwise).

The counterpart of ``examples/jax/elastic_train.py`` on the port's own
API: a ``TorchState`` over the weight and its SGD state (the JAX
``TpuState`` over the parameter tree), the same seeds and 20 epochs.
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.torch.elastic import TorchState


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model runs: this rank's card by "
                         "default, or e.g. cpu")
    args = ap.parse_args()

    hvd.init()
    dev = hvd.device() if args.device is None else torch.device(args.device)
    params = torch.nn.ParameterDict(
        {"w": torch.nn.Parameter(torch.zeros((32, 4), device=dev))})
    hvd.broadcast_parameters(params.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params.parameters(),
                                                   lr=0.05))
    state = TorchState(model=params, optimizer=opt, name="elastic_example",
                       epoch=0)

    rng = np.random.RandomState(hvd.rank())
    W_true = np.random.RandomState(0).randn(32, 4).astype(np.float32)

    @elastic.run
    def train(state):
        for epoch in range(state.epoch, 20):
            x = torch.from_numpy(rng.randn(64, 32).astype(np.float32)).to(dev)
            y = x @ torch.from_numpy(W_true).to(dev)
            opt.zero_grad()
            loss = torch.mean((x @ params["w"] - y) ** 2)
            loss.backward()
            opt.step()
            state.epoch = epoch + 1
            state.commit()  # survives worker loss / membership change
            if hvd.rank() == 0:
                print(f"epoch {epoch}: loss {float(loss):.5f}", flush=True)
        return state.epoch

    final = train(state)
    print(f"rank {hvd.rank()}: finished at epoch {final}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
