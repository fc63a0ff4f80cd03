"""Distributed training on a Ray cluster via RayExecutor.

Run (requires ray):  python horovod_tpu_torch/examples/ray/ray_mnist.py

Reference analog: ``examples/ray/tensorflow2_mnist_ray.py`` /
``basic_ray_elastic.py`` — the executor places one worker per slot on the
Ray cluster, wires the coordinator address through Ray actors, and runs
the training function on every rank. The training function is the
data-parallel loop of ``examples/ray/ray_mnist.py`` in torch: the same
data, seeds and optimizer, the gradient averaged by the port's
``DistributedOptimizer``, on the host.
"""


def train_fn():
    import numpy as np
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd

    hvd.init()
    rng = np.random.RandomState(0)
    w_true = rng.randn(32, 10)
    x = rng.randn(2048, 32).astype(np.float32)
    y = (x @ w_true).argmax(-1).astype(np.int32)
    shard = slice(max(hvd.rank(), 0), None, hvd.size())
    x, y = torch.from_numpy(x[shard]), torch.from_numpy(y[shard]).long()

    params = {"w": torch.zeros((32, 10), requires_grad=True)}
    params = hvd.broadcast_parameters(params, root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.Adam(params.values(),
                                                    lr=1e-2))

    loss = None
    for step in range(100):
        opt.zero_grad()
        loss = F.cross_entropy(x @ params["w"], y)
        loss.backward()
        opt.step()
    out = float(hvd.allreduce(loss.detach(), name="loss"))
    if hvd.rank() == 0:
        print(f"final loss {out:.4f}")
    hvd.shutdown()
    return out


def main():
    from horovod_tpu_torch.ray import RayExecutor

    executor = RayExecutor(num_workers=2, cpus_per_worker=1)
    executor.start()
    results = executor.run(train_fn)
    print(f"per-rank results: {results}")
    executor.shutdown()


if __name__ == "__main__":
    main()
