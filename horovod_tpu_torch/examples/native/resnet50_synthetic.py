"""ResNet-50 synthetic-data throughput (reference analog:
``examples/pytorch/pytorch_synthetic_benchmark.py`` /
``examples/tensorflow2/tensorflow2_synthetic_benchmark.py``).

Prints img/sec like the reference's synthetic benchmarks. The counterpart
of ``examples/jax/resnet50_synthetic.py`` on the port's own API: the
zoo's ResNet-50 (bf16 on the card, fp32 on the CPU with ``--device
cpu``), one data-parallel rank per card, each stepping on its block of
the global batch with SGD-momentum 0.1/0.9.

    python -m horovod_tpu_torch.runner.launch -np 1 python \\
        horovod_tpu_torch/examples/native/resnet50_synthetic.py
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.resnet import (ResNet50, create_resnet_state,
                                             make_resnet_train_step)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=256,
                    help="per-card batch size")
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--num-warmup", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="where the model runs: this rank's card by "
                         "default, or e.g. cpu")
    args = ap.parse_args()

    hvd.init()
    dev = hvd.device() if args.device is None else torch.device(args.device)
    mesh = hvd.build_mesh(dp=-1)
    n_chips = hvd.size()
    B = args.batch_size * n_chips

    model = ResNet50(dtype=torch.bfloat16 if dev.type == "cuda"
                     else torch.float32, device=dev, mesh=mesh)
    create_resnet_state(model, 0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = make_resnet_train_step(model, mesh)

    # the global batch, as the JAX script draws it (NHWC); this rank's
    # block of it, channels first
    rng = np.random.RandomState(0)
    rows = slice(hvd.rank() * args.batch_size,
                 (hvd.rank() + 1) * args.batch_size)
    images = torch.from_numpy(rng.rand(B, 224, 224, 3)[rows]).permute(
        0, 3, 1, 2).to(dev, model.dtype)
    labels = torch.from_numpy(rng.randint(0, 1000, (B,))[rows]).to(dev)

    for _ in range(args.num_warmup):
        model, opt, loss = step(model, opt, images, labels)
    float(loss)  # drain

    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        model, opt, loss = step(model, opt, images, labels)
    float(loss)
    dt = time.perf_counter() - t0
    img_sec = B * args.num_iters / dt
    if hvd.rank() == 0:
        print(f"Total img/sec: {img_sec:.1f} "
              f"({img_sec / n_chips:.1f} per chip, {n_chips} chips)")
    hvd.shutdown()


if __name__ == "__main__":
    main()
