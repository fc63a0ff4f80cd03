"""Synthetic throughput harness for the torch drop-in adapter.

Reference analog: ``examples/pytorch/pytorch_synthetic_benchmark.py`` —
the canonical "always prints img/sec" harness: warm-up batches, timed
iterations, per-rank rate allreduced to a total. The model is the small
conv net of ``examples/torch/torch_synthetic_benchmark.py``, on this
rank's card (``cuda:<local_rank>``), or on the CPU with ``--device cpu``;
the gradients cross the core's TCP ring, so the number it prints prices
the adapter and that data plane as much as the card.

Run:
    python horovod_tpu_torch/examples/torch/torch_synthetic_benchmark.py
    python -m horovod_tpu_torch.runner.launch -np 2 python \
        horovod_tpu_torch/examples/torch/torch_synthetic_benchmark.py \
        --fp16-allreduce
"""

import argparse
import timeit

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


def small_conv(classes=10):
    return nn.Sequential(
        nn.Conv2d(3, 32, 3, padding=1), nn.ReLU(),
        nn.Conv2d(32, 64, 3, stride=2, padding=1), nn.ReLU(),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(64, classes))


def main():
    p = argparse.ArgumentParser(
        description="Torch adapter synthetic benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="fp16 compression during allreduce")
    p.add_argument("--use-adasum", action="store_true",
                   help="adasum reduction instead of averaging")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-warmup-batches", type=int, default=5)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="where the model runs: this rank's card by "
                        "default, or e.g. cpu")
    args = p.parse_args()

    hvd.init()
    torch.manual_seed(0)
    dev = torch.device(args.device) if args.device else \
        torch.device("cuda", hvd.local_rank())

    model = small_conv().to(dev)
    lr_scaler = hvd.size() if not args.use_adasum else 1
    opt = torch.optim.SGD(model.parameters(), lr=0.01 * lr_scaler)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(),
        compression=compression,
        op=hvd.Adasum if args.use_adasum else hvd.Average)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    data = torch.randn(args.batch_size, 3, args.image_size,
                       args.image_size).to(dev)
    target = torch.randint(0, 10, (args.batch_size,)).to(dev)

    def benchmark_step():
        opt.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        opt.step()

    def log(s):
        if hvd.rank() == 0:
            print(s)

    log(f"Model: small_conv, batch size {args.batch_size}, "
        f"{hvd.size()} process(es)")
    timeit.timeit(benchmark_step, number=args.num_warmup_batches)

    img_secs = []
    for _ in range(args.num_iters):
        t = timeit.timeit(benchmark_step, number=args.num_batches_per_iter)
        img_secs.append(args.batch_size * args.num_batches_per_iter / t)

    img_sec_mean, img_sec_conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    log(f"Img/sec per process: {img_sec_mean:.1f} +- {img_sec_conf:.1f}")
    total = hvd.allreduce(torch.tensor([img_sec_mean]), op=hvd.Sum,
                          name="total_img_sec")
    log(f"Total img/sec on {hvd.size()} process(es): "
        f"{float(total[0]):.1f} +- {hvd.size() * img_sec_conf:.1f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
