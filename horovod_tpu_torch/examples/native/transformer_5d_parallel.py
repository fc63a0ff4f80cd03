"""Flagship demo: MoE transformer LM trained with all five parallelism axes
(dp / pp / ep / sp / tp) over a single mesh of the world's ranks.

One rank drives one card; the mesh is picked from the world size (all axes
exercised at 32 ranks or more, dp alone under 8):
  python -m horovod_tpu_torch.runner.launch -np 1 python \
      horovod_tpu_torch/examples/native/transformer_5d_parallel.py
On the CPU (gloo ranks) add ``--device cpu``.

The counterpart of ``examples/jax/transformer_5d_parallel.py`` on the
port's own API: the same mesh choice, seeds, batch and width, with two
heads of 64 (the JAX script's eight heads of 16 are below the head dims
the attention kernels take, 64 and 128; there the TPU kernel's tiling
refuses them too, and XLA runs the attention). Every step runs the
hand-written attention and cross-entropy kernels on the card.
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      init_opt_state, init_params,
                                      make_train_step, shard_batch,
                                      shard_params)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model runs: this rank's card by "
                         "default, or e.g. cpu")
    args = ap.parse_args()

    hvd.init()
    dev = hvd.device() if args.device is None else torch.device(args.device)
    n = hvd.size()
    # pick a mesh for the available ranks (all axes exercised at n >= 32)
    if n >= 32:
        mesh = hvd.build_mesh(dp=n // 16, pp=2, ep=2, sp=2, tp=2)
        n_stages = 2
    elif n >= 8:
        mesh = hvd.build_mesh(dp=n // 8, pp=2, sp=2, tp=2)
        n_stages = 2
    else:
        mesh = hvd.build_mesh(dp=-1)
        n_stages = 1
    print("mesh:", dict(mesh.shape))

    cfg = TransformerConfig(
        vocab_size=1024, d_model=128, n_heads=2, n_layers=4, d_ff=256,
        max_seq=128, n_experts=4 if mesh.shape.get("ep", 1) > 1 else 0,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        n_microbatches=2)

    model = Transformer(cfg, dev, mesh)
    model.load_state_dict(shard_params(
        init_params(np.random.RandomState(0), cfg, n_stages), cfg, mesh))
    # optax.adamw(3e-4): weight decay 1e-4
    opt = init_opt_state(lambda ps: torch.optim.AdamW(
        ps, lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        model)
    step = make_train_step(cfg, mesh)

    rng = np.random.RandomState(1)
    B, S = 16, 128
    tokens = rng.randint(0, cfg.vocab_size, (B, S))
    targets = np.roll(tokens, -1, 1)
    tokens, targets = shard_batch(torch.from_numpy(tokens).to(dev),
                                  torch.from_numpy(targets).to(dev), mesh)

    for i in range(10):
        model, opt, loss, aux = step(model, opt, tokens, targets)
        print(f"step {i}: loss {float(loss):.4f} aux {float(aux):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
