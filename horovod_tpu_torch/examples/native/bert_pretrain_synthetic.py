"""BERT pretraining on synthetic data (reference analog: the BASELINE's
"BERT-Large pretraining (DistributedOptimizer + fp16 compression)" config).

Use --large for BERT-Large (needs the card's memory); default is
BERT-Base-shaped but tiny for smoke-running anywhere. The counterpart of
``examples/jax/bert_pretrain_synthetic.py`` on the port's own API: the
zoo's BERT on a ``{dp, tp}`` mesh of the world's ranks, AdamW 1e-4, bf16
on the card (BERT-Large's own dtype, fp32 for the tiny model on the CPU
with ``--device cpu``).

    python -m horovod_tpu_torch.runner.launch -np 1 python \\
        horovod_tpu_torch/examples/native/bert_pretrain_synthetic.py
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.bert import (Bert, BertConfig, adamw,
                                           bert_large, init_bert,
                                           make_bert_train_step, shard_batch)


def synthetic_batch(rng, B, S, vocab, dev):
    return {
        "input_ids": torch.from_numpy(rng.randint(0, vocab, (B, S))).to(dev),
        "token_type_ids": torch.zeros((B, S), dtype=torch.int64, device=dev),
        "attention_mask": torch.ones((B, S), dtype=torch.bool, device=dev),
        "mlm_labels": torch.from_numpy(rng.randint(0, vocab, (B, S))).to(dev),
        "mlm_mask": torch.from_numpy(rng.rand(B, S) < 0.15).float().to(dev),
        "nsp_labels": torch.from_numpy(rng.randint(0, 2, (B,))).to(dev),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width")
    ap.add_argument("--device", default=None,
                    help="where the model runs: this rank's card by "
                         "default, or e.g. cpu")
    args = ap.parse_args()

    hvd.init()
    dev = hvd.device() if args.device is None else torch.device(args.device)
    mesh = hvd.build_mesh(dp=-1, tp=args.tp)
    if args.large:
        cfg = bert_large()
    else:
        cfg = BertConfig(vocab_size=8192, hidden_size=256, num_layers=4,
                         num_heads=8, intermediate_size=1024,
                         dtype=torch.bfloat16
                         if dev.type == "cuda" else torch.float32)
    model = Bert(cfg, dev, mesh)
    init_bert(model, 0)
    opt = adamw(model.parameters(), 1e-4)
    step = make_bert_train_step(model, mesh)

    rng = np.random.RandomState(0)
    batch = shard_batch(synthetic_batch(rng, args.batch_size * hvd.size(),
                                        args.seq_len, cfg.vocab_size, dev),
                        mesh)

    model, opt, loss = step(model, opt, batch)  # warm-up
    float(loss)
    t0 = time.perf_counter()
    for i in range(args.steps):
        model, opt, loss = step(model, opt, batch)
    final = float(loss)
    dt = time.perf_counter() - t0
    if hvd.rank() == 0:
        seq_sec = args.batch_size * hvd.size() * args.steps / dt
        print(f"loss {final:.4f}; {seq_sec:.1f} sequences/sec")
    hvd.shutdown()


if __name__ == "__main__":
    main()
