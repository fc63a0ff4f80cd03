"""The operations a step needs, counted from the configuration and the
batch: the same count whatever implements the step.

A multiply-add is two operations; a step's backward pass costs twice its
forward (the gradient of the input and of the weight), so a step is three
forward passes. Operations outside matrix products and convolutions
(normalizations, activations, the loss) are left out, as model FLOPs
counts leave them out.
"""

from __future__ import annotations

from typing import Dict

import torch


def resnet_forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward pass: every convolution and
    the classifier. (He et al. Table 1 rounds this to 3.8e9 for v1; v1.5,
    with the stride on the 3x3, is 4.09e9.)"""
    size = cfg["image_size"]
    s = -(-size // cfg["stem_stride"])
    k = cfg["stem_kernel"]
    macs = k * k * cfg["channels"] * cfg["stem_width"] * s * s
    s = -(-s // 2)                                    # the 3x3/2 max pool
    width, e = cfg["stem_width"], cfg["expansion"]
    for stage, n in enumerate(cfg["stage_sizes"]):
        f = cfg["stem_width"] * 2 ** stage
        for j in range(n):
            stride = 2 if stage > 0 and j == 0 else 1
            o = -(-s // stride)
            macs += width * f * s * s                 # 1x1 at the input size
            macs += 9 * f * f * o * o                 # 3x3, strided
            macs += f * f * e * o * o                 # 1x1 out
            if width != f * e or stride != 1:
                macs += width * f * e * o * o         # projection
            width, s = f * e, o
    return macs + width * cfg["num_classes"]


def resnet_step(cfg: dict, batch: Dict[str, torch.Tensor]) -> float:
    """Operations of one training step over a global batch."""
    return 6.0 * resnet_forward_macs(cfg) * batch["labels"].shape[0]


def bert_step(cfg: dict, batch: Dict[str, torch.Tensor]) -> float:
    """Operations of one pretraining step over a global batch.

    Every position of every row goes through the encoder (the padded
    shape is the model's: BERT pretrains on fixed-length rows): per token
    ``2·(4H² + 2HI)`` a layer for the projections, and per row and layer
    ``4·S²·H`` for the scores and the weighted sum. The masked-LM head
    runs on the masked positions only (``2·(H² + V·H)`` each), as
    published (``max_predictions_per_seq``); the next-sentence head on one
    position a row."""
    H, I, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    rows, S = batch["input_ids"].shape
    masked = float(batch["mlm_mask"].sum())
    encoder = rows * L * (2.0 * S * (4 * H * H + 2 * H * I)
                          + 4.0 * S * S * H)
    heads = masked * 2.0 * (H * H + cfg["vocab_size"] * H) + rows * 4.0 * H
    return 3.0 * (encoder + heads)
