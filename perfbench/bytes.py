"""The bytes and operations a layer cannot do without, counted from the
configuration's shapes and the batch: the numerator of a roofline share.

Each input of the layer is read once and each output written once per
pass, in the dtypes the configuration states; whatever an implementation
reads again, or keeps in between, is its own cost.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def resnet_bn_elements(cfg: dict) -> int:
    """Elements one image puts through batch normalization: every BN
    layer's input, channels x height x width."""
    s = -(-cfg["image_size"] // cfg["stem_stride"])
    total = cfg["stem_width"] * s * s
    s = -(-s // 2)
    width, e = cfg["stem_width"], cfg["expansion"]
    for stage, n in enumerate(cfg["stage_sizes"]):
        f = cfg["stem_width"] * 2 ** stage
        for j in range(n):
            stride = 2 if stage > 0 and j == 0 else 1
            o = -(-s // stride)
            total += f * s * s + f * o * o + f * e * o * o
            if width != f * e or stride != 1:
                total += f * e * o * o
            width, s = f * e, o
    return total


def resnet_bn_bytes(cfg: dict, batch: Dict[str, torch.Tensor]) -> float:
    """A step's batch normalization, per rank's share of the global batch
    is the caller's to divide: forward reads x and writes y, backward
    reads x and dy and writes dx, all in the compute dtype."""
    b = DTYPE_BYTES[cfg["precision"]["compute"]]
    return 5.0 * b * resnet_bn_elements(cfg) * batch["labels"].shape[0]


def bert_attention_work(cfg: dict, batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, float]:
    """The self-attention layers of a step (projections, scores, weighted
    sum, output projection), over each row's valid positions:
    ``{"flops", "bytes"}``.

    Operations: per valid token and layer ``2·4H²`` forward for the four
    projections, per row of length ``n`` ``4·n²·H`` for the scores and
    the weighted sum; backward twice the forward. Bytes per layer: the
    input (float32, the LayerNorm's output) read forward and backward,
    the output written and its gradient read in the compute dtype, the
    input's gradient written in float32, the four kernels and biases
    (float32) read forward and backward and their gradients written."""
    H, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    c = DTYPE_BYTES[cfg["precision"]["compute"]]
    p = DTYPE_BYTES[cfg["precision"]["params"]]
    lengths = batch["attention_mask"].float().sum(1).double()
    tokens = float(lengths.sum())
    squares = float((lengths * lengths).sum())
    flops = 3.0 * L * (8.0 * tokens * H * H + 4.0 * squares * H)
    weights = 4 * (H * H + H) * p
    per_layer = tokens * H * (p + p + c + c + p) + 3 * weights
    return {"flops": flops, "bytes": L * per_layer}
