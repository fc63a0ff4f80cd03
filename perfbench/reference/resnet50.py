"""ResNet-50 in plain PyTorch, written from He et al., "Deep Residual
Learning for Image Recognition" (arXiv:1512.03385, Table 1, the 50-layer
column) in its v1.5 form (torchvision's ``resnet50``: the stride of a
downsampling bottleneck on its 3x3 convolution).

The network is a set of functions over a dict of named tensors, so the
same weights can be handed to it and to the program under test. Names
follow the configuration's convention (``Conv_0.kernel``,
``BottleneckBlock_<i>.BatchNorm_<j>.scale``, ``Dense_0.kernel``);
kernels are ``[out, in, kh, kw]`` and ``[out, in]``.

Departures from the published description, each stated by the
configuration file:

* ``padding`` "SAME": a strided 3x3 convolution on an even input pads
  one pixel at the end only (0, 1), as Flax's ImageNet example does;
  torchvision pads (1, 1). Output shapes and operation counts are the
  same.
* ``bn_running_var`` "biased": the running variance averages the biased
  batch variance (Flax's ``BatchNorm``); torchvision averages the
  unbiased one. ``bn_momentum`` is the running averages' decay.
* Batch normalization always uses the statistics of the whole batch it
  is given (training mode); the benchmark never evaluates.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.common import operand, result

Tensors = Dict[str, torch.Tensor]


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """"SAME" padding of one spatial dim: the output is ``ceil(size /
    stride)``; the odd pixel of the padding goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def blocks(cfg: dict) -> List[dict]:
    """Every bottleneck block: its input width, filters and stride."""
    out, width = [], cfg["stem_width"]
    for stage, n in enumerate(cfg["stage_sizes"]):
        filters = cfg["stem_width"] * 2 ** stage
        for j in range(n):
            stride = 2 if stage > 0 and j == 0 else 1
            out.append({"in": width, "filters": filters, "stride": stride,
                        "proj": width != filters * cfg["expansion"]
                        or stride != 1})
            width = filters * cfg["expansion"]
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every trainable tensor: ``name -> (shape, role)``, in a fixed
    order. Roles: ``conv``, ``dense``, ``bias``, ``bn_scale``,
    ``bn_bias``."""
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def bn(prefix, c):
        shapes[f"{prefix}.scale"] = ((c,), "bn_scale")
        shapes[f"{prefix}.bias"] = ((c,), "bn_bias")

    k = cfg["stem_kernel"]
    shapes["Conv_0.kernel"] = ((cfg["stem_width"], cfg["channels"], k, k),
                               "conv")
    bn("BatchNorm_0", cfg["stem_width"])
    e = cfg["expansion"]
    for i, b in enumerate(blocks(cfg)):
        p, f = f"BottleneckBlock_{i}", b["filters"]
        convs = [(b["in"], f, 1), (f, f, 3), (f, f * e, 1)]
        if b["proj"]:
            convs.append((b["in"], f * e, 1))
        for j, (ci, co, kk) in enumerate(convs):
            shapes[f"{p}.Conv_{j}.kernel"] = ((co, ci, kk, kk), "conv")
            bn(f"{p}.BatchNorm_{j}", co)
    width = cfg["stem_width"] * 2 ** (len(cfg["stage_sizes"]) - 1) * e
    shapes["Dense_0.kernel"] = ((cfg["num_classes"], width), "dense")
    shapes["Dense_0.bias"] = ((cfg["num_classes"],), "bias")
    return shapes


def buffer_names(cfg: dict) -> List[str]:
    """The running statistics: ``<bn>.mean`` and ``<bn>.var``."""
    return [n.replace(".scale", s) for n, (_, role) in
            param_shapes(cfg).items() if role == "bn_scale"
            for s in (".mean", ".var")]


def init_buffers(cfg: dict, device) -> Tensors:
    """Running means 0 and variances 1."""
    out = {}
    for n in buffer_names(cfg):
        c = param_shapes(cfg)[n.rsplit(".", 1)[0] + ".scale"][0][0]
        fill = 0.0 if n.endswith(".mean") else 1.0
        out[n] = torch.full((c,), fill, device=device)
    return out


def _conv(x, w, stride, pads, mode):
    (t, b), (l, r) = pads
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b))
    return result(F.conv2d(operand(x, mode), operand(w, mode), None, stride),
                  mode)


def _same_conv(x, w, stride, mode):
    k = w.shape[-1]
    pads = tuple(same_pad(x.shape[2 + i], k, stride) for i in range(2))
    return _conv(x, w, stride, pads, mode)


def _bn(x, params, stats, prefix, cfg):
    """Batch norm over the batch and spatial dims; the running averages of
    ``prefix`` are replaced in ``stats``."""
    mean = x.mean((0, 2, 3))
    var = (x - mean[None, :, None, None]).square().mean((0, 2, 3))
    y = (x - mean[None, :, None, None]) \
        * torch.rsqrt(var + cfg["bn_epsilon"])[None, :, None, None] \
        * params[f"{prefix}.scale"][None, :, None, None] \
        + params[f"{prefix}.bias"][None, :, None, None]
    m = cfg["bn_momentum"]
    with torch.no_grad():
        stats[f"{prefix}.mean"] = m * stats[f"{prefix}.mean"] \
            + (1 - m) * mean
        stats[f"{prefix}.var"] = m * stats[f"{prefix}.var"] + (1 - m) * var
    return y


def forward(params: Tensors, stats: Tensors, images: torch.Tensor,
            cfg: dict, mode: str = "fp32") -> torch.Tensor:
    """Logits ``[B, classes]`` of ``images [B, C, H, W]`` with batch
    statistics; ``stats`` (the running averages) is updated in place."""
    pad = cfg["stem_kernel"] // 2
    x = _conv(images.float(), params["Conv_0.kernel"], cfg["stem_stride"],
              ((pad, pad), (pad, pad)), mode)
    x = F.relu(_bn(x, params, stats, "BatchNorm_0", cfg))
    x = F.max_pool2d(x, 3, 2, 1)
    for i, b in enumerate(blocks(cfg)):
        p = f"BottleneckBlock_{i}"
        y = _same_conv(x, params[f"{p}.Conv_0.kernel"], 1, mode)
        y = F.relu(_bn(y, params, stats, f"{p}.BatchNorm_0", cfg))
        y = _same_conv(y, params[f"{p}.Conv_1.kernel"], b["stride"], mode)
        y = F.relu(_bn(y, params, stats, f"{p}.BatchNorm_1", cfg))
        y = _same_conv(y, params[f"{p}.Conv_2.kernel"], 1, mode)
        y = _bn(y, params, stats, f"{p}.BatchNorm_2", cfg)
        if b["proj"]:
            r = _same_conv(x, params[f"{p}.Conv_3.kernel"], b["stride"],
                           mode)
            r = _bn(r, params, stats, f"{p}.BatchNorm_3", cfg)
        else:
            r = x
        x = F.relu(y + r)
    x = x.mean((2, 3))
    return result(F.linear(operand(x, mode), operand(
        params["Dense_0.kernel"], mode)), mode) + params["Dense_0.bias"]


def loss(params: Tensors, stats: Tensors, batch: dict, cfg: dict,
         mode: str = "fp32") -> torch.Tensor:
    """The mean softmax cross-entropy of the batch."""
    logits = forward(params, stats, batch["images"], cfg, mode)
    return F.cross_entropy(logits, batch["labels"].long())


def grads(params: Tensors, stats: Tensors, batch: dict, cfg: dict,
          mode: str = "fp32") -> Tuple[float, Tensors]:
    """``(loss, gradient of every parameter)`` over the whole batch (batch
    statistics couple its rows, so it is not split)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = loss(leaves, stats, batch, cfg, mode)
    g = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, g))
