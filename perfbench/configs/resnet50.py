"""ResNet-50 as the program trains it: the port's ``ResNet`` under its
``make_resnet_train_step`` (``models/_flax.make_classifier_step``), SGD
with momentum, bfloat16 compute over float32 parameters.

What the harness asks of a configuration module: ``reference`` (the plain
model), ``init`` (the benchmark's initializer by role), ``build`` (the
program's model, optimizer and step over the mesh), ``flops`` and
``work`` (the yardstick's counts), ``ranges`` (the modules whose device
time a traced run books to a layer).
"""

import math

import torch

from perfbench import bytes as nbytes
from perfbench import flops as nflops
from perfbench.reference import resnet50 as reference  # noqa: F401


def init(shape, role, cfg):
    if role == "conv":
        return "normal", math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if role == "dense":
        return "normal", 1.0 / math.sqrt(3.0 * shape[1])
    return "fill", cfg["init"][role]


def build(cfg, mesh, device):
    """``(model, optimizer, call, local)``: ``call(model, optimizer,
    local_batch) -> loss`` is the step a user of the port calls;
    ``local(global_batch)`` this rank's rows, as the port shards them."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    torch.backends.cudnn.benchmark = bool(cfg["cudnn_benchmark"])
    model = resnet.ResNet(cfg["stage_sizes"], cfg["num_classes"],
                          getattr(torch, cfg["precision"]["compute"]), "conv",
                          device=device, mesh=mesh)
    opt = cfg["optimizer"]
    optimizer = torch.optim.SGD(model.parameters(), lr=opt["lr"],
                                momentum=opt["momentum"])
    step = resnet.make_resnet_train_step(model, mesh)

    def call(model, optimizer, local):
        return step(model, optimizer, *local)[2]

    def local(batch):
        return hvd.shard_batch(batch["images"], batch["labels"], mesh)

    return model, optimizer, call, local


def flops(cfg, batch):
    return nflops.resnet_step(cfg, batch)


def work(cfg, batch):
    return {"bn_bytes": nbytes.resnet_bn_bytes(cfg, batch)}


def ranges(model):
    from horovod_tpu_torch.models._flax import BatchNorm
    return {"bn": [m for m in model.modules() if isinstance(m, BatchNorm)]}
