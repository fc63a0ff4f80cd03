"""BERT-Large as the program trains it: the port's ``Bert`` under its
``make_bert_train_step``, the port's ``bert.adamw``, bfloat16 compute over
float32 parameters. See ``resnet50.py`` for what a configuration module
provides."""

import torch

from perfbench import bytes as nbytes
from perfbench import flops as nflops
from perfbench.reference import bert as reference  # noqa: F401


def init(shape, role, cfg):
    if role in ("embedding", "dense"):
        return "normal", cfg["initializer_range"]
    return "fill", cfg["init"][role]


def build(cfg, mesh, device):
    from horovod_tpu_torch.models import bert
    bcfg = bert.BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        dtype=getattr(torch, cfg["precision"]["compute"]))
    model = bert.Bert(bcfg, device=device, mesh=mesh)
    opt = cfg["optimizer"]
    optimizer = bert.adamw(model.parameters(), opt["lr"])
    step = bert.make_bert_train_step(model, mesh)

    def call(model, optimizer, local):
        return step(model, optimizer, local)[2]

    def local(batch):
        return bert.shard_batch(batch, mesh)

    return model, optimizer, call, local


def flops(cfg, batch):
    return nflops.bert_step(cfg, batch)


def work(cfg, batch):
    w = nbytes.bert_attention_work(cfg, batch)
    return {"attention_flops": w["flops"], "attention_bytes": w["bytes"]}


def ranges(model):
    from horovod_tpu_torch.models.bert import SelfAttention
    return {"attention": [m for m in model.modules()
                          if isinstance(m, SelfAttention)]}
