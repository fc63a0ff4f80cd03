"""DeepSeek-V2-Lite as the program trains it, one card's share (see the
configuration file's ``deployment``): the port's ``DeepseekV2`` under its
``make_deepseek_train_step``, the port's ``deepseek.adamw``, bfloat16
compute over float32 parameters. See ``resnet50.py`` for what a
configuration module provides.

The routed experts' work depends on the routing, and the routing moves as
the router trains, so the operations and bytes of a step read the
program's own counter of the (token, slot) pairs each held expert
computed (``DeepseekV2.routed_pairs``), averaged on the card over the
steps it counted: ``flops`` over every step before it is read (the
checked steps, the warm-up and the window), ``work`` over the traced
steps alone (``ranges``, called just before them, starts the average
afresh). The model ``build`` made is kept (weakly) for that.
"""

import weakref

from perfbench.reference import deepseek_v2 as reference  # noqa: F401

BYTES = {"bfloat16": 2, "float32": 4}
FLASH_KERNEL = "flash_fwd_kernel_bf16<192, 128"   # the MLA instance's name
_program = {"model": None}


def init(shape, role, cfg):
    if role in ("embedding", "dense"):
        return "normal", cfg["init"]["std"]
    return "fill", cfg["init"]["norm"]


def _program_config(cfg):
    """The port's ``DeepseekV2Config`` of a configuration file."""
    import torch

    from horovod_tpu_torch.models import deepseek
    rs = cfg["rope_scaling"]
    return deepseek.DeepseekV2Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        num_attention_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_routed_experts=cfg["router_experts"],
        n_shared_experts=cfg["n_shared_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        routed_scaling_factor=cfg["routed_scaling_factor"],
        first_expert=cfg["first_expert"],
        held_experts=cfg["n_routed_experts"],
        aux_loss_alpha=cfg["aux_loss_alpha"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        rope_factor=rs["factor"],
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=rs["beta_fast"], rope_beta_slow=rs["beta_slow"],
        rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"],
        dtype=getattr(torch, cfg["precision"]["compute"]))


def build(cfg, mesh, device):
    from horovod_tpu_torch.models import deepseek
    model = deepseek.DeepseekV2(_program_config(cfg), device=device,
                                mesh=mesh)
    optimizer = deepseek.adamw(model.parameters(), cfg["optimizer"]["lr"])
    step = deepseek.make_deepseek_train_step(model, mesh)
    _program["model"] = weakref.ref(model)

    def call(model, optimizer, local):
        return step(model, optimizer, local)[2]

    def local(batch):
        return deepseek.shard_batch({"input_ids": batch["input_ids"],
                                     "labels": batch["mlm_labels"],
                                     "loss_mask": batch["mlm_mask"]}, mesh)

    return model, optimizer, call, local


def routed_pairs() -> float:
    """The (token, slot) pairs the held experts of every MoE layer computed
    a step, averaged over the steps the program's counter holds."""
    model = _program["model"]() if _program["model"] is not None else None
    if model is None:
        raise RuntimeError("no program model alive to read its routed "
                           "pairs from")
    return float(model.routed_pairs().sum())


def _moe_layers(cfg):
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def _causal_pairs(S):
    return S * (S + 1) // 2


def step_flops(cfg, rows, S, pairs):
    """Operations of one step over ``rows`` rows of ``S`` tokens with
    ``pairs`` routed (token, slot) pairs summed over the MoE layers: three
    forward passes of the products (projections, attention's scores and
    weighted sum over the causal pairs, the dense, shared, routed and
    router products, the head on every position)."""
    M, H, R = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    L, Lm, F = cfg["num_hidden_layers"], _moe_layers(cfg), \
        cfg["moe_intermediate_size"]
    T = rows * S
    proj = M * H * (dn + dr) + M * (R + dr) + R * H * (dn + dv) + H * dv * M
    macs = L * (T * proj + rows * _causal_pairs(S) * H * (dn + dr + dv))
    macs += (L - Lm) * T * 3 * M * cfg["intermediate_size"]
    macs += Lm * T * (3 * M * F * cfg["n_shared_experts"]
                      + M * cfg["router_experts"])
    macs += pairs * 3 * M * F
    macs += T * M * cfg["vocab_size"]
    return 3.0 * 2.0 * macs


def flops(cfg, batch):
    rows, S = batch["input_ids"].shape
    return step_flops(cfg, rows, S, routed_pairs())


def layer_work(cfg, rows, S, pairs):
    """The MLA flash forward's and the MoE layers' operations and bytes a
    step (the numerators of their roofline shares)."""
    H = cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv, M, F = cfg["v_head_dim"], cfg["hidden_size"], \
        cfg["moe_intermediate_size"]
    L, Lm, T = cfg["num_hidden_layers"], _moe_layers(cfg), rows * S
    c = BYTES[cfg["precision"]["compute"]]
    p = BYTES[cfg["precision"]["params"]]
    flash_flops = L * 2.0 * (dq + dv) * rows * _causal_pairs(S) * H
    # q and k read, v read, o written, in the compute dtype; lse in fp32
    flash_bytes = L * T * H * ((2 * dq + 2 * dv) * c + 4)
    shared = T * 3 * M * F * cfg["n_shared_experts"]
    moe_flops = 3.0 * 2.0 * (Lm * shared + pairs * 3 * M * F)
    # forward: x read, y written, the weights read; backward: dy and x
    # read, dx written, the weights read and their fp32 gradients written
    weights = 3 * M * F * (cfg["n_shared_experts"] + cfg["n_routed_experts"])
    moe_bytes = Lm * (5.0 * T * M * c + weights * (2 * c + p))
    return {"mla_flash_flops": flash_flops, "mla_flash_bytes": flash_bytes,
            "moe_flops": moe_flops, "moe_bytes": moe_bytes}


def work(cfg, batch):
    rows, S = batch["input_ids"].shape
    return layer_work(cfg, rows, S, routed_pairs())


def ranges(model):
    from horovod_tpu_torch.models.deepseek import DeepseekMoE, MLAttention
    _program["model"] = weakref.ref(model)
    model.reset_routed_pairs()
    return {"mla": [m for m in model.modules() if isinstance(m, MLAttention)],
            "moe": [m for m in model.modules() if isinstance(m, DeepseekMoE)]}
