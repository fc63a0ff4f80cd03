from horovod_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    adamw,
    data_sharding_spec,
    decode_step_paged,
    flatten_decode_params,
    forward_loss_spmd,
    from_jax_params,
    init_opt_state,
    init_params,
    kv_cache_spec,
    lm_loss,
    make_forward,
    make_grad_fn,
    make_train_step,
    param_shardings,
    prefill_chunk_paged,
    reference_greedy_decode,
    shard_batch,
    shard_params,
    shard_state_dict,
)

# DeepSeek-V2 (MLA and DeepSeekMoE; no JAX counterpart)
from horovod_tpu_torch.models.deepseek import (  # noqa: F401,E402
    DeepseekMoE,
    DeepseekV2,
    DeepseekV2Config,
    MLAttention,
    SwiGLU,
    make_deepseek_train_step,
)

# CNN zoo (the reference's published benchmark models) + BERT, imported
# lazily by path, as in the JAX package: every entry is a
# "module:constructor" returning a model (or BERT's config) when called
# with no arguments (the CNNs on this process's card); resolve with
# ``get_model(name)``, keywords passed through (``device="cpu"``).
MODEL_ZOO = {
    "resnet50": "horovod_tpu_torch.models.resnet:ResNet50",
    "resnet101": "horovod_tpu_torch.models.resnet:ResNet101",
    "vgg16": "horovod_tpu_torch.models.vgg:VGG16",
    "inception3": "horovod_tpu_torch.models.inception:InceptionV3",
    "bert_large": "horovod_tpu_torch.models.bert:bert_large",
    "bert_base": "horovod_tpu_torch.models.bert:bert_base",
}


def get_model(name: str, **kwargs):
    """Resolve a MODEL_ZOO entry to its constructed model/config."""
    import importlib
    try:
        module, attr = MODEL_ZOO[name].split(":")
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: "
                       f"{sorted(MODEL_ZOO)}") from None
    return getattr(importlib.import_module(module), attr)(**kwargs)
