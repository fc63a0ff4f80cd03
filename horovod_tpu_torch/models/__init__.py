from horovod_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    adamw,
    from_jax_params,
    init_opt_state,
    init_params,
    lm_loss,
    make_forward,
    make_grad_fn,
    make_train_step,
)
