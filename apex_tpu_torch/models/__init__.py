from apex_tpu_torch.models.gpt import (
    WEIGHT_QUANT_MODES,
    GPTConfig,
    GPTLMHeadModel,
    GPTModel,
    QuantLinear,
    gpt_param_bytes,
    load_jax_params,
    quantize_dense_kernel,
    quantize_gpt_model,
    quantize_gpt_params,
)

__all__ = [
    "GPTConfig",
    "GPTLMHeadModel",
    "GPTModel",
    "QuantLinear",
    "WEIGHT_QUANT_MODES",
    "gpt_param_bytes",
    "load_jax_params",
    "quantize_dense_kernel",
    "quantize_gpt_model",
    "quantize_gpt_params",
]
