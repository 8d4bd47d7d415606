from apex_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    BertModel,
    pretraining_loss,
)
from apex_tpu_torch.models.bert import load_jax_params as load_bert_jax_params
from apex_tpu_torch.models.gpt import (
    WEIGHT_QUANT_MODES,
    GPTConfig,
    GPTLMHeadModel,
    GPTModel,
    QuantLinear,
    gpt_param_bytes,
    lm_loss,
    load_jax_params,
    quantize_dense_kernel,
    quantize_gpt_model,
    quantize_gpt_params,
)
from apex_tpu_torch.models.resnet import ResNet, ResNetConfig
from apex_tpu_torch.models.resnet import (
    load_jax_params as load_resnet_jax_params,
)

__all__ = [
    "BertConfig",
    "BertForPreTraining",
    "BertModel",
    "GPTConfig",
    "GPTLMHeadModel",
    "GPTModel",
    "QuantLinear",
    "ResNet",
    "ResNetConfig",
    "WEIGHT_QUANT_MODES",
    "gpt_param_bytes",
    "load_bert_jax_params",
    "lm_loss",
    "load_jax_params",
    "load_resnet_jax_params",
    "pretraining_loss",
    "quantize_dense_kernel",
    "quantize_gpt_model",
    "quantize_gpt_params",
]
