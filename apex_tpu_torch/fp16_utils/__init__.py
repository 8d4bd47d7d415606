"""The legacy fp16 surface (counterpart of :mod:`apex_tpu.fp16_utils`)."""

from apex_tpu_torch.amp.scaler import DynamicLossScaler, LossScaler
from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.fp16_utils.fp16util import (
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
)

__all__ = [
    "DynamicLossScaler",
    "FP16_Optimizer",
    "LossScaler",
    "master_params_to_model_params",
    "model_grads_to_master_grads",
    "network_to_half",
    "prep_param_lists",
    "to_python_float",
]
