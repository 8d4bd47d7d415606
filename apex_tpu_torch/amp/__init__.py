"""Mixed precision: opt levels O0-O3, ``initialize`` and the dynamic loss
scaler (counterpart of :mod:`apex_tpu.amp`). O1's autocast lists are not
ported yet."""

from apex_tpu_torch.amp.frontend import (
    Properties,
    cast_model,
    initialize,
    opt_levels,
)
from apex_tpu_torch.amp.handle import AmpHandle
from apex_tpu_torch.amp.scaler import DynamicLossScaler, LossScaler, ScalerState

__all__ = [
    "AmpHandle",
    "DynamicLossScaler",
    "LossScaler",
    "Properties",
    "ScalerState",
    "cast_model",
    "initialize",
    "opt_levels",
]
