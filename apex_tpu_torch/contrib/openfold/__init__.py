"""OpenFold kernel tier (counterpart of :mod:`apex_tpu.contrib.openfold`):
the Evoformer's small-trailing-dim LayerNorm, bias + mask softmax and
gated attention, on kernels B2/B1 and B6/B8, and ``FusedAdamSWA``."""

from apex_tpu_torch.contrib.openfold.fused_adam_swa import (
    FusedAdamSWA,
    SWAState,
)
from apex_tpu_torch.contrib.openfold.kernels import (
    LayerNormSmallShapeOptImpl,
    gated_attention,
    layer_norm,
    softmax,
)

__all__ = [
    "FusedAdamSWA",
    "SWAState",
    "LayerNormSmallShapeOptImpl",
    "gated_attention",
    "layer_norm",
    "softmax",
]
