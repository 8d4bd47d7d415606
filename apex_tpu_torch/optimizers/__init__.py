"""Fused optimizers (counterpart of :mod:`apex_tpu.optimizers`): FusedAdam,
FusedLAMB, FusedMixedPrecisionLamb, FusedSGD, FusedAdagrad and
FusedNovoGrad, each one ``multi_tensor_applier`` call a step."""

from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import (
    FusedLAMB,
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedAdagrad", "FusedAdam", "FusedLAMB",
           "FusedMixedPrecisionLamb", "FusedNovoGrad", "FusedOptimizer",
           "FusedSGD"]
