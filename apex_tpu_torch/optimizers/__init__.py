"""Fused optimizers (counterpart of :mod:`apex_tpu.optimizers`): FusedAdam
and FusedLAMB."""

from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedAdam", "FusedLAMB", "FusedOptimizer"]
