"""Fused optimizers (counterpart of :mod:`apex_tpu.optimizers`): FusedLAMB
so far."""

from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedLAMB", "FusedOptimizer"]
