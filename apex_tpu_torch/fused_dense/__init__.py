"""Fused dense layers (counterpart of :mod:`apex_tpu.fused_dense`)."""

from apex_tpu_torch.fused_dense.fused_dense import (
    DenseNoBias,
    FusedDense,
    FusedDenseGeluDense,
    load_jax_params,
)

__all__ = ["DenseNoBias", "FusedDense", "FusedDenseGeluDense",
           "load_jax_params"]
