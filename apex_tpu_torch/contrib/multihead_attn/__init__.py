"""Contrib multihead_attn (counterpart of
:mod:`apex_tpu.contrib.multihead_attn`)."""

from apex_tpu_torch.contrib.multihead_attn.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    load_jax_params,
)

__all__ = ["EncdecMultiheadAttn", "SelfMultiheadAttn", "load_jax_params"]
