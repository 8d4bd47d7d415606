"""LayerNorm / RMSNorm forward (counterpart of the references in
:mod:`apex_tpu.ops.layer_norm`).

Plain PyTorch on purpose: the JAX serving path runs the jnp primal of
``fused_layer_norm_affine``, not a Pallas kernel, so this slice has no
norm kernel to port. The Pallas forward/backward (B2, B1) belong to the
training path.
"""

from __future__ import annotations

import torch


def layer_norm_reference(x, weight, bias, eps=1e-5):
    """fp32 two-pass moments, affine in fp32, output in ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def rms_norm_reference(x, weight, eps=1e-5):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * weight.float()
    return y.to(x.dtype)
