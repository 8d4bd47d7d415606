"""FusedLayerNorm / FusedRMSNorm modules (counterpart of
:mod:`apex_tpu.normalization.fused_layer_norm`).

Drop-in norm modules with the reference's knobs: ``normalized_shape`` (an
int or a tuple of trailing dims), ``eps``, ``elementwise_affine``,
``memory_efficient`` and ``param_dtype``; the ``MixedFused*`` variants pin
fp32 params under low-precision activations (amp O2). Params are named
``scale`` and ``bias``, as the flax modules name them, so a flax param
tree loads by name, and keep the full ``normalized_shape``.

Where a gradient may be taken, the forward is
:func:`~apex_tpu_torch.ops.layer_norm.fused_layer_norm_affine` (or the
RMS one): kernel B2 with kernel B1 as the backward. Without autograd, a LayerNorm whose input
matches its params' dtype keeps the serving forward ``F.layer_norm``
(one library kernel where the written-out ``layer_norm_reference``
issues ten); a low-precision input with fp32 params takes the fp32
reference formula.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)


def _norm_shape(normalized_shape) -> tuple:
    """Normalized-shape tuple (an int or a trailing-dims tuple; a multi-dim
    shape normalizes over ALL the trailing dims)."""
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(int(d) for d in normalized_shape)


def _check_trailing(x, shape):
    k = len(shape)
    if tuple(x.shape[-k:]) != shape:
        raise ValueError(
            f"normalized_shape {shape} does not match trailing dims "
            f"{tuple(x.shape[-k:])} of input shape {tuple(x.shape)}")


def _flatten_trailing(x, shape):
    """Collapse the trailing ``len(shape)`` dims into one (the kernels
    normalize over the last dim; a multi-dim ``normalized_shape`` is the
    same computation on the flattened view)."""
    if len(shape) == 1:
        return x
    n = 1
    for d in shape:
        n *= d
    return x.reshape(*x.shape[:-len(shape)], n)


class _FusedNorm(nn.Module):
    """The knobs and params shared by the two norms; ``_norm`` normalizes
    over the last dim of the flattened input."""

    has_bias = True

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = True,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        if elementwise_affine:
            self.scale = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
        else:
            self.register_parameter("scale", None)
        if elementwise_affine and self.has_bias:
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=device))
        elif self.has_bias:
            self.register_parameter("bias", None)

    def forward(self, x):
        _check_trailing(x, self.normalized_shape)
        x2 = _flatten_trailing(x, self.normalized_shape)
        y = self._norm(x2, x2.shape[-1])
        return y if y.shape == x.shape else y.reshape(x.shape)


class FusedLayerNorm(_FusedNorm):
    """Reference: ``apex.normalization.FusedLayerNorm``. Params live on
    ``device``: the CUDA card unless the caller asks for another."""

    def _norm(self, x2, h):
        if not self.elementwise_affine:
            return fused_layer_norm(x2, h, self.eps)
        w, b = self.scale.reshape(h), self.bias.reshape(h)
        if torch.is_grad_enabled() or x2.dtype != w.dtype:
            return fused_layer_norm_affine(x2, w, b, self.eps,
                                           self.memory_efficient)
        return F.layer_norm(x2, (h,), w, b, self.eps)


class FusedRMSNorm(_FusedNorm):
    """Reference: ``apex.normalization.FusedRMSNorm``; the knobs of
    :class:`FusedLayerNorm`, one ``scale`` param and no bias."""

    has_bias = False

    def _norm(self, x2, h):
        if not self.elementwise_affine:
            return fused_rms_norm(x2, h, self.eps)
        return fused_rms_norm_affine(x2, self.scale.reshape(h), self.eps,
                                     self.memory_efficient)


class MixedFusedLayerNorm(FusedLayerNorm):
    """fp32 params under low-precision activations (reference:
    ``MixedFusedLayerNorm``, the amp-O2 norm)."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = True, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, torch.float32, device)


class MixedFusedRMSNorm(FusedRMSNorm):
    """Reference: ``MixedFusedRMSNorm``."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = True, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, torch.float32, device)
