"""OpenFold Evoformer ops (counterpart of
:mod:`apex_tpu.contrib.openfold.kernels`).

The Evoformer's hot ops at its shapes: many short rows (the pair
representation ``(B, N, N, c_z)`` with c_z 128, the MSA ``(B, s, N, c_m)``
with c_m 256) and a bias + mask softmax over 5-D attention scores.

- :func:`layer_norm` / ``LayerNormSmallShapeOptImpl``: the trailing-dim
  LayerNorm on :func:`~apex_tpu_torch.ops.layer_norm.fused_layer_norm_affine`
  (kernels B2 and B1, a warp per row at these widths).
- :func:`softmax`: ``softmax(scale * x + bias)`` with a boolean padding
  mask, on the fused softmax of :mod:`apex_tpu_torch.ops.softmax`. With a
  bias the scale is applied first and the kernel's scale is 1, so a
  boolean mask is pre-folded into the scores and the 5-D scores take
  kernel B6 (no mask tensor) and B8 backward, the JAX package's route.
- :func:`gated_attention`: ``sigmoid(gate) * softmax(scale * q k^T +
  bias, mask) v``; its two products are ``torch.matmul``, as they are
  plain products outside any kernel in the JAX package.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.normalization.fused_layer_norm import (
    _check_trailing,
    _flatten_trailing,
    _norm_shape,
)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
from apex_tpu_torch.ops.softmax import scaled_masked_softmax


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """Trailing-dim LayerNorm at OpenFold shapes: any leading shape;
    ``weight`` and ``bias`` are 1-D of the trailing dim."""
    return fused_layer_norm_affine(x, weight, bias, eps)


class LayerNormSmallShapeOptImpl:
    """The reference's small-shape LayerNorm entry point
    (``LayerNormSmallShapeOptImpl.apply``). A multi-dim
    ``normalized_shape`` normalizes over the flattened trailing dims; the
    trailing dims must be ``normalized_shape`` or it raises."""

    @staticmethod
    def apply(x, normalized_shape, weight, bias, eps: float = 1e-5):
        shape = _norm_shape(normalized_shape)
        _check_trailing(x, shape)
        x2 = _flatten_trailing(x, shape)
        n = x2.shape[-1]
        return fused_layer_norm_affine(x2, weight.reshape(n),
                                       bias.reshape(n), eps).reshape(x.shape)


def softmax(x, mask=None, bias=None, scale: float = 1.0):
    """``softmax(scale * x + bias)`` over the last dim with an optional
    boolean padding mask (True = masked) or additive float mask, each
    broadcastable to ``x``: the Evoformer score softmax, whose ``bias``
    is the pair-bias term ``(B, 1, H, N, N)`` added to ``(B, s, H, N, N)``
    scores."""
    if bias is not None:
        x = x * scale + bias.to(x.dtype)
        scale = 1.0
    return scaled_masked_softmax(x, mask, scale)


def gated_attention(q, k, v, gate, bias=None, mask=None, scale: float = 1.0):
    """Evoformer gated attention core: ``sigmoid(gate) * softmax(scale *
    q @ k^T + bias, mask) @ v``. q/k/v/gate ``(..., H, S, D)``; ``bias``
    and the boolean ``mask`` (True = masked) broadcast to the
    ``(..., H, S, S)`` scores."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    probs = softmax(scores, mask=mask, bias=bias, scale=scale)
    ctx = torch.matmul(probs.to(v.dtype), v)
    return torch.sigmoid(gate.to(ctx.dtype)) * ctx
