"""FusedLayerNorm module (counterpart of
:class:`apex_tpu.normalization.FusedLayerNorm`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 ``scale``/``bias`` params
    (the JAX module's param names, so weights load by name).

    Where a gradient may be taken, the forward is
    :func:`fused_layer_norm_affine`, whose backward is kernel B1. Without
    autograd the serving forward is ``F.layer_norm`` (one kernel where the
    written-out ``layer_norm_reference`` issues ten), in fp32 for fp32
    inputs as the JAX primal computes it; a low-precision input with fp32
    params (amp O2) takes the fp32 formula of the training forward."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(normalized_shape,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             device=device))

    def forward(self, x):
        if torch.is_grad_enabled() or x.dtype != self.scale.dtype:
            return fused_layer_norm_affine(x, self.scale, self.bias,
                                           self.eps)
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias,
                            self.eps)
