"""FusedLayerNorm module, serving forward only (counterpart of
:class:`apex_tpu.normalization.FusedLayerNorm`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 ``scale``/``bias`` params
    (the JAX module's param names, so weights load by name). The forward
    is ``F.layer_norm`` (one kernel where the written-out
    ``layer_norm_reference`` issues ten), in fp32 for fp32 inputs as the
    JAX primal computes it."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(normalized_shape,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias,
                            self.eps)
