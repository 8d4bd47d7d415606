"""MLP (counterpart of :mod:`apex_tpu.mlp.mlp`): a chain of
:class:`~apex_tpu_torch.fused_dense.FusedDense` layers with an activation
after every layer but the last.

``mlp_sizes[0]`` is the input width and each later entry a layer's
output width (``apex.mlp.MLP(mlp_sizes, bias, activation)``); the
activations are the JAX package's table (``gelu`` is its tanh form).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.fused_dense import FusedDense
from apex_tpu_torch.fused_dense import load_jax_params as _load_dense

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


class MLP(nn.Module):
    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", params_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise ValueError("mlp_sizes needs an input size and >=1 layer")
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(_ACTIVATIONS)}, "
                f"got {activation!r}")
        self.mlp_sizes = tuple(mlp_sizes)
        self.activation = activation
        self.layers = nn.ModuleList(
            FusedDense(n_in, n_out, bias=bias, params_dtype=params_dtype,
                       device=device, generator=generator)
            for n_in, n_out in zip(mlp_sizes[:-1], mlp_sizes[1:]))

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = act(x)
        return x


def load_jax_params(module: MLP, params_np) -> MLP:
    """Copy a flax ``MLP`` param tree (``layer_{i}/{kernel, bias}``, numpy
    arrays) into the port's ``MLP`` in place. Every layer must be
    covered."""
    tree = params_np.get("params", params_np)
    want = {f"layer_{i}" for i in range(len(module.layers))}
    if set(tree) != want:
        raise KeyError(f"load_jax_params: the MLP takes {sorted(want)}, "
                       f"the tree holds {sorted(tree)}")
    for i, layer in enumerate(module.layers):
        _load_dense(layer, tree[f"layer_{i}"])
    return module
