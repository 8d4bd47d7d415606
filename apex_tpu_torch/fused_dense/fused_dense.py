"""Fused dense layers (counterpart of :mod:`apex_tpu.fused_dense.fused_dense`):
``FusedDense``, ``DenseNoBias`` and ``FusedDenseGeluDense``.

The product runs in x's dtype and gives an fp32 output (the JAX package's
``preferred_element_type=float32``), to which the fp32 bias is added
before the cast back to x's dtype. On the card, 16-bit products are one
cuBLAS call with an fp32 output (``aten::mm.dtype``); elsewhere the
product of the fp32 values of the same inputs, which is the same exact
products summed in fp32. Under amp O1 the product's inputs are cast to
the compute dtype (:func:`matmul_fp32_out` is whitelisted) and its output
stays fp32: it does not go through ``F.linear``, whose patched output
would be rounded to bf16.

The weights are ``(out_features, in_features)``, as ``nn.Linear``'s; the
flax kernel is their transpose (:func:`load_jax_params`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._common import resolve_device

# flax's lecun_normal: a normal truncated at 2 standard deviations,
# rescaled by the truncated distribution's standard deviation
_TRUNC_STD = 0.87962566103423978


class _MmFp32Out(torch.autograd.Function):
    """cuBLAS's 16-bit product with an fp32 output (``aten::mm.dtype``,
    which has no derivative of its own). The backward is the CPU route's:
    fp32 products with the fp32 gradient, rounded to the inputs' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.ops.aten.mm.dtype(a, b, torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().t() @ g).to(b.dtype)
        return ga, gb


def matmul_fp32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two tensors of one dtype with an fp32 output: exact
    products summed in fp32."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        out = _MmFp32Out.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _dense(x, weight, bias):
    """The module's forward: the fp32-output product, the fp32 bias, the
    cast back to x's dtype. The amp patch reaches ``matmul_fp32_out``
    through this module's globals."""
    y = matmul_fp32_out(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class FusedDense(nn.Module):
    """Linear + bias with an fp32-summed product (``apex.fused_dense.
    FusedDense``). Weights drawn from ``generator`` (flax's lecun_normal;
    bias 0) on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, params_dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        w = torch.empty(out_features, in_features, dtype=params_dtype)
        self.weight = nn.Parameter(
            _lecun_normal_(w, in_features, generator).to(dev))
        self.bias = (nn.Parameter(torch.zeros(out_features,
                                              dtype=params_dtype,
                                              device=dev))
                     if bias else None)

    def forward(self, x):
        return _dense(x, self.weight, self.bias)


class DenseNoBias(FusedDense):
    """The product alone (``apex.fused_dense.DenseNoBias``)."""

    def __init__(self, in_features: int, out_features: int,
                 params_dtype=torch.float32, device=None, generator=None):
        super().__init__(in_features, out_features, bias=False,
                         params_dtype=params_dtype, device=device,
                         generator=generator)


class FusedDenseGeluDense(nn.Module):
    """Linear + bias, GELU (tanh form, flax's default), Linear + bias
    (``apex.fused_dense.FusedDenseGeluDense``)."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, params_dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.dense1 = FusedDense(in_features, intermediate_features,
                                 params_dtype=params_dtype, device=device,
                                 generator=generator)
        self.dense2 = FusedDense(intermediate_features, out_features,
                                 params_dtype=params_dtype, device=device,
                                 generator=generator)

    def forward(self, x):
        return self.dense2(F.gelu(self.dense1(x), approximate="tanh"))


def load_jax_params(module: nn.Module, params_np) -> nn.Module:
    """Copy a flax param tree (numpy arrays) into a ``FusedDense``,
    ``DenseNoBias`` or ``FusedDenseGeluDense``, in place: ``kernel`` (in,
    out) into ``weight`` (out, in), ``bias`` as it is; the
    ``FusedDenseGeluDense`` tree holds ``dense1`` and ``dense2``. Every
    parameter must be covered."""
    tree = params_np.get("params", params_np)
    if isinstance(module, FusedDenseGeluDense):
        for name in ("dense1", "dense2"):
            if name not in tree:
                raise KeyError(f"load_jax_params: the tree lacks {name}")
            load_jax_params(getattr(module, name), tree[name])
        return module
    want = {"kernel"} | ({"bias"} if module.bias is not None else set())
    if set(tree) != want:
        raise KeyError(f"load_jax_params: {type(module).__name__} takes "
                       f"{sorted(want)}, the tree holds {sorted(tree)}")
    with torch.no_grad():
        kernel = torch.tensor(tree["kernel"]).t()
        if tuple(kernel.shape) != tuple(module.weight.shape):
            raise ValueError(f"load_jax_params: weight is "
                             f"{tuple(module.weight.shape)}, the kernel "
                             f"transposed {tuple(kernel.shape)}")
        module.weight.copy_(kernel)
        if module.bias is not None:
            module.bias.copy_(torch.tensor(tree["bias"]))
    return module
