"""Legacy fp16 helpers (counterpart of :mod:`apex_tpu.fp16_utils.fp16util`).

``network_to_half`` casts a model, ``prep_param_lists`` pairs the model's
params with fp32 master copies (optionally one flat buffer),
``master_params_to_model_params`` and ``model_grads_to_master_grads`` copy
between the two around an fp32 optimizer step. They take an
``nn.Module`` or lists of tensors. The half dtype defaults to bfloat16,
as in the JAX package; pass ``torch.float16`` for the reference's.
"""

from __future__ import annotations

import torch
from torch import nn


def _tensors(model_or_params):
    if isinstance(model_or_params, nn.Module):
        return list(model_or_params.parameters())
    return list(model_or_params)


def network_to_half(model_or_params, half_dtype=torch.bfloat16):
    """Every floating parameter and buffer cast to ``half_dtype``: a module
    in place (returned), a list of tensors into a new list."""
    if isinstance(model_or_params, nn.Module):
        with torch.no_grad():
            for t in list(model_or_params.parameters()) + list(
                    model_or_params.buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(half_dtype)
        return model_or_params
    return [t.to(half_dtype) if t.is_floating_point() else t
            for t in model_or_params]


def prep_param_lists(model_or_params, flat_master: bool = False):
    """``(model_params, master_params)``: the model's params, and fp32
    copies of them that take gradients, or with ``flat_master`` one flat
    fp32 parameter of all of them in order."""
    params = _tensors(model_or_params)
    with torch.no_grad():
        if flat_master:
            flat = torch.cat([p.detach().float().reshape(-1)
                              for p in params])
            return params, [nn.Parameter(flat)]
        return params, [nn.Parameter(p.detach().float().clone())
                        for p in params]


def master_params_to_model_params(model_params, master_params,
                                  flat_master: bool = False):
    """Copy the masters' values into the model's params, cast to their
    dtypes, in place; returns the model's params."""
    model_params = _tensors(model_params)
    masters = list(master_params)
    with torch.no_grad():
        if flat_master:
            sizes = [p.numel() for p in model_params]
            masters = [m.view_as(p) for m, p in zip(
                masters[0].split(sizes), model_params)]
        for p, m in zip(model_params, masters):
            p.copy_(m)
    return model_params


def model_grads_to_master_grads(model_grads, flat_master: bool = False):
    """The model's gradients (a list, or a module's params' ``.grad``) as
    fp32 master gradients: new tensors, or one flat fp32 vector."""
    if isinstance(model_grads, nn.Module):
        model_grads = [p.grad for p in model_grads.parameters()]
    if flat_master:
        return torch.cat([g.float().reshape(-1) for g in model_grads])
    return [g.to(torch.float32, copy=True) for g in model_grads]


def to_python_float(t) -> float:
    """A one-element tensor (or a number) as a host float."""
    return float(t.item()) if isinstance(t, torch.Tensor) else float(t)
