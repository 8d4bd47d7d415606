"""Shared machinery of the fused optimizers (counterpart of
:mod:`apex_tpu.optimizers._base`): the ``step`` surface, fp32 master
weights for amp O2, the ``set_grad_none`` reset, the bf16-moment
settings and the overflow read.

``step(grads=...)`` takes the gradients as a list instead of reading
``p.grad`` (``build_train_step`` hands in its fp32 averages).
``step(grad_scale=s)`` takes gradients scaled by ``s``: it reads the
overflow flag off them (the step's one host sync) and on overflow changes
nothing, not even the step count, and returns True; otherwise the
subclass unscales them inside its own first read. Without ``grad_scale``
``step`` returns the closure's loss (or None).
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.ops._common import mix_seed
from apex_tpu_torch.ops.multi_tensor import all_finite

_MOMENTS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   torch.float32: torch.float32,
                   torch.bfloat16: torch.bfloat16}


class FusedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, defaults, master_weights=False,
                 set_grad_none=True):
        super().__init__(params, defaults)
        self.master_weights = master_weights
        self.set_grad_none = set_grad_none

    def set_master_weights(self, flag: bool = True):
        """Keep fp32 master copies of the params (set by
        ``amp.initialize`` for O2, before the first step)."""
        if any(self.state.values()):
            raise RuntimeError("master weights must be set before the "
                               "first step")
        self.master_weights = flag

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none=set_to_none and self.set_grad_none)

    def load_state_dict(self, state_dict):
        """torch casts floating state to its param's dtype on load; the
        fp32 masters and moments of 16-bit params keep their own."""
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        for i, saved in state_dict["state"].items():
            st = self.state[params[i]]
            for k, v in saved.items():
                if (isinstance(v, torch.Tensor) and v.is_floating_point()
                        and st[k].dtype != v.dtype):
                    st[k] = v.to(device=params[i].device, copy=True)

    # -- the step ---------------------------------------------------------

    @torch.no_grad()
    def step(self, closure=None, *, grad_scale=None, lr=None, grads=None):
        """One step over every param with a gradient. ``grads``, when
        given, replaces the params' ``.grad``: one tensor (or None) per
        param of ``param_groups`` in order, in any floating dtype (an fp32
        accumulator is read as it is, never rounded into a 16-bit
        ``.grad``). ``lr`` overrides every group's. Returns the overflow
        flag when ``grad_scale`` is given, else the closure's loss."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [p.grad for p in params]
        elif len(grads) != len(params):
            raise ValueError(f"{type(self).__name__}.step: {len(grads)} "
                             f"gradients for {len(params)} params")
        live = [g for g in grads if g is not None]
        if not live:
            return False if grad_scale is not None else loss
        overflow, scale = self._unscale(live, grad_scale)
        if overflow:
            return True
        start = 0
        for group in self.param_groups:
            n = len(group["params"])
            pairs = [(p, g) for p, g in zip(group["params"],
                                            grads[start:start + n])
                     if g is not None]
            start += n
            if pairs:
                self._group_step(group, pairs, scale, lr)
        return False if grad_scale is not None else loss

    def _unscale(self, live, grad_scale):
        """``(overflow, scale)``: the host-read overflow flag of the
        scaled gradients, and what ``_group_step`` unscales with (here the
        fp32 ``1 / grad_scale``)."""
        if grad_scale is None:
            return False, 1.0
        if not bool(all_finite(live)):
            return True, None
        return False, float(np.float32(1.0) / np.float32(grad_scale))

    def _group_step(self, group, pairs, scale, lr):
        raise NotImplementedError

    # -- helpers for subclasses -------------------------------------------

    def _masters(self, params):
        """The fp32 master of each param (made from it at the first
        step), or None without master weights."""
        if not self.master_weights:
            return None
        out = []
        for p in params:
            st = self.state[p]
            if "master" not in st:
                st["master"] = p.detach().float().clone()
            out.append(st["master"])
        return out

    def _state_list(self, params, key, dtype=torch.float32, scalar=False):
        """``state[p][key]`` of each param, zeros of ``dtype`` at first:
        of the param's shape, or one number a param with ``scalar``."""
        out = []
        for p in params:
            st = self.state[p]
            if key not in st:
                st[key] = (torch.zeros((), dtype=dtype, device=p.device)
                           if scalar else torch.zeros_like(p, dtype=dtype))
            out.append(st[key])
        return out

    def _sr_generator(self, step, device, seed):
        """The generator of one step's stochastic rounding (seeded by
        ``seed`` and the step), or None with fp32 moments or rounding
        off."""
        if (self.moments_dtype == torch.bfloat16
                and self.stochastic_rounding):
            return torch.Generator(device=device).manual_seed(
                mix_seed(seed, step))
        return None

    @staticmethod
    def _resolve_moments_dtype(moments_dtype):
        if moments_dtype not in _MOMENTS_DTYPES:
            raise ValueError(f"moments_dtype must be float32 or bfloat16, "
                             f"got {moments_dtype!r}")
        return _MOMENTS_DTYPES[moments_dtype]
