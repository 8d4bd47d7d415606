"""FusedLAMB and FusedMixedPrecisionLamb (counterpart of
:mod:`apex_tpu.optimizers.fused_lamb`).

A ``torch.optim.Optimizer`` whose step runs the LAMB math of
:mod:`apex_tpu_torch.ops.multi_tensor` through ``multi_tensor_applier``
(``torch._foreach_*`` passes over all tensors at once, in fp32):

- stage 0: the global gradient norm (``multi_tensor_l2norm``);
- stage 1: clip by it, update the moments, form each tensor's update
  direction ``m_hat / (sqrt(v_hat) + eps) + weight_decay * p``
  (``multi_tensor_lamb_stage1``);
- stage 2: each tensor's trust ratio ``||p|| / ||u||`` (1 where either is
  0; applied only with weight decay or ``use_nvlamb``) and the step
  (``multi_tensor_lamb_stage2``).

``step(grad_scale=s)`` unscales inside its own reads (the norm and the
stage-1 clip factor) and reads the overflow flag off the global norm,
which is non-finite iff some gradient is: the step's one host sync. On
overflow nothing changes, not even the step count, and ``step`` returns
True. The rest of the step surface is
:class:`~apex_tpu_torch.optimizers._base.FusedOptimizer`'s.

With master weights (amp O2) the step runs on fp32 copies of the params,
made from the model's (already cast) params at the first step, and writes
the result back into the model's params. ``moments_dtype="bfloat16"``
stores m and v in bf16 through stochastic rounding (``stochastic_rounding
=False``: to nearest) and forms the update direction from the rounded
moments, so the trust ratio and the step see what is stored, as in the
JAX package.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops.multi_tensor import (
    multi_tensor_l2norm,
    multi_tensor_lamb_stage1,
    multi_tensor_lamb_stage2,
)
from apex_tpu_torch.optimizers._base import FusedOptimizer

_SR_SEED = 0x5A17   # the JAX package's FusedLAMB rounding seed


class FusedLAMB(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False,
                 master_weights=False, moments_dtype="float32",
                 stochastic_rounding=True):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        if not adam_w_mode:
            raise RuntimeError("FusedLAMB only supports adam_w_mode "
                               "(decoupled weight decay).")
        self.moments_dtype = self._resolve_moments_dtype(moments_dtype)
        self.stochastic_rounding = stochastic_rounding
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb,
                        step=0)
        super().__init__(params, defaults, master_weights, set_grad_none)

    def _unscale(self, live, grad_scale):
        """Stage 0: ``(overflow, (unscaled global norm, pre-scale))``."""
        global_norm, _ = multi_tensor_applier(multi_tensor_l2norm, None,
                                              [live])
        if grad_scale is None:
            return False, (global_norm, 1.0)
        if not bool(torch.isfinite(global_norm)):
            return True, None
        pre_scale = 1.0 / float(grad_scale)
        return False, (global_norm * pre_scale, pre_scale)

    def _group_step(self, group, pairs, norm_and_scale, lr):
        global_norm, pre_scale = norm_and_scale
        params = [p for p, _ in pairs]
        grads = [g for _, g in pairs]
        m = self._state_list(params, "exp_avg", self.moments_dtype)
        v = self._state_list(params, "exp_avg_sq", self.moments_dtype)
        masters = self._masters(params)
        src = masters if masters is not None else params
        group["step"] += 1
        b1, b2 = group["betas"]
        args = (b1, b2, group["eps"], group["step"],
                group["bias_correction"], group["weight_decay"],
                group["grad_averaging"], global_norm,
                group["max_grad_norm"], pre_scale)
        gen = self._sr_generator(group["step"], src[0].device, _SR_SEED)
        u, _, _ = multi_tensor_applier(multi_tensor_lamb_stage1, None,
                                       [grads, src, m, v], *args,
                                       generator=gen)
        lists = [params, u] + ([masters] if masters is not None else [])
        multi_tensor_applier(multi_tensor_lamb_stage2, None, lists,
                             group["lr"] if lr is None else lr,
                             group["weight_decay"], group["use_nvlamb"])


class FusedMixedPrecisionLamb(FusedLAMB):
    """LAMB with fp32 master weights and moments for a model (and its
    gradients) in reduced precision (``apex.optimizers.
    FusedMixedPrecisionLamb``): ``FusedLAMB`` with ``master_weights`` on
    by default, since the port's LAMB already runs its moments and trust
    ratios in fp32 and casts the step back to each param's dtype (the
    reduced dtype is the params', not a setting)."""

    def __init__(self, params, master_weights=True, **kwargs):
        super().__init__(params, master_weights=master_weights, **kwargs)
