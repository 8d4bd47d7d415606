"""FusedNovoGrad (counterpart of :mod:`apex_tpu.optimizers.fused_novograd`).

NovoGrad whose step is one ``multi_tensor_novograd`` call through
``multi_tensor_applier``, with the step surface of
:class:`~apex_tpu_torch.optimizers._base.FusedOptimizer`. The second
moment is one fp32 number a tensor (``state[p]["exp_avg_sq"]``, the
running average of its squared gradient norm), which normalizes the
tensor's gradient before the first-moment average. Knobs:
``bias_correction``, ``betas``, ``eps``, ``weight_decay``,
``grad_averaging``, ``norm_type`` (2 only, like the reference kernel),
``init_zero`` (the average starts from 0; else step 1 takes the squared
norms) and ``master_weights``. The weight decay is added inside the
moment, as in the JAX package's math.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops.multi_tensor import multi_tensor_novograd
from apex_tpu_torch.optimizers._base import FusedOptimizer


class FusedNovoGrad(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.95, 0.98), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, grad_averaging=True,
                 norm_type=2, init_zero=False, set_grad_none=True,
                 master_weights=False):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        if norm_type != 2:
            raise RuntimeError("FusedNovoGrad only supports the L2 "
                               "norm_type, like the reference kernel.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging, norm_type=norm_type,
                        init_zero=init_zero, step=0)
        super().__init__(params, defaults, master_weights, set_grad_none)

    def _group_step(self, group, pairs, inv_scale, lr):
        params = [p for p, _ in pairs]
        v_state = self._state_list(params, "exp_avg_sq", scalar=True)
        v = torch.stack(v_state)
        lists = [[g for _, g in pairs], params,
                 self._state_list(params, "exp_avg"), v]
        if self.master_weights:
            lists.append(self._masters(params))
        group["step"] += 1
        b1, b2 = group["betas"]
        multi_tensor_applier(
            multi_tensor_novograd, None, lists,
            group["lr"] if lr is None else lr, b1, b2, group["eps"],
            group["step"], group["bias_correction"], group["weight_decay"],
            group["grad_averaging"], group["norm_type"], group["init_zero"],
            scale=inv_scale)
        torch._foreach_copy_(v_state, list(v.unbind()))
