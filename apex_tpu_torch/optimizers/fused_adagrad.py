"""FusedAdagrad (counterpart of :mod:`apex_tpu.optimizers.fused_adagrad`).

Adagrad whose step is one ``multi_tensor_adagrad`` call through
``multi_tensor_applier``, with the step surface of
:class:`~apex_tpu_torch.optimizers._base.FusedOptimizer`: ``h += g*g``,
``p -= lr * g / (sqrt(h) + eps)``, weight decay in the gradient or, with
``adagrad_w_mode``, decoupled; ``master_weights`` for amp O2.
"""

from __future__ import annotations

from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops.multi_tensor import (
    ADAM_MODE_ADAMW,
    ADAM_MODE_L2,
    multi_tensor_adagrad,
)
from apex_tpu_torch.optimizers._base import FusedOptimizer


class FusedAdagrad(FusedOptimizer):
    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 adagrad_w_mode=False, set_grad_none=True,
                 master_weights=False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay,
                        adagrad_w_mode=adagrad_w_mode, step=0)
        super().__init__(params, defaults, master_weights, set_grad_none)

    def _group_step(self, group, pairs, inv_scale, lr):
        params = [p for p, _ in pairs]
        lists = [[g for _, g in pairs], params,
                 self._state_list(params, "sum")]
        if self.master_weights:
            lists.append(self._masters(params))
        group["step"] += 1
        multi_tensor_applier(
            multi_tensor_adagrad, None, lists,
            group["lr"] if lr is None else lr, group["eps"],
            ADAM_MODE_ADAMW if group["adagrad_w_mode"] else ADAM_MODE_L2,
            group["weight_decay"], scale=inv_scale)
