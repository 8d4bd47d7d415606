"""FusedSGD (counterpart of :mod:`apex_tpu.optimizers.fused_sgd`).

Momentum SGD whose step is one ``multi_tensor_sgd`` call through
``multi_tensor_applier``, with the step surface of
:class:`~apex_tpu_torch.optimizers._base.FusedOptimizer` (``grads=``,
``grad_scale=``, ``lr=``; the unscale is the op's gradient pre-scale).
Knobs: ``momentum``, ``dampening``, ``nesterov`` (which needs a momentum
and no dampening), ``weight_decay`` before or after the momentum
(``wd_after_momentum``), ``master_weights`` (fp32 masters for amp O2) and
``materialize_master_grads`` (accepted for the reference's signature:
the gradients are always materialized in fp32 by the op). At the first
applied step the momentum buffer takes the gradient itself.
"""

from __future__ import annotations

from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops.multi_tensor import multi_tensor_sgd
from apex_tpu_torch.optimizers._base import FusedOptimizer


class FusedSGD(FusedOptimizer):
    def __init__(self, params, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, set_grad_none=True,
                 master_weights=False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and "
                             "zero dampening")
        self.wd_after_momentum = wd_after_momentum
        self.materialize_master_grads = materialize_master_grads
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        step=0)
        super().__init__(params, defaults, master_weights, set_grad_none)

    def _group_step(self, group, pairs, inv_scale, lr):
        params = [p for p, _ in pairs]
        lists = [[g for _, g in pairs], params,
                 self._state_list(params, "momentum_buffer")]
        if self.master_weights:
            lists.append(self._masters(params))
        first_run = group["step"] == 0
        group["step"] += 1
        multi_tensor_applier(
            multi_tensor_sgd, None, lists, group["weight_decay"],
            group["momentum"], group["dampening"],
            group["lr"] if lr is None else lr, group["nesterov"], first_run,
            self.wd_after_momentum, inv_scale)
