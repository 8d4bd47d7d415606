"""FusedAdam (counterpart of :mod:`apex_tpu.optimizers.fused_adam`).

A ``torch.optim.Optimizer`` whose step is one ``multi_tensor_adam`` call
through ``multi_tensor_applier`` (:mod:`apex_tpu_torch.ops.multi_tensor`:
``torch._foreach_*`` passes over all tensors at once, in fp32), with the
step surface of :class:`~apex_tpu_torch.optimizers._base.FusedOptimizer`
(``grads=``, ``grad_scale=``, ``lr=``):

- ``adam_w_mode=False`` (classic Adam): ``g += weight_decay * p``;
- ``m = beta1 m + (1 - beta1) g``, ``v = beta2 v + (1 - beta2) g g``;
- ``u = (m / bc1) / (sqrt(v / bc2) + eps)`` with ``bc = 1 - beta ** step``
  (1 without ``bias_correction``);
- ``adam_w_mode=True`` (AdamW, decoupled): ``u += weight_decay * p``;
- ``p -= lr * u``.

With master weights (amp O2) the step runs on fp32 copies of the params,
made from the model's (already cast) params at the first step, and writes
the result back into the model's params. ``moments_dtype="bfloat16"``
stores m and v in bf16, written through stochastic rounding (the noise of
each step from a generator seeded by the step; ``stochastic_rounding=False``
rounds to nearest), which halves the optimizer state's bytes.
``amsgrad=True`` raises, as in the JAX package.
"""

from __future__ import annotations

from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops.multi_tensor import (
    ADAM_MODE_ADAMW,
    ADAM_MODE_L2,
    multi_tensor_adam,
)
from apex_tpu_torch.optimizers._base import FusedOptimizer

_SR_SEED = 0xADA3   # the JAX package's FusedAdam rounding seed


class FusedAdam(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 master_weights=False, moments_dtype="float32",
                 stochastic_rounding=True):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        self.moments_dtype = self._resolve_moments_dtype(moments_dtype)
        self.stochastic_rounding = stochastic_rounding
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, adam_w_mode=adam_w_mode,
                        weight_decay=weight_decay, step=0)
        super().__init__(params, defaults, master_weights, set_grad_none)

    def _group_step(self, group, pairs, inv_scale, lr):
        params = [p for p, _ in pairs]
        lists = [[g for _, g in pairs], params,
                 self._state_list(params, "exp_avg", self.moments_dtype),
                 self._state_list(params, "exp_avg_sq", self.moments_dtype)]
        if self.master_weights:
            lists.append(self._masters(params))
        group["step"] += 1
        b1, b2 = group["betas"]
        multi_tensor_applier(
            multi_tensor_adam, None, lists,
            group["lr"] if lr is None else lr, b1, b2, group["eps"],
            group["step"],
            ADAM_MODE_ADAMW if group["adam_w_mode"] else ADAM_MODE_L2,
            group["bias_correction"], group["weight_decay"],
            generator=self._sr_generator(group["step"], params[0].device,
                                         _SR_SEED),
            scale=inv_scale)
