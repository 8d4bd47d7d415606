"""Legacy ``FP16_Optimizer`` (counterpart of
:mod:`apex_tpu.fp16_utils.fp16_optimizer`).

It wraps a port ``Fused*`` optimizer built on the model's (half) params,
turns on its fp32 master weights, and keeps a loss scaler, static or
dynamic::

    opt = FP16_Optimizer(FusedSGD(model.parameters(), lr=1e-2),
                         dynamic_loss_scale=True)
    opt.zero_grad()
    opt.backward(loss)        # the scaled loss's backward
    opt.step()                # unscale, overflow check, master step

``step`` follows the JAX class: the wrapped optimizer's
``step(grads=, grad_scale=)`` reads the overflow flag off the scaled
gradients (the step's one host read) and unscales them inside its first
read, then the scaler is updated. On overflow the params, the masters,
the moments and the step count stay as they were and ``overflow`` is
True.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.scaler import LossScaler, ScalerState

# the reference DynamicLossScaler's argument names, as LossScaler's fields
_DYNAMIC_ARGS = {"init_scale": "init_scale", "scale_factor": "scale_factor",
                 "scale_window": "scale_seq_len",
                 "min_scale": "min_loss_scale",
                 "max_scale": "max_loss_scale"}


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None):
        init_optimizer.set_master_weights(True)
        self.optimizer = init_optimizer
        if dynamic_loss_scale:
            kw = {_DYNAMIC_ARGS.get(k, k): v
                  for k, v in (dynamic_loss_args or {}).items()}
            self.loss_scaler = LossScaler("dynamic", **kw)
        else:
            self.loss_scaler = LossScaler(float(static_loss_scale))
        self.scaler_state = self.loss_scaler.init()
        self.overflow = False

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def loss_scale(self) -> float:
        return self.scaler_state.loss_scale

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def scale_loss(self, loss):
        """The loss times the current scale."""
        return self.loss_scaler.scale(loss, self.scaler_state)

    def backward(self, loss, retain_graph: bool = False):
        """Backward of the scaled loss: the params' ``.grad`` hold scaled
        gradients."""
        self.scale_loss(loss).backward(retain_graph=retain_graph)

    @torch.no_grad()
    def step(self, closure=None, lr=None) -> bool:
        """The wrapped optimizer's step on the scaled gradients (overflow
        check and unscale inside it), then the scaler update. Returns
        ``overflow``."""
        if closure is not None:
            with torch.enable_grad():
                closure()
        params = [p for g in self.param_groups for p in g["params"]]
        self.overflow = self.optimizer.step(
            grads=[p.grad for p in params],
            grad_scale=self.scaler_state.loss_scale, lr=lr)
        self.scaler_state = self.loss_scaler.update(self.scaler_state,
                                                    self.overflow)
        return self.overflow

    def state_dict(self):
        """The scaler's state and the wrapped optimizer's."""
        return {"loss_scaler": self.scaler_state._asdict(),
                "optimizer_state": self.optimizer.state_dict()}

    def load_state_dict(self, sd):
        s = sd["loss_scaler"]
        self.scaler_state = ScalerState(
            float(s["loss_scale"]), int(s["unskipped"]),
            int(s.get("steps_skipped", 0)),
            int(s.get("hysteresis", self.loss_scaler.hysteresis)))
        self.optimizer.load_state_dict(sd["optimizer_state"])
