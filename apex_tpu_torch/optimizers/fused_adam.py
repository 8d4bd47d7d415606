"""FusedAdam (counterpart of :mod:`apex_tpu.optimizers.fused_adam` and the
Adam math of :mod:`apex_tpu.ops.multi_tensor`'s ``multi_tensor_adam``).

A ``torch.optim.Optimizer`` in plain PyTorch: the JAX package has no
Pallas kernel here and leaves the math to XLA fusion, so the port runs it
as ``torch._foreach_*`` passes over all tensors at once, in fp32:

- ``adam_w_mode=False`` (classic Adam): ``g += weight_decay * p``;
- ``m = beta1 m + (1 - beta1) g``, ``v = beta2 v + (1 - beta2) g g``;
- ``u = (m / bc1) / (sqrt(v / bc2) + eps)`` with ``bc = 1 - beta ** step``
  (1 without ``bias_correction``);
- ``adam_w_mode=True`` (AdamW, decoupled): ``u += weight_decay * p``;
- ``p -= lr * u``.

``step(grads=...)`` takes the gradients as a list instead of reading
``p.grad`` (``build_train_step`` hands in its fp32 averages).
``step(grad_scale=s)`` takes gradients scaled by ``s``: it reads the
overflow flag off their global norm (the step's one host sync), and on
overflow changes nothing, not even the step count, and returns True;
otherwise it unscales them in fp32.

With master weights (amp O2) the step runs on fp32 copies of the params,
made from the model's (already cast) params at the first step, and writes
the result back into the model's params. ``amsgrad=True`` raises, as in
the JAX package; ``moments_dtype="bfloat16"`` (the JAX package's
stochastically rounded bf16 moments) is not ported yet and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.optimizers._base import FusedOptimizer


class FusedAdam(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 master_weights=False, moments_dtype="float32"):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        if moments_dtype not in ("float32", torch.float32):
            raise NotImplementedError(
                f"moments_dtype={moments_dtype!r}: only float32 moments are "
                f"ported (the bf16 moment tier is not yet; ROADMAP A.2 "
                f"item 6c)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, adam_w_mode=adam_w_mode,
                        weight_decay=weight_decay, step=0)
        super().__init__(params, defaults, master_weights, set_grad_none)

    @torch.no_grad()
    def step(self, closure=None, *, grad_scale=None, lr=None, grads=None):
        """One Adam step over every param with a gradient. ``grads``, when
        given, replaces the params' ``.grad``: one tensor (or None) per
        param of ``param_groups`` in order, in any floating dtype. Returns
        the overflow flag when ``grad_scale`` is given, else the closure's
        loss (or None)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        all_params = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [p.grad for p in all_params]
        elif len(grads) != len(all_params):
            raise ValueError(f"FusedAdam.step: {len(grads)} gradients for "
                             f"{len(all_params)} params")
        live = [g for g in grads if g is not None]
        if not live:
            return False if grad_scale is not None else loss
        inv_scale = 1.0
        if grad_scale is not None:
            if not bool(torch.isfinite(self.global_grad_norm(live))):
                return True
            inv_scale = float(np.float32(1.0) / np.float32(grad_scale))
        start = 0
        for group in self.param_groups:
            n = len(group["params"])
            pairs = [(p, g) for p, g in zip(group["params"],
                                            grads[start:start + n])
                     if g is not None]
            start += n
            self._group_step(group, pairs, inv_scale, lr)
        return False if grad_scale is not None else loss

    def _group_step(self, group, pairs, inv_scale, lr):
        if not pairs:
            return
        params = [p for p, _ in pairs]
        lr = group["lr"] if lr is None else lr
        b1, b2 = group["betas"]
        wd, eps = group["weight_decay"], group["eps"]
        group["step"] += 1
        step = group["step"]
        if group["bias_correction"]:
            # fp32, as the JAX step's traced int32 step count gives
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        else:
            bc1 = bc2 = 1.0

        m, v, p32 = [], [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            m.append(st["exp_avg"])
            v.append(st["exp_avg_sq"])
            p32.append(self._param_fp32(p, st))

        # new tensors: an fp32 gradient's .float() is the caller's tensor
        g32 = torch._foreach_mul([g.float() for _, g in pairs], inv_scale)
        if not group["adam_w_mode"] and wd != 0.0:
            torch._foreach_add_(g32, p32, alpha=wd)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1.0 - b2)
        del g32
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, denom)
        del denom
        if group["adam_w_mode"] and wd != 0.0:
            torch._foreach_add_(u, p32, alpha=wd)
        torch._foreach_add_(p32, u, alpha=-lr)
        copy_back = [(p, q) for p, q in zip(params, p32) if p is not q]
        if copy_back:
            torch._foreach_copy_([p for p, _ in copy_back],
                                 [q for _, q in copy_back])
