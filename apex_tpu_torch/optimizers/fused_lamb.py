"""FusedLAMB (counterpart of :mod:`apex_tpu.optimizers.fused_lamb` and
the LAMB math of :mod:`apex_tpu.ops.multi_tensor`).

A ``torch.optim.Optimizer`` in plain PyTorch: the JAX package has no
Pallas kernel here and leaves the math to XLA fusion, so the port runs it
as ``torch._foreach_*`` passes over all tensors at once:

- stage 0: the global gradient norm;
- stage 1: clip by it, update the moments, form each tensor's update
  direction ``m_hat / (sqrt(v_hat) + eps) + weight_decay * p``;
- stage 2: each tensor's trust ratio ``||p|| / ||u||`` (1 where either is
  0; applied only with weight decay or ``use_nvlamb``) and the step.

``step(grads=...)`` takes the gradients as a list instead of reading
``p.grad`` (``build_train_step`` hands in its fp32 averages).
``step(grad_scale=s)`` takes gradients scaled by ``s``: it unscales them
inside its own reads (the norm and the stage-1 clip factor) and reads the
overflow flag off the global norm, which is non-finite iff some gradient
is. That read is the step's one host sync. On overflow nothing changes,
not even the step count, and ``step`` returns True.

With master weights (amp O2) the step runs on fp32 copies of the params,
made from the model's (already cast) params at the first step, and writes
the result back into the model's params. ``moments_dtype="bfloat16"``
(the JAX package's stochastically rounded bf16 moments) is not ported
yet.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers._base import FusedOptimizer


class FusedLAMB(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False,
                 master_weights=False, moments_dtype="float32"):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        if not adam_w_mode:
            raise RuntimeError("FusedLAMB only supports adam_w_mode "
                               "(decoupled weight decay).")
        if moments_dtype not in ("float32", torch.float32):
            raise NotImplementedError(
                f"moments_dtype={moments_dtype!r}: only float32 moments are "
                f"ported (the bf16 moment tier is not yet)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb,
                        step=0)
        super().__init__(params, defaults, master_weights, set_grad_none)

    @torch.no_grad()
    def step(self, closure=None, *, grad_scale=None, lr=None, grads=None):
        """One LAMB step over every param with a gradient. ``grads``, when
        given, replaces the params' ``.grad``: one tensor (or None) per
        param of ``param_groups`` in order, in any floating dtype (an fp32
        accumulator is read as it is, never rounded into a bf16
        ``.grad``). Returns the overflow flag when ``grad_scale`` is given,
        else the closure's loss (or None)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        all_params = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [p.grad for p in all_params]
        elif len(grads) != len(all_params):
            raise ValueError(f"FusedLAMB.step: {len(grads)} gradients for "
                             f"{len(all_params)} params")
        live = [g for g in grads if g is not None]
        if not live:
            return False if grad_scale is not None else loss
        global_norm = self.global_grad_norm(live)
        pre_scale = 1.0
        if grad_scale is not None:
            if not bool(torch.isfinite(global_norm)):
                return True
            pre_scale = 1.0 / float(grad_scale)
            global_norm = global_norm * pre_scale
        start = 0
        for group in self.param_groups:
            n = len(group["params"])
            pairs = [(p, g) for p, g in zip(group["params"],
                                            grads[start:start + n])
                     if g is not None]
            start += n
            self._group_step(group, pairs, global_norm, pre_scale, lr)
        return False if grad_scale is not None else loss

    def _group_step(self, group, pairs, global_norm, pre_scale, lr):
        if not pairs:
            return
        params = [p for p, _ in pairs]
        lr = group["lr"] if lr is None else lr
        b1, b2 = group["betas"]
        wd, eps = group["weight_decay"], group["eps"]
        group["step"] += 1
        step = group["step"]
        max_norm = group["max_grad_norm"]
        clip = (torch.where(global_norm > max_norm, max_norm / global_norm,
                            torch.ones_like(global_norm))
                if max_norm > 0 else torch.ones_like(global_norm))
        clip = clip * pre_scale
        if group["bias_correction"]:
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        else:
            bc1 = bc2 = 1.0
        beta3 = (1.0 - b1) if group["grad_averaging"] else 1.0

        m, v, p32 = [], [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            m.append(st["exp_avg"])
            v.append(st["exp_avg_sq"])
            p32.append(self._param_fp32(p, st))

        # stage 1: clip (with the unscale folded in), moments, directions
        g32 = torch._foreach_mul([g.float() for _, g in pairs], clip)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=beta3)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1.0 - b2)
        del g32
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, denom)
        del denom
        if wd != 0.0:
            torch._foreach_add_(u, p32, alpha=wd)

        # stage 2: trust ratios and the step, p -= (lr * ratio) * u
        if group["use_nvlamb"] or wd != 0.0:
            w_norm = torch.stack(torch._foreach_norm(p32))
            u_norm = torch.stack(torch._foreach_norm(u))
            ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, torch.ones_like(w_norm))
            torch._foreach_mul_(u, list((lr * ratio).unbind()))
        else:
            torch._foreach_mul_(u, lr)
        torch._foreach_sub_(p32, u)
        copy_back = [(p, q) for p, q in zip(params, p32) if p is not q]
        if copy_back:
            torch._foreach_copy_([p for p, _ in copy_back],
                                 [q for _, q in copy_back])
