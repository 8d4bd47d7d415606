"""LARC: layer-wise adaptive rate clipping or scaling (counterpart of
:mod:`apex_tpu.parallel.larc`).

Wraps a port ``Fused*`` optimizer. Each parameter gets

    local_lr = trust_coefficient * ||p|| / (||g|| + weight_decay * ||p|| + eps)

and, where ``||p|| > 0`` and ``||g|| > 0``, its gradient becomes ``(g +
weight_decay * p) * scale`` with ``scale = min(local_lr / lr, 1)``
(``clip=True``: the step capped at lr) or ``local_lr`` (``clip=False``:
pure LARS); elsewhere the gradient stays as it is and gets no decay. The
inner optimizer then steps with weight decay 0 (the group's value is put
back afterwards). The per-tensor norms of the parameters and gradients
are one ``multi_tensor_l2norm(..., per_tensor=True)`` call.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import _f32, multi_tensor_l2norm


class LARC:
    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8):
        self.optimizer = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @torch.no_grad()
    def _adjust(self, grads, params, lr, weight_decay):
        """The adjusted gradients of one parameter group (new tensors, in
        the gradients' dtypes)."""
        n = len(params)
        _, norms = multi_tensor_l2norm(None, None, [list(params) + grads],
                                       per_tensor=True)
        p_norm, g_norm = norms[:n], norms[n:]
        local_lr = self.trust_coefficient * p_norm / (
            g_norm + p_norm * weight_decay + self.eps)
        scale = (torch.clamp(local_lr / lr, max=1.0) if self.clip
                 else local_lr)
        active = (p_norm > 0) & (g_norm > 0)
        decay = torch.where(active, torch.full_like(scale, weight_decay),
                            torch.zeros_like(scale))
        scale = torch.where(active, scale, torch.ones_like(scale))
        g32 = _f32(grads, copy=True)
        if weight_decay != 0.0:
            torch._foreach_add_(g32, torch._foreach_mul(
                _f32(params), list(decay.unbind())))
        torch._foreach_mul_(g32, list(scale.unbind()))
        return [a.to(g.dtype) for a, g in zip(g32, grads)]

    def step(self, grads=None, lr=None):
        """Adjust every live gradient (``grads`` in ``param_groups`` order,
        else ``.grad``), then the inner step with weight decay 0 and
        ``lr``; returns what the inner step returns."""
        groups = self.optimizer.param_groups
        params = [p for g in groups for p in g["params"]]
        if grads is None:
            grads = [p.grad for p in params]
        elif len(grads) != len(params):
            raise ValueError(f"LARC.step: {len(grads)} gradients for "
                             f"{len(params)} params")
        grads = list(grads)
        saved = [g.get("weight_decay", 0.0) for g in groups]
        start = 0
        for group, wd in zip(groups, saved):
            idx = [i for i in range(start, start + len(group["params"]))
                   if grads[i] is not None]
            start += len(group["params"])
            if idx:
                adjusted = self._adjust(
                    [grads[i] for i in idx], [params[i] for i in idx],
                    group["lr"] if lr is None else lr, wd)
                for i, a in zip(idx, adjusted):
                    grads[i] = a
        try:
            for group in groups:
                group["weight_decay"] = 0.0
            return self.optimizer.step(grads=grads, lr=lr)
        finally:
            for group, wd in zip(groups, saved):
                group["weight_decay"] = wd
