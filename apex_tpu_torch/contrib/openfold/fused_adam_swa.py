"""FusedAdamSWA: an Adam step and a stochastic-weight-averaging buffer
update in one optimizer step (counterpart of
:mod:`apex_tpu.contrib.openfold.fused_adam_swa`).

OpenFold training keeps an average of the trained weights for
evaluation. With ``swa_decay_rate = d`` the average follows ``swa = d *
swa + (1 - d) * p_new`` in fp32 after each step, where ``p_new`` is the
fp32 master when master weights are on, else the updated param. The
first real step copies ``p_new`` instead of blending, so the average
starts at the first updated params; a step skipped on overflow leaves
the step count at 0, and the next real step copies.

The Adam math is :class:`~apex_tpu_torch.optimizers.FusedAdam`'s; the
JAX package has no Pallas kernel here, so the average is one more
``torch._foreach_*`` pass over the stepped params.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.optimizers.fused_adam import FusedAdam


class SWAState(NamedTuple):
    """The optimizer's state in the JAX package's layout: the step count
    and, per param in ``param_groups`` order, the fp32 moments, the fp32
    masters (None without master weights) and the fp32 average."""

    step: int
    exp_avg: list
    exp_avg_sq: list
    master: object
    swa: list


class FusedAdamSWA(FusedAdam):
    """Adam(W) with a fused SWA buffer: the knobs of
    :class:`~apex_tpu_torch.optimizers.FusedAdam` plus ``swa_decay_rate``.
    Read the averaged weights with :meth:`swa_params`."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, master_weights=False,
                 swa_decay_rate=0.9, set_grad_none=True):
        super().__init__(params, lr=lr, bias_correction=bias_correction,
                         betas=betas, eps=eps, adam_w_mode=adam_w_mode,
                         weight_decay=weight_decay,
                         set_grad_none=set_grad_none,
                         master_weights=master_weights)
        self.swa_decay_rate = swa_decay_rate

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _group_step(self, group, pairs, inv_scale, lr):
        super()._group_step(group, pairs, inv_scale, lr)
        if not pairs:
            return
        # fp32 constants as the JAX step computes them
        d = np.float32(self.swa_decay_rate)
        src = [(self.state[p]["master"] if self.master_weights
                else p.detach()).float() for p, _ in pairs]
        if group["step"] == 1:
            for (p, _), s in zip(pairs, src):
                self.state[p]["swa"] = s.clone()
            return
        swa = [self.state[p]["swa"] for p, _ in pairs]
        torch._foreach_mul_(swa, float(d))
        torch._foreach_add_(swa, torch._foreach_mul(src, float(
            np.float32(1.0) - d)))

    def swa_params(self, like=None):
        """The averaged weights, one fp32 tensor per param in
        ``param_groups`` order (a param not stepped yet: its fp32 copy, the
        average's starting point), or cast to the dtypes of ``like``'s
        tensors."""
        out = [self.state[p]["swa"] if "swa" in self.state[p]
               else p.detach().float() for p in self._params()]
        if like is None:
            return out
        return [s.to(t.dtype) for s, t in zip(out, like)]

    def swa_state(self) -> SWAState:
        """The state as :class:`SWAState` (the tensors themselves)."""
        ps = self._params()
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in ps]

        def get(key, default):
            return [self.state[p].get(key, d) for p, d in zip(ps, default)]

        masters = None
        if self.master_weights:
            masters = get("master", [p.detach().float() for p in ps])
        return SWAState(step=self.param_groups[0]["step"],
                        exp_avg=get("exp_avg", zeros),
                        exp_avg_sq=get("exp_avg_sq", zeros),
                        master=masters, swa=self.swa_params())
