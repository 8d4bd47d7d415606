"""Shared machinery of the fused optimizers (counterpart of
:mod:`apex_tpu.optimizers._base`): fp32 master weights for amp O2, the
``set_grad_none`` reset, and the global gradient norm that carries the
overflow check."""

from __future__ import annotations

import torch


class FusedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, defaults, master_weights=False,
                 set_grad_none=True):
        super().__init__(params, defaults)
        self.master_weights = master_weights
        self.set_grad_none = set_grad_none

    def set_master_weights(self, flag: bool = True):
        """Keep fp32 master copies of the params (set by
        ``amp.initialize`` for O2, before the first step)."""
        if any(self.state.values()):
            raise RuntimeError("master weights must be set before the "
                               "first step")
        self.master_weights = flag

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none=set_to_none and self.set_grad_none)

    def _param_fp32(self, p, state):
        """The fp32 tensor a step updates for ``p``: its master copy (made
        from ``p`` at the first step), ``p`` itself when fp32, else an fp32
        copy written back after the step."""
        if self.master_weights:
            if "master" not in state:
                state["master"] = p.detach().float().clone()
            return state["master"]
        return p if p.dtype == torch.float32 else p.float()

    @staticmethod
    def global_grad_norm(grads):
        """L2 norm over every gradient, fp32: non-finite iff some gradient
        element is."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))
