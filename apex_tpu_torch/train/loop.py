"""Deferred-metrics training loop (counterpart of
:class:`apex_tpu.train.loop.TrainLoop`, without its robustness layer).

``loop.step(batch)`` runs one global step and returns the metrics of the
PREVIOUS step as host scalars (``None`` on the first call): the step's
device scalars (the loss, the gradient norm) are fetched only after the
next step has been issued. ``loop.drain()`` returns the last step's
metrics and is the loop's synchronization barrier. The port's step reads
its overflow flag on the host once per global step, so the deferral saves
the loss fetch, not that read.

Not ported yet: the fault plan and dispatch retries, the non-finite-loss
watchdog, periodic checkpoints and the observability hooks (ROADMAP A.3
items 15 and 17); each knob raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.utils import _pytree as pytree


def _to_host(metrics) -> Dict[str, Any]:
    """Tensors fetched to Python scalars (0-d) or numpy arrays."""

    def unwrap(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return x.item() if x.dim() == 0 else x.numpy()
        return x

    return pytree.tree_map(unwrap, metrics)


class TrainLoop:
    """Drive a :class:`~apex_tpu_torch.train.TrainStep` with deferred
    metric fetches. The loop owns the evolving
    :class:`~apex_tpu_torch.train.TrainState` (``loop.state``)."""

    def __init__(self, train_step, state, *, faults=None, max_retries=None,
                 retry_backoff_s=None, watchdog=None, checkpoint_dir=None,
                 checkpoint_every=None, obs=None):
        knobs = dict(faults=faults, max_retries=max_retries,
                     retry_backoff_s=retry_backoff_s, watchdog=watchdog,
                     checkpoint_dir=checkpoint_dir,
                     checkpoint_every=checkpoint_every, obs=obs)
        given = sorted(k for k, v in knobs.items() if v is not None)
        if given:
            raise NotImplementedError(
                f"TrainLoop robustness knobs {given} are not ported yet "
                f"(ROADMAP A.3 items 15 and 17)")
        self._train_step = train_step
        self.state = state
        self._pending = None
        self.last_run_metrics: List[Dict[str, Any]] = []

    def step(self, batch) -> Optional[Dict[str, Any]]:
        """Run one global step; return the PREVIOUS step's metrics (fetched
        now, after this step was issued), ``None`` on the first call."""
        self.state, metrics = self._train_step(self.state, batch)
        prev, self._pending = self._pending, metrics
        return None if prev is None else _to_host(prev)

    def drain(self) -> Optional[Dict[str, Any]]:
        """The last step's metrics (``None`` if nothing is pending); once
        it returns, every issued step has finished on the device."""
        prev, self._pending = self._pending, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return None if prev is None else _to_host(prev)

    def run(self, batches: Iterable) -> List[Dict[str, Any]]:
        """Feed every batch, deferred throughout; every step's metrics in
        order, the last fetched by the closing drain (also kept on
        ``last_run_metrics``, including when a step raises)."""
        out: List[Dict[str, Any]] = []
        self.last_run_metrics = out
        try:
            for batch in batches:
                m = self.step(batch)
                if m is not None:
                    out.append(m)
        finally:
            m = self.drain()
            if m is not None:
                out.append(m)
        return out
