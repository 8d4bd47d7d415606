"""Deferred-metrics training loop with its robustness layer (counterpart
of :class:`apex_tpu.train.loop.TrainLoop`).

``loop.step(batch)`` runs one global step and returns the metrics of the
PREVIOUS step as host scalars (``None`` on the first call): the step's
device scalars (the loss, the gradient norm) are fetched only after the
next step has been issued. ``loop.drain()`` returns the last step's
metrics and is the loop's synchronization barrier. The port's step reads
its overflow flag on the host once per global step, so the deferral saves
the loss fetch, not that read.

Robustness, all off by default:

- **Transient dispatch failure**: the step runs under
  :func:`~apex_tpu_torch.utils.faults.guarded_call` at site
  ``"train_step"``, retried up to ``max_retries`` times with exponential
  backoff. Sound because the fault plan fires before the step: the
  port's step updates the parameters in place, so a retry after a real
  failure midway through a step would not be, and none is attempted (a
  CUDA error is not transient; ROADMAP C7).
- **Non-finite loss**: a watchdog (:class:`WatchdogConfig`) climbs on
  consecutive non-finite losses: skip (count), then rescale (halve the
  loss scale, a host float), then halt (:class:`NonFiniteLossError`).
  It sees step ``t``'s loss after issuing step ``t + 1``.
- **Process death**: every ``checkpoint_every`` steps the whole state
  (parameters, optimizer state, scaler state, the dropout generator) is
  saved under ``checkpoint_dir``
  (:func:`~apex_tpu_torch.utils.checkpoint.save_train_state`);
  ``load_train_state`` into a fresh step and loop resumes bit-identically.

Observability: ``obs`` (an :class:`~apex_tpu_torch.observability.
Observability`) gets the step histogram (``train_step_s``), the step,
retry, non-finite and checkpoint counters, and the retries, watchdog
actions and checkpoints as recorder events; ``stats(deep=True)`` adds its
section. The step span includes device time: the port's step reads its
overflow flag on the host, so the span waits for the step's gradients on
the device (the JAX span is the dispatch alone). Nothing the loop decides
reads the observer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.utils.faults import guarded_call


def _to_host(metrics) -> Dict[str, Any]:
    """Tensors fetched to Python scalars (0-d) or numpy arrays."""

    def unwrap(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return x.item() if x.dim() == 0 else x.numpy()
        return x

    return pytree.tree_map(unwrap, metrics)


class NonFiniteLossError(RuntimeError):
    """The watchdog's halt rung: the loss stayed non-finite through the
    skip and rescale rungs. Carries the offending host ``metrics`` and
    the loop's ``stats()``."""

    def __init__(self, message: str, metrics: Dict[str, Any],
                 stats: Dict[str, Any]):
        super().__init__(f"{message} (metrics: {metrics})")
        self.metrics = metrics
        self.loop_stats = stats


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """The non-finite-loss ladder, rung widths in CONSECUTIVE non-finite
    steps (a finite loss resets the climb): the first ``skip_steps`` are
    counted, the next ``rescale_steps`` each halve the loss scale
    (floored at ``min_scale``), and the one after raises
    :class:`NonFiniteLossError`."""

    skip_steps: int = 3
    rescale_steps: int = 3
    min_scale: float = 1.0
    loss_key: str = "loss"

    def __post_init__(self):
        if self.skip_steps < 0 or self.rescale_steps < 0:
            raise ValueError("watchdog rung widths must be >= 0")


class TrainLoop:
    """Drive a :class:`~apex_tpu_torch.train.TrainStep` with deferred
    metric fetches. The loop owns the evolving
    :class:`~apex_tpu_torch.train.TrainState` (``loop.state``).

    Keyword-only knobs: ``faults`` (a
    :class:`~apex_tpu_torch.utils.faults.FaultPlan`, fired at site
    ``"train_step"`` before each step), ``max_retries`` /
    ``retry_backoff_s``, ``watchdog`` (a :class:`WatchdogConfig`),
    ``checkpoint_dir`` + ``checkpoint_every`` (a checkpoint every N
    steps), and ``obs`` (an
    :class:`~apex_tpu_torch.observability.Observability`)."""

    def __init__(self, train_step, state, *, faults=None,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 watchdog: Optional[WatchdogConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, obs=None):
        self._train_step = train_step
        self.state = state
        self._obs = obs
        if obs is not None:
            obs.bind_train()
        self._pending = None
        self._faults = faults
        self._max_retries = int(max_retries)
        self._retry_backoff_s = float(retry_backoff_s)
        self._watchdog = watchdog
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = int(checkpoint_every)
        self._steps_dispatched = 0
        self._retries = 0
        self._nonfinite_run = 0        # consecutive non-finite losses
        self._watchdog_trips = 0       # every non-finite loss seen
        self._watchdog_skips = 0
        self._watchdog_rescales = 0
        self._watchdog_halts = 0
        self._checkpoints_saved = 0
        self._last_checkpoint_step: Optional[int] = None
        # the current or last run()'s metrics, the finally-drained last
        # step included when run() unwinds
        self.last_run_metrics: List[Dict[str, Any]] = []

    def step(self, batch) -> Optional[Dict[str, Any]]:
        """Run one global step; return the PREVIOUS step's metrics
        (fetched now, after this step was issued), ``None`` on the first
        call. Raises ``DispatchFailedError`` when the retries run out and
        :class:`NonFiniteLossError` at the watchdog's halt rung."""
        obs = self._obs
        t0 = obs.now() if obs is not None else 0.0

        def count(attempt):
            self._retries += 1
            if obs is not None:
                obs.record("fault_retry", site="train_step",
                           attempt=attempt)
                obs.inc("retries")

        (new_state, metrics), nan_hit = guarded_call(
            self._train_step, self.state, batch, plan=self._faults,
            site="train_step", retries=self._max_retries,
            backoff_s=self._retry_backoff_s, on_retry=count)
        self.state = new_state
        self._steps_dispatched += 1
        if nan_hit:
            # the injected silent failure: the step ran, its loss is NaN
            metrics = dict(metrics)
            metrics[self._watchdog.loss_key if self._watchdog is not None
                    else "loss"] = float("nan")
        prev, self._pending = self._pending, metrics
        out = None if prev is None else _to_host(prev)
        if obs is not None:
            # this step and the previous step's fetch
            dt = obs.now() - t0
            obs.inc("steps")
            obs.observe("step", dt)
            obs.record("train_step", step=self._steps_dispatched,
                       host_span_s=dt)
        if out is not None:
            self._observe(out, raise_on_halt=True)
        self._maybe_checkpoint()
        return out

    def drain(self, raise_on_halt: bool = False) -> Optional[Dict[str, Any]]:
        """The last step's metrics (``None`` if nothing is pending); once
        it returns, every issued step has finished on the device. The
        watchdog counts them but raises only with ``raise_on_halt`` (a
        drain in a ``finally`` must not mask the failure unwinding)."""
        prev, self._pending = self._pending, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out = None if prev is None else _to_host(prev)
        if out is not None:
            self._observe(out, raise_on_halt=raise_on_halt)
        return out

    def run(self, batches: Iterable) -> List[Dict[str, Any]]:
        """Feed every batch, deferred throughout; every step's metrics in
        order, the last fetched by the closing drain (also kept on
        ``last_run_metrics``, including when a step raises). A completed
        run's drain may halt; an unwinding run's drain drops its own
        failure."""
        out: List[Dict[str, Any]] = []
        self.last_run_metrics = out
        completed = False
        try:
            for batch in batches:
                m = self.step(batch)
                if m is not None:
                    out.append(m)
            completed = True
        finally:
            if completed:
                m = self.drain(raise_on_halt=True)
            else:
                try:
                    m = self.drain()
                except Exception:
                    m = None
            if m is not None:
                out.append(m)
        return out

    # -- the non-finite-loss watchdog --------------------------------------

    def _observe(self, metrics: Dict[str, Any], raise_on_halt: bool) -> None:
        wd = self._watchdog
        if wd is None:
            return
        loss = metrics.get(wd.loss_key)
        if loss is None:
            return
        if math.isfinite(float(loss)):
            self._nonfinite_run = 0
            return
        self._nonfinite_run += 1
        self._watchdog_trips += 1
        obs = self._obs
        if obs is not None:
            obs.inc("nonfinite")
        run = self._nonfinite_run
        if run <= wd.skip_steps:
            self._watchdog_skips += 1
            if obs is not None:
                obs.record("watchdog", action="skip", run=run)
        elif run <= wd.skip_steps + wd.rescale_steps:
            self._watchdog_rescales += 1
            if obs is not None:
                obs.record("watchdog", action="rescale", run=run)
            self._rescale(wd)
        elif raise_on_halt:
            # counted only when raised: a drain while unwinding may see
            # one more halt-level loss, the same failure
            self._watchdog_halts += 1
            if obs is not None:
                obs.record("watchdog", action="halt", run=run)
                obs.incident("watchdog_halt", run=run)
            raise NonFiniteLossError(
                f"loss non-finite for {run} consecutive steps "
                f"(through {wd.skip_steps} skips and "
                f"{wd.rescale_steps} rescales)", metrics, self.stats())

    def _rescale(self, wd: WatchdogConfig) -> None:
        """The middle rung: halve the loss scale (a host float, so nothing
        is read from the card), floored at ``min_scale``."""
        sst = self.state.scaler_state
        new = max(float(sst.loss_scale) / 2.0, wd.min_scale)
        self.state = self.state._replace(
            scaler_state=sst._replace(loss_scale=new))

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self) -> str:
        """Save the current state under ``checkpoint_dir`` (the step
        number is ``state.step``); returns the checkpoint path."""
        from apex_tpu_torch.utils.checkpoint import save_train_state

        if self._ckpt_dir is None:
            raise ValueError("TrainLoop was built without checkpoint_dir")
        path = save_train_state(self._ckpt_dir, self.state,
                                self._train_step)
        self._checkpoints_saved += 1
        self._last_checkpoint_step = int(self.state.step)
        if self._obs is not None:
            self._obs.inc("checkpoints")
            self._obs.record("checkpoint",
                             step=self._last_checkpoint_step, path=path)
        return path

    def _maybe_checkpoint(self) -> None:
        if (self._ckpt_dir is None or self._ckpt_every <= 0
                or self._steps_dispatched % self._ckpt_every):
            return
        self.save_checkpoint()

    def stats(self, deep: bool = False) -> Dict[str, Any]:
        """The failure-path counters; ``deep`` adds the observer's section
        (``"observability"``) when one is attached."""
        out = {
            "steps_dispatched": self._steps_dispatched,
            "dispatch_retries": self._retries,
            "watchdog_nonfinite": self._watchdog_trips,
            "watchdog_skips": self._watchdog_skips,
            "watchdog_rescales": self._watchdog_rescales,
            "watchdog_halts": self._watchdog_halts,
            "checkpoints_saved": self._checkpoints_saved,
            "last_checkpoint_step": self._last_checkpoint_step,
        }
        if deep and self._obs is not None:
            out["observability"] = self._obs.deep_stats()
        return out
