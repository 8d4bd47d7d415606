"""Dynamic loss scaling (counterpart of :mod:`apex_tpu.amp.scaler`).

The contract constants are the reference's: initial dynamic scale 2^16,
divide by 2 on overflow, multiply by 2 after 2000 consecutive clean
steps, ceiling 2^24, optional floor, hysteresis 1. The state is host
numbers: the overflow flag comes from the optimizer's own global-norm
reduction (``FusedLAMB.step(grad_scale=...)``), read once per step, and
the update runs on the host, where it prints the reference's overflow
line.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

from apex_tpu_torch.amp._amp_state import maybe_print


class ScalerState(NamedTuple):
    loss_scale: float
    unskipped: int = 0       # consecutive overflow-free steps
    steps_skipped: int = 0   # lifetime skipped-step count
    hysteresis: int = 1      # overflows left before the scale backs off


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Static loss-scaler configuration; ``loss_scale="dynamic"`` is the
    reference's dynamic scaler, a float a static scale."""

    loss_scale: Union[str, float] = "dynamic"
    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_seq_len: int = 2000
    min_loss_scale: Optional[float] = None
    max_loss_scale: float = 2.0 ** 24
    loss_id: int = 0
    hysteresis: int = 1

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == "dynamic"

    def init(self) -> ScalerState:
        scale = self.init_scale if self.dynamic else float(self.loss_scale)
        return ScalerState(float(scale), 0, 0, self.hysteresis)

    def scale(self, loss, state: ScalerState):
        """The loss times the current scale."""
        return loss * state.loss_scale

    def update(self, state: ScalerState, found_inf: bool) -> ScalerState:
        """Advance the state given this step's overflow flag."""
        found_inf = bool(found_inf)
        skipped = state.steps_skipped + int(found_inf)
        if not self.dynamic:
            if found_inf:
                maybe_print("Gradient overflow.  Skipping step, loss scaler "
                            f"{self.loss_id} static loss scale "
                            f"{state.loss_scale} unchanged")
            return state._replace(steps_skipped=skipped)
        if found_inf:
            hys = max(state.hysteresis - 1, 0)
            if hys <= 0:
                floor = (self.min_loss_scale
                         if self.min_loss_scale is not None else 0.0)
                scale = max(state.loss_scale / self.scale_factor, floor)
                maybe_print("Gradient overflow.  Skipping step, loss scaler "
                            f"{self.loss_id} reducing loss scale to {scale}")
            else:
                scale = state.loss_scale
                maybe_print("Gradient overflow.  Skipping step, loss scaler "
                            f"{self.loss_id} hysteresis holding loss scale "
                            f"at {scale}")
            return ScalerState(scale, 0, skipped, hys)
        unskipped = state.unskipped + 1
        scale = state.loss_scale
        if unskipped >= self.scale_seq_len:
            scale = min(scale * self.scale_factor, self.max_loss_scale)
            unskipped = 0
        return ScalerState(scale, unskipped, skipped, self.hysteresis)


DynamicLossScaler = LossScaler
