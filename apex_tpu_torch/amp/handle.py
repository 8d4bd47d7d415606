"""The amp handle: scalers, the O1 autocast context, ``scale_loss``,
``update_scale`` and the checkpoint surface (counterpart of
:mod:`apex_tpu.amp.handle`)."""

from __future__ import annotations

from typing import List

from apex_tpu_torch.amp.autocast import autocast
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState


class AmpHandle:
    def __init__(self, properties, scalers: List[LossScaler],
                 cast_ctx: autocast):
        self._properties = properties
        self.scalers = scalers
        self.autocast = cast_ctx
        # the last state of each scaler, for state_dict()
        self.scaler_states = [s.init() for s in scalers]

    @property
    def opt_level(self):
        return self._properties.opt_level

    @property
    def properties(self):
        return self._properties

    def init_state(self, loss_id: int = 0) -> ScalerState:
        return self.scalers[loss_id].init()

    def scaler(self, loss_id: int = 0) -> LossScaler:
        return self.scalers[loss_id]

    def traced(self, loss_fn):
        """``loss_fn`` run under :attr:`autocast` when this opt level
        patches functions (O1), else unchanged: what a step builder calls
        its loss through."""

        def traced(*args, **kwargs):
            if self._properties.patch_torch_functions:
                with self.autocast:
                    return loss_fn(*args, **kwargs)
            return loss_fn(*args, **kwargs)

        return traced

    def scale_loss(self, loss, state: ScalerState, loss_id: int = 0):
        """The scaled loss to call ``backward()`` on; its gradients stay
        scaled (the optimizer unscales them in its own reads)."""
        return self.scalers[loss_id].scale(loss, state)

    def update_scale(self, state: ScalerState, found_inf,
                     loss_id: int = 0) -> ScalerState:
        new = self.scalers[loss_id].update(state, found_inf)
        self.scaler_states[loss_id] = new
        return new

    def state_dict(self):
        return {f"loss_scaler{i}": st._asdict()
                for i, st in enumerate(self.scaler_states)}

    def load_state_dict(self, state_dict):
        for i, scaler in enumerate(self.scalers):
            entry = state_dict[f"loss_scaler{i}"]
            self.scaler_states[i] = ScalerState(
                float(entry["loss_scale"]), int(entry["unskipped"]),
                int(entry.get("steps_skipped", 0)),
                int(entry.get("hysteresis", scaler.hysteresis)))
