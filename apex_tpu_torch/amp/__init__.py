"""Mixed precision: opt levels O0-O3, ``initialize``, O1's casts of listed
functions and the dynamic loss scaler (counterpart of
:mod:`apex_tpu.amp`)."""

from apex_tpu_torch.amp import _amp_state as _amp_state_mod
from apex_tpu_torch.amp._amp_state import maybe_print, set_verbosity
from apex_tpu_torch.amp.autocast import (
    autocast,
    float_function,
    half_function,
    promote_function,
)
from apex_tpu_torch.amp.frontend import (
    Properties,
    cast_model,
    initialize,
    opt_levels,
)
from apex_tpu_torch.amp.handle import AmpHandle
from apex_tpu_torch.amp.scaler import (
    DynamicLossScaler,
    LossScaler,
    ScalerState,
)

__all__ = [
    "AmpHandle",
    "DynamicLossScaler",
    "LossScaler",
    "Properties",
    "ScalerState",
    "autocast",
    "cast_model",
    "float_function",
    "half_function",
    "initialize",
    "load_state_dict",
    "master_params",
    "maybe_print",
    "opt_levels",
    "promote_function",
    "scale_loss",
    "set_verbosity",
    "state_dict",
]


def _current_handle() -> AmpHandle:
    h = _amp_state_mod._amp_state.handle
    if h is None:
        raise RuntimeError(
            "Invoked amp function before calling amp.initialize()")
    return h


def scale_loss(loss, state, loss_id: int = 0):
    """``amp.scale_loss`` of the handle the last :func:`initialize`
    returned."""
    return _current_handle().scale_loss(loss, state, loss_id)


def state_dict():
    """``amp.state_dict()`` of the last handle."""
    return _current_handle().state_dict()


def load_state_dict(sd):
    """``amp.load_state_dict()`` into the last handle."""
    return _current_handle().load_state_dict(sd)


def master_params(optimizer):
    """The fp32 master params a port ``Fused*`` optimizer holds, in
    ``param_groups`` order (``amp.master_params(optimizer)``, for
    clipping on the masters); none without master weights (O0, O1) or
    before the first step makes them."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            master = optimizer.state[p].get("master")
            if master is not None:
                yield master
