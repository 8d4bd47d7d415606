"""Opt-level properties and ``amp.initialize`` (counterpart of
:mod:`apex_tpu.amp.frontend`).

The O0-O3 ``Properties`` table is the reference's; explicit keyword
arguments override the level's defaults. The low-precision type defaults
to bfloat16. ``initialize`` moves the model to its device (the CUDA card
unless the caller asks for the CPU), casts it in place (parameter objects
keep their identity, so an optimizer built on them stays valid), and
turns on the optimizer's fp32 master weights where the level asks for
them; the masters are made from the already-cast params at the first
step, in the JAX package's order. O1 keeps the model in fp32 without
master weights and with a dynamic scaler; the handle's ``autocast``
casts the listed functions (:mod:`apex_tpu_torch.amp.autocast`) wherever
the loss runs under it (``handle.traced(loss_fn)``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Union

import torch

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.autocast import autocast
from apex_tpu_torch.amp.handle import AmpHandle
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.ops._common import resolve_device


@dataclasses.dataclass
class Properties:
    opt_level: str = "O0"
    cast_model_type: Optional[Any] = None
    patch_torch_functions: bool = False
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Union[str, float] = 1.0
    enabled: bool = True

    @property
    def compute_dtype(self):
        """The whitelist's dtype under O1: the model's cast type, else
        bfloat16."""
        return self.cast_model_type or torch.bfloat16


class O0:
    brief = "O0: Pure fp32 training."

    def __call__(self, p: Properties) -> Properties:
        p.opt_level, p.cast_model_type = "O0", torch.float32
        p.patch_torch_functions, p.keep_batchnorm_fp32 = False, None
        p.master_weights, p.loss_scale = False, 1.0
        return p


class O1:
    brief = ("O1: Insert automatic casts around safe-to-low-precision "
             "functions.")

    def __call__(self, p: Properties) -> Properties:
        p.opt_level, p.cast_model_type = "O1", None
        p.patch_torch_functions, p.keep_batchnorm_fp32 = True, None
        p.master_weights, p.loss_scale = None, "dynamic"
        return p


class O2:
    brief = ("O2: Cast the model to the compute dtype, keep norms in fp32, "
             "use fp32 master weights.")

    def __call__(self, p: Properties) -> Properties:
        p.opt_level, p.cast_model_type = "O2", torch.bfloat16
        p.patch_torch_functions, p.keep_batchnorm_fp32 = False, True
        p.master_weights, p.loss_scale = True, "dynamic"
        return p


class O3:
    brief = "O3: Pure low-precision training."

    def __call__(self, p: Properties) -> Properties:
        p.opt_level, p.cast_model_type = "O3", torch.bfloat16
        p.patch_torch_functions, p.keep_batchnorm_fp32 = False, False
        p.master_weights, p.loss_scale = False, 1.0
        return p


opt_levels = {"O0": O0(), "O1": O1(), "O2": O2(), "O3": O3()}

# properties each opt level refuses to override (the reference's)
_DISALLOWED = {"O0": {"loss_scale": {"dynamic"}}}

# Parameter names kept fp32 under keep_batchnorm_fp32: normalization
# segments (*norm, bn, ln, *_ln), the JAX package's _NORM_RE.
_NORM_RE = re.compile(
    r"(?i)(batch|layer|group|rms|sync)?[_]?norm"
    r"|(^|[._/])bn\d*($|[._/])"
    r"|(^|[._/])ln\d*($|[._/])|_ln\d*($|[._/])"
)


def _default_norm_filter(name: str) -> bool:
    return bool(_NORM_RE.search(name))


def cast_model(model, dtype, keep_fp32_filter: Optional[Callable] = None):
    """Cast floating parameters and buffers to ``dtype`` in place, keeping
    those whose name matches ``keep_fp32_filter`` in fp32."""
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if not t.is_floating_point():
                continue
            keep = keep_fp32_filter is not None and keep_fp32_filter(name)
            t.data = t.data.to(torch.float32 if keep else dtype)
    return model


def initialize(model, optimizers=None, opt_level: str = "O1",
               enabled: bool = True, cast_model_type=None,
               patch_torch_functions: Optional[bool] = None,
               keep_batchnorm_fp32: Optional[bool] = None,
               master_weights: Optional[bool] = None,
               loss_scale: Union[str, float, None] = None,
               num_losses: int = 1, verbosity: int = 1,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24,
               keep_fp32_filter: Optional[Callable[[str], bool]] = None,
               device=None):
    """Returns ``(model, optimizers, handle)``; see the module docstring."""
    _amp_state.set_verbosity(verbosity)
    if opt_level not in opt_levels:
        raise ValueError(f"Unexpected optimization level {opt_level}. "
                         f"Options are 'O0', 'O1', 'O2', 'O3'.")
    props = opt_levels[opt_level](Properties())
    props.enabled = enabled
    _amp_state.maybe_print(f"Selected optimization level {opt_level}")
    _amp_state.maybe_print(opt_levels[opt_level].brief)
    for name, value in (("cast_model_type", cast_model_type),
                        ("patch_torch_functions", patch_torch_functions),
                        ("keep_batchnorm_fp32", keep_batchnorm_fp32),
                        ("master_weights", master_weights),
                        ("loss_scale", loss_scale)):
        if value is not None:
            bad = _DISALLOWED.get(opt_level, {}).get(name)
            if bad and value in bad:
                raise ValueError(f"Currently, {name}={value!r} is not "
                                 f"supported with opt_level={opt_level}")
            setattr(props, name, value)
    model.to(resolve_device(device))
    if not enabled:
        # as if amp were absent, with the API intact: a unity static scale
        props.patch_torch_functions = False
        handle = AmpHandle(props, [LossScaler(loss_scale=1.0, loss_id=i)
                                   for i in range(num_losses)],
                           autocast(enabled=False))
        _amp_state._amp_state.handle = handle
        return model, optimizers, handle
    if props.cast_model_type not in (None, torch.float32):
        norm_filter = None
        if props.keep_batchnorm_fp32:
            norm_filter = keep_fp32_filter or _default_norm_filter
        cast_model(model, props.cast_model_type, norm_filter)
    elif props.cast_model_type == torch.float32:
        cast_model(model, torch.float32)
    scalers = [LossScaler(loss_scale=props.loss_scale,
                          min_loss_scale=min_loss_scale,
                          max_loss_scale=max_loss_scale, loss_id=i)
               for i in range(num_losses)]
    single = not isinstance(optimizers, (list, tuple))
    for opt in ([optimizers] if single else optimizers):
        if opt is not None and props.master_weights:
            opt.set_master_weights(True)
    handle = AmpHandle(props, scalers,
                       autocast(compute_dtype=props.compute_dtype,
                                enabled=props.patch_torch_functions))
    _amp_state._amp_state.handle = handle
    return model, optimizers, handle
