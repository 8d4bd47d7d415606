"""Transformer enums (counterpart of :mod:`apex_tpu.transformer.enums`).

``AttnMaskType`` is defined beside the fused softmax it configures and
re-exported here; the rest are the structural selectors model builders
switch on."""

from __future__ import annotations

import enum

from apex_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    AttnMaskType,
)


class ModelType(enum.Enum):
    encoder_or_decoder = 1
    encoder_and_decoder = 2


class LayerType(enum.Enum):
    encoder = 1
    decoder = 2


class AttnType(enum.Enum):
    self_attn = 1
    cross_attn = 2
