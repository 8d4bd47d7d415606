"""Shared helpers for the port's kernel wrappers and entry points
(counterpart of :mod:`apex_tpu.ops._common`)."""

from __future__ import annotations

import torch

# the finite masked fill shared by every attention read: a dead key
# position scores FILL, not -inf, so a row with no visible key degrades
# to a uniform read instead of NaN (apex_tpu.ops.flash_attention.FILL)
FILL = -30000.0


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return (x + m - 1) // m * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    CUDA card. Without a CUDA device the default raises: the port never
    runs on the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")
