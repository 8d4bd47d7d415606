"""Contrib bottleneck (counterpart of :mod:`apex_tpu.contrib.bottleneck`;
``Bottleneck`` only: the spatial-parallel ``HaloExchanger1d`` and
``SpatialBottleneck`` are not ported yet, ROADMAP A.4 item 20)."""

from apex_tpu_torch.contrib.bottleneck.bottleneck import Bottleneck

__all__ = ["Bottleneck"]
