"""SyncBatchNorm: batch normalization with statistics over every rank
(counterpart of :mod:`apex_tpu.parallel.sync_batchnorm`).

Each rank sums its ``(sum, sumsq, count)`` in fp32, and ONE all-reduce of
the packed triple gives the statistics of the whole batch, from which the
mean and the one-pass variance ``sumsq / count - mean ** 2`` follow, as
in the JAX module. The all-reduce is differentiable: its backward sums
the packed cotangent over the same ranks (psum's transpose), so each
rank's ``dx`` is the gradient of the sum of every rank's loss, which is
the big-batch gradient. Running statistics take the unbiased variance,
with torch's momentum (``running = (1 - m) * running + m * batch``).

Channels are on axis 1 (NCHW) or, with ``channel_last``, on the last
axis. ``process_group`` is a list of rank lists (the JAX
``axis_index_groups``). Without an initialized ``torch.distributed`` the
module warns and uses this rank's statistics, as the JAX module does
outside ``shard_map``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.utils.collectives import all_reduce_sum


class SyncBatchNorm(nn.Module):
    """``apex.parallel.SyncBatchNorm``: parameters ``weight``/``bias``
    (``affine``, or ``use_scale``/``use_bias`` one by one), buffers
    ``running_mean``/``running_var`` (``track_running_stats``), all fp32.
    Training mode, or no running statistics, normalizes with the batch's
    statistics; eval mode with them uses the running ones."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 process_group=None, channel_last: bool = False,
                 use_scale: Optional[bool] = None,
                 use_bias: Optional[bool] = None, device=None):
        super().__init__()
        if momentum is None:
            raise ValueError("momentum=None (a cumulative average) is not "
                             "supported; pass a float")
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.track_running_stats = track_running_stats
        self.process_group = process_group
        self.channel_last = channel_last
        dev = resolve_device(device)
        use_scale = affine if use_scale is None else use_scale
        use_bias = affine if use_bias is None else use_bias
        f32 = dict(device=dev, dtype=torch.float32)
        self.weight = (nn.Parameter(torch.ones(num_features, **f32))
                       if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **f32))
                     if use_bias else None)
        if track_running_stats:
            self.register_buffer("running_mean",
                                 torch.zeros(num_features, **f32))
            self.register_buffer("running_var",
                                 torch.ones(num_features, **f32))
        else:
            self.running_mean = self.running_var = None

    def _batch_stats(self, xf, reduce_axes):
        nf = self.num_features
        local = torch.cat([
            xf.sum(reduce_axes), (xf * xf).sum(reduce_axes),
            torch.full((1,), xf.numel() // nf, dtype=torch.float32,
                       device=xf.device)])
        if dist.is_initialized():
            local = all_reduce_sum(local, self.process_group)
        else:
            warnings.warn(
                "SyncBatchNorm: torch.distributed is not initialized; "
                "normalizing with this process's batch statistics only",
                stacklevel=3)
        total_sum, total_sumsq, count = local[:nf], local[nf:2 * nf], local[-1]
        mean = total_sum / count
        # biased variance for the normalization (torch semantics)
        return mean, total_sumsq / count - mean * mean, count

    def forward(self, x):
        ch_axis = x.ndim - 1 if self.channel_last else min(1, x.ndim - 1)
        nf = self.num_features
        if x.shape[ch_axis] != nf:
            raise ValueError(f"expected {nf} channels on axis {ch_axis}, "
                             f"got shape {tuple(x.shape)}")
        reduce_axes = tuple(i for i in range(x.ndim) if i != ch_axis)
        xf = x.float()
        if self.training or not self.track_running_stats:
            mean, var, count = self._batch_stats(xf, reduce_axes)
            if self.training and self.track_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * count / torch.clamp(count - 1.0,
                                                         min=1.0)
                    self.running_mean.copy_(
                        (1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_(
                        (1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        shape = [1] * x.ndim
        shape[ch_axis] = nf
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + self.eps)
        if self.weight is not None:
            y = y * self.weight.float().reshape(shape)
        if self.bias is not None:
            y = y + self.bias.float().reshape(shape)
        return y.to(x.dtype)


def _convert(bn, process_group, channel_last):
    sync = SyncBatchNorm(
        bn.num_features, eps=bn.eps, momentum=bn.momentum,
        track_running_stats=bn.track_running_stats,
        process_group=process_group, channel_last=channel_last,
        use_scale=bn.weight is not None, use_bias=bn.bias is not None,
        device=(bn.weight.device if bn.weight is not None
                else bn.running_mean.device if bn.running_mean is not None
                else "cpu"))
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            src, dst = getattr(bn, name), getattr(sync, name)
            if src is not None:
                dst.copy_(src)
    sync.train(bn.training)
    return sync


def convert_syncbn_model(module: nn.Module, process_group=None,
                         channel_last: bool = False) -> nn.Module:
    """Replace every ``torch.nn`` BatchNorm (``_BatchNorm``: BatchNorm1d/
    2d/3d and torch's own SyncBatchNorm) in ``module``'s tree with a
    :class:`SyncBatchNorm` that holds its weights and running statistics;
    returns the module (the new one if ``module`` itself is a BatchNorm).
    Warns when the tree holds none, as the JAX version does."""
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return _convert(module, process_group, channel_last)
    converted = 0
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.modules.batchnorm._BatchNorm):
                setattr(parent, name,
                        _convert(child, process_group, channel_last))
                converted += 1
    if converted == 0:
        warnings.warn("convert_syncbn_model found no torch.nn BatchNorm in "
                      "this module's tree; nothing was converted",
                      stacklevel=2)
    return module
