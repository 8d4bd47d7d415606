"""NHWC BatchNorm with the fused residual add and ReLU (counterpart of
:mod:`apex_tpu.contrib.groupbn.batch_norm`, the MLPerf-ResNet "bnp"
module).

On ``(N, H, W, C)`` input, in fp32, output in x's dtype: the two-pass
batch ``mean``/``var`` (not SyncBatchNorm's one-pass formula), an
optional residual ``z`` added before the optional ReLU. With ``bn_group``
> 1 the statistics are shared within contiguous groups of ``bn_group``
ranks: ``(mean, mean of squares)`` averaged over the group, which assumes
every rank holds as many rows, through the differentiable all-reduce of
:mod:`apex_tpu_torch.utils.collectives`; the unbiased running variance
counts ``N * H * W * bn_group`` rows. Running statistics follow torch's
momentum. Plain PyTorch, as the JAX module is plain XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.utils.collectives import all_reduce_sum


def _bn_groups(bn_group: int):
    """The contiguous rank lists of ``bn_group`` ranks (the world size
    must be a multiple of it)."""
    if not dist.is_initialized():
        raise RuntimeError("bn_group > 1 shares statistics across ranks: "
                           "initialize torch.distributed first")
    world = dist.get_world_size()
    if world % bn_group:
        raise ValueError(f"world size ({world}) not divisible by bn_group "
                         f"({bn_group})")
    return [list(range(g * bn_group, (g + 1) * bn_group))
            for g in range(world // bn_group)]


class BatchNorm2d_NHWC(nn.Module):
    """``BatchNorm2d_NHWC(num_features, eps, momentum, fuse_relu,
    bn_group)``; ``forward(x, z=None)``, training mode normalizing with
    the batch's statistics, eval mode with the running ones."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, fuse_relu: bool = False,
                 bn_group: int = 1, device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.fuse_relu = fuse_relu
        self.bn_group = bn_group
        f32 = dict(device=resolve_device(device), dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def forward(self, x, z=None):
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 1, 2))
            var = xf.var(dim=(0, 1, 2), unbiased=False)
            if self.bn_group > 1:
                groups = _bn_groups(self.bn_group)
                c = self.num_features
                packed = all_reduce_sum(torch.cat([mean, var + mean * mean]),
                                        groups) / self.bn_group
                mean, mean_sq = packed[:c], packed[c:]
                var = mean_sq - mean * mean
            with torch.no_grad():
                m = self.momentum
                count = x.shape[0] * x.shape[1] * x.shape[2] * max(
                    self.bn_group, 1)
                unbiased = var * (count / max(count - 1, 1))
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        out = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.float() \
            + self.bias.float()
        if z is not None:
            out = out + z.float()            # bn_fused_add(_relu)
        if self.fuse_relu:
            out = F.relu(out)
        return out.to(x.dtype)
