"""The ResNet bottleneck block on NHWC tensors (counterpart of
:class:`apex_tpu.contrib.bottleneck.Bottleneck`).

1x1 -> 3x3 (the stride) -> 1x1 convolutions, each followed by
:class:`~apex_tpu_torch.contrib.groupbn.BatchNorm2d_NHWC` (ReLU fused on
the first two; the third adds the residual before its ReLU), and a 1x1
strided projection with its BatchNorm where the stride or the width
changes. The block takes and returns ``(N, H, W, C)`` tensors; each
convolution runs on the ``channels_last`` NCHW view of one, with weights
in ``channels_last``, so cuDNN takes its NHWC kernels and no transpose is
copied. The 3x3 pads as flax's ``padding="SAME"`` does, which at stride 2
on an even size is 0 rows before and 1 after (not torch's symmetric
``padding=1``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.ops._common import resolve_device

# flax's truncated-normal initializers divide the standard deviation by
# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def he_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``he_normal`` (variance 2 / fan_in, truncated at 2 standard
    deviations) on an OIHW weight."""
    fan_in = weight[0].numel()
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def make_conv(cin, cout, kernel, stride=1, padding=0, generator=None):
    """A bias-free ``nn.Conv2d`` on the CPU, he_normal from
    ``generator``."""
    conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False,
                     device="cpu")
    he_normal_(conv.weight, generator)
    return conv


def same_pad(size: int, kernel: int, stride: int):
    """flax ``"SAME"`` padding ``(before, after)`` of one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor,
              same: bool = False) -> torch.Tensor:
    """``conv`` on an NHWC tensor through its ``channels_last`` NCHW
    view; ``same`` pads as flax's ``"SAME"`` (else the conv's own)."""
    y = x.permute(0, 3, 1, 2)
    if same:
        k, s = conv.kernel_size[0], conv.stride[0]
        top, bottom = same_pad(y.shape[2], k, s)
        left, right = same_pad(y.shape[3], k, s)
        y = F.pad(y, (left, right, top, bottom))
    return conv(y).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """``Bottleneck(in_channels, bottleneck_channels, out_channels,
    stride)``; ``use_cudnn`` is accepted for the reference's signature
    (the convolutions are cuDNN's on the card); ``bn_group`` shares the
    BatchNorm statistics over groups of ranks. Weights are drawn from
    ``generator`` on the CPU, then moved to ``device``."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, use_cudnn: bool = False,
                 bn_group: int = 1, device=None, generator=None):
        super().__init__()
        mid = bottleneck_channels

        def bn(ch, relu):
            return BatchNorm2d_NHWC(ch, fuse_relu=relu, bn_group=bn_group,
                                    device="cpu")

        self.conv1 = make_conv(in_channels, mid, 1, generator=generator)
        self.bn1 = bn(mid, True)
        self.conv2 = make_conv(mid, mid, 3, stride, generator=generator)
        self.bn2 = bn(mid, True)
        self.conv3 = make_conv(mid, out_channels, 1, generator=generator)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_channels != out_channels:
            self.downsample_conv = make_conv(in_channels, out_channels, 1,
                                             stride, generator=generator)
            self.downsample_bn = bn(out_channels, False)
        self.bn3 = bn(out_channels, True)
        self.to(resolve_device(device), memory_format=torch.channels_last)

    def forward(self, x):
        residual = x
        y = self.bn1(conv_nhwc(self.conv1, x))
        y = self.bn2(conv_nhwc(self.conv2, y, same=True))
        y = conv_nhwc(self.conv3, y)
        if self.downsample_conv is not None:
            residual = self.downsample_bn(
                conv_nhwc(self.downsample_conv, x))
        return self.bn3(y, z=residual)
