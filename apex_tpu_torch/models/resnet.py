"""ResNet on NHWC tensors, the MLPerf-ResNet family (counterpart of
:mod:`apex_tpu.models.resnet`; BASELINE configs[3], DDP + SyncBatchNorm
on ResNet-50).

A 7x7/2 stem convolution (padding 3), ``bn_stem`` with ReLU, a 3x3/2
max-pool (padding 1, padded with -inf as flax pads), the bottleneck
stages (:class:`~apex_tpu_torch.contrib.bottleneck.Bottleneck`; the first
block of every stage after the first has stride 2), the global mean over
H and W and ``fc``. Module names are the JAX module's (``conv_stem``,
``bn_stem``, ``stage{s}_block{b}.{conv1,bn1,...}``, ``fc``), which amp's
keep-fp32 filter matches as the JAX package's does: under O2 every
BatchNorm's parameters and running statistics stay fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.contrib.bottleneck import Bottleneck
from apex_tpu_torch.contrib.bottleneck.bottleneck import conv_nhwc, make_conv
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.ops._common import resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    # blocks per stage; (3, 4, 6, 3) = ResNet-50
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    bn_group: int = 1                 # ranks sharing BatchNorm statistics

    @staticmethod
    def resnet50(**kw):
        return ResNetConfig(**kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("num_classes", 10)
        kw.setdefault("stage_sizes", (1, 1))
        kw.setdefault("width", 16)
        return ResNetConfig(**kw)


class ResNet(nn.Module):
    """Bottleneck ResNet over ``(N, H, W, 3)`` images; weights from
    ``seed`` (he_normal convolutions, BatchNorm 1 and 0, ``fc`` 0, as the
    JAX module initializes them)."""

    def __init__(self, cfg: ResNetConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        w = cfg.width
        self.conv_stem = make_conv(3, w, 7, 2, 3, generator=g)
        self.bn_stem = BatchNorm2d_NHWC(w, fuse_relu=True,
                                        bn_group=cfg.bn_group, device="cpu")
        in_ch = w
        for stage, blocks in enumerate(cfg.stage_sizes):
            mid_ch = w * 2 ** stage
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                self.add_module(f"stage{stage}_block{b}", Bottleneck(
                    in_ch, mid_ch, mid_ch * 4, stride=stride,
                    bn_group=cfg.bn_group, device="cpu", generator=g))
                in_ch = mid_ch * 4
        self.fc = nn.Linear(in_ch, cfg.num_classes, device="cpu")
        nn.init.zeros_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)
        self.to(resolve_device(device), memory_format=torch.channels_last)

    def blocks(self):
        return [getattr(self, f"stage{s}_block{b}")
                for s, n in enumerate(self.cfg.stage_sizes)
                for b in range(n)]

    def forward(self, x):
        x = self.bn_stem(conv_nhwc(self.conv_stem, x))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for block in self.blocks():
            x = block(x)
        return self.fc(x.mean(dim=(1, 2)))


def _walk(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, path + (key,))
        else:
            yield path + (key,), val


def _port_leaf(path, arr):
    """(port name, tensor) of one flax leaf: an HWIO conv kernel becomes
    an OIHW weight, the ``fc`` kernel is transposed."""
    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    *mods, leaf = path
    if leaf == "kernel":
        t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
        return ".".join(mods + ["weight"]), t.contiguous()
    return ".".join(path), t


def load_jax_trees(module: nn.Module, params_np, batch_stats_np) -> None:
    """Copy a flax module's ``params`` and ``batch_stats`` trees (numpy
    arrays) into ``module`` (a ResNet, or one of its blocks) in place.
    Every parameter and buffer must be covered and every leaf must have a
    port counterpart."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    seen = set()
    with torch.no_grad():
        for tree in (params_np, batch_stats_np):
            for path, arr in _walk(tree):
                name, t = _port_leaf(list(path), arr)
                if name not in own:
                    raise KeyError(f"load_jax_params: no port parameter or "
                                   f"buffer for {'/'.join(path)} ({name})")
                if own[name].shape != t.shape:
                    raise ValueError(
                        f"load_jax_params: {name} is "
                        f"{tuple(own[name].shape)}, the JAX leaf "
                        f"{tuple(t.shape)}")
                own[name].copy_(t)
                seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"load_jax_params: the trees lack {missing}")


def load_jax_params(params_np, batch_stats_np, cfg: ResNetConfig,
                    device=None) -> ResNet:
    """The port's model from a JAX ``ResNet``'s ``params`` and
    ``batch_stats`` trees as numpy arrays (:func:`load_jax_trees`)."""
    model = ResNet(cfg, device="cpu")
    load_jax_trees(model, params_np, batch_stats_np)
    return model.to(resolve_device(device), memory_format=torch.channels_last)
