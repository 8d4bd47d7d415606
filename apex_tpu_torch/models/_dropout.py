"""Model-side dropout plumbing (counterpart of
:mod:`apex_tpu.models._dropout`, without the tensor-parallel fold).

Seeds are host ints drawn from an explicit ``torch.Generator`` that the
training step owns. A model draws all of a forward's seeds before its
checkpointed layers run and hands each layer its own: a seed drawn inside
a recomputed layer would be drawn again on recompute, and
``torch.utils.checkpoint``'s ``preserve_rng_state`` covers only the
global generators, so the backward would replay a different mask.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.ops.dropout import fused_dropout

SEED_HIGH = 2 ** 31 - 1   # seeds are drawn from [0, 2^31 - 1), as in JAX


def dropout_seeds(generator: torch.Generator, n: int) -> list:
    """``n`` int seeds for the fused dropout sites of one forward."""
    return torch.randint(0, SEED_HIGH, (n,), generator=generator).tolist()


def dropout_seed(generator: torch.Generator) -> int:
    """One int seed for a fused dropout site."""
    return dropout_seeds(generator, 1)[0]


def unfused_dropout(x, rate: float, seed: int):
    """The stock dropout of ``fused=False``: a keep mask of uniforms from
    a torch generator on ``x``'s device seeded by ``seed`` (so a
    recompute replays it), kept values scaled by ``1 / (1 - rate)``."""
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TPDropout(nn.Module):
    """Dropout at one site, its seed given by the caller: the fused kernel
    (B3 on the card), or with ``fused=False`` :func:`unfused_dropout`. The
    tensor-parallel fold of the JAX module is not ported (tensor
    parallelism is a later slice)."""

    def __init__(self, rate: float, fused: bool = True):
        super().__init__()
        self.rate = rate
        self.fused = fused

    def forward(self, x, seed=None, deterministic: bool = True):
        if deterministic or self.rate == 0.0:
            return x
        if not self.fused:
            return unfused_dropout(x, self.rate, seed)
        return fused_dropout(x, self.rate, seed)
