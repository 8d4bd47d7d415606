"""Model-side dropout plumbing (counterpart of
:mod:`apex_tpu.models._dropout`).

Seeds are host ints drawn from an explicit ``torch.Generator`` that the
training step owns. A model draws all of a forward's seeds before its
checkpointed layers run and hands each layer its own: a seed drawn inside
a recomputed layer would be drawn again on recompute, and
``torch.utils.checkpoint``'s ``preserve_rng_state`` covers only the
global generators, so the backward would replay a different mask.

Under tensor parallelism every rank draws the same seeds. A site whose
activation differs across the tensor-parallel ranks (``tp_varying``: the
attention probabilities and flash's fused dropout, whose heads are split,
and hidden dropout under sequence parallelism, whose tokens are split)
folds this rank's tensor-parallel rank into its seed
(:func:`tp_seed`), so the ranks' masks differ; a site on replicated
activations (hidden dropout under plain tensor parallelism) keeps the
seed, so every rank applies the same mask. The JAX module folds the rank
into a threefry key; the port's fold is its own rule on int seeds
(``tensor_parallel.random.fold_seed``, ROADMAP C12).
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


def tp_seed(seed, tp_varying: bool):
    """The seed a site uses: ``seed`` with the tensor-parallel rank folded
    in when the site's activation differs across the ranks."""
    if seed is None or not tp_varying:
        return seed
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        model_parallel_seed,
    )

    return model_parallel_seed(seed)


def unfused_dropout(x, rate: float, seed: int):
    """The stock dropout of ``fused=False``: a keep mask of uniforms from
    a torch generator on ``x``'s device seeded by ``seed`` (so a
    recompute replays it), kept values scaled by ``1 / (1 - rate)``."""
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TPDropout(nn.Module):
    """Dropout at one site, its seed given by the caller: the fused kernel
    (B3 on the card), or with ``fused=False`` :func:`unfused_dropout`;
    ``tp_varying`` folds the tensor-parallel rank into the seed
    (:func:`tp_seed`)."""

    def __init__(self, rate: float, fused: bool = True,
                 tp_varying: bool = False):
        super().__init__()
        self.rate = rate
        self.fused = fused
        self.tp_varying = tp_varying

    def forward(self, x, seed=None, deterministic: bool = True):
        if deterministic or self.rate == 0.0:
            return x
        seed = tp_seed(seed, self.tp_varying)
        if not self.fused:
            return unfused_dropout(x, self.rate, seed)
        return fused_dropout(x, self.rate, seed)
