"""What ``build_train_step`` needs to train the GPT causal LM: its
``loss_fn(microbatch, generator)`` and batches of random token ids (no
dataset: the ids are drawn from a seed)."""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig, lm_loss
from apex_tpu_torch.ops._common import resolve_device


def make_lm_batch(cfg: GPTConfig, batch: int, seq: int, seed: int = 0,
                  device=None, accum_steps=None) -> dict:
    """``{"input_ids": [batch, seq]}`` uniform over the vocabulary from
    ``seed`` (numpy); with ``accum_steps = N`` it draws ``N * batch`` rows
    shaped ``[N, batch, seq]``, microbatch by microbatch."""
    device = resolve_device(device)
    rows = batch * (accum_steps or 1)
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (rows, seq))
    ids = torch.as_tensor(ids, dtype=torch.int64, device=device)
    if accum_steps is not None:
        ids = ids.reshape(accum_steps, batch, seq)
    return {"input_ids": ids}


def lm_loss_fn(model, deterministic: bool = False):
    """``loss_fn(microbatch, generator)`` for ``build_train_step``: the
    next-token loss of the model on its own ids, dropout seeds drawn from
    ``generator``."""

    def loss_fn(mb, generator):
        ids = mb["input_ids"]
        return lm_loss(model(ids, deterministic=deterministic,
                             generator=generator), ids)

    return loss_fn
