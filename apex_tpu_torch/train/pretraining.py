"""The BERT pretraining step of ``bench.py:build_step`` (amp + FusedLAMB),
on the port, and the pieces ``build_train_step`` needs to train BERT.

One ``PretrainingStep`` is, as the JAX bench runs it: the forward with
dropout, the loss scaled by the current loss scale and its backward (the
gradients stay scaled), ``FusedLAMB.step(grad_scale=loss_scale)``, which
unscales inside its own reads, returns the overflow flag and skips the
step on overflow, then the scaler update. The step owns the
``torch.Generator`` the model draws its dropout seeds from.

``pretraining_loss_fn(model)`` is the ``loss_fn(microbatch, generator)``
of :func:`apex_tpu_torch.train.build_train_step`, and
``make_pretraining_batch(..., accum_steps=N)`` gives its
``[N, B, ...]`` batches.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    pretraining_loss,
)
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.optimizers import FusedLAMB


def make_pretraining_batch(cfg: BertConfig, batch: int, seq: int,
                           seed: int = 0, device=None,
                           accum_steps=None) -> dict:
    """Inputs in the MLPerf gathered-predictions format, drawn from
    ``seed`` exactly as ``bench.py:89-116`` draws them: random ids, one
    segment, no padding, P = 76 masked positions per row at S = 512 (15%
    of S otherwise), each row using between P/2 and P of them. With
    ``accum_steps = N`` it draws ``N * batch`` rows and shapes every
    leaf ``[N, batch, ...]``, microbatch by microbatch."""
    device = resolve_device(device)
    if accum_steps is not None:
        full = make_pretraining_batch(cfg, accum_steps * batch, seq, seed,
                                      device)
        return {k: v.reshape(accum_steps, batch, *v.shape[1:])
                for k, v in full.items()}
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq))
    n_pred = max(int(seq * 0.15), 2)
    if seq == 512:
        n_pred = 76
    pos = np.zeros((batch, n_pred), np.int32)
    lab = np.zeros((batch, n_pred), np.int32)
    wgt = np.zeros((batch, n_pred), np.float32)
    for b in range(batch):
        chosen = rng.choice(seq, size=rng.randint(max(n_pred // 2, 1),
                                                  n_pred + 1),
                            replace=False)
        chosen.sort()
        pos[b, :len(chosen)] = chosen
        lab[b, :len(chosen)] = rng.randint(0, cfg.vocab_size, len(chosen))
        wgt[b, :len(chosen)] = 1.0
    nsp = rng.randint(0, 2, (batch,))

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return {"input_ids": t(ids), "token_type_ids": t(np.zeros_like(ids)),
            "attention_mask": t(np.ones_like(ids)), "masked_positions": t(pos),
            "mlm_labels": t(lab), "mlm_weights": t(wgt, torch.float32),
            "nsp_labels": t(nsp)}


def pretraining_loss_fn(model, deterministic: bool = False):
    """``loss_fn(microbatch, generator)`` for ``build_train_step``: the
    model's pretraining loss on one microbatch, its dropout seeds drawn
    from ``generator``."""

    def loss_fn(mb, generator):
        mlm, nsp = model(mb["input_ids"], mb["token_type_ids"],
                         mb["attention_mask"], deterministic=deterministic,
                         masked_positions=mb["masked_positions"],
                         generator=generator)
        return pretraining_loss(mlm, nsp, mb["mlm_labels"],
                                mb["nsp_labels"], mb["mlm_weights"])

    return loss_fn


class PretrainingStep:
    """Callable one-step trainer: ``step(batch) -> (loss, found_inf)``
    with ``loss`` the unscaled loss (a device scalar) and ``found_inf``
    whether the step overflowed and was skipped."""

    def __init__(self, model, optimizer, handle, seed: int = 0,
                 deterministic: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.handle = handle
        self.scaler_state = handle.init_state()
        self.deterministic = deterministic
        # dropout seeds come from this generator, outside any checkpoint
        self.generator = torch.Generator().manual_seed(seed)

    def loss(self, batch):
        return pretraining_loss_fn(self.model, self.deterministic)(
            batch, self.generator)

    def __call__(self, batch):
        sst = self.scaler_state
        self.optimizer.zero_grad()
        loss = self.loss(batch)
        self.handle.scale_loss(loss, sst).backward()
        found_inf = self.optimizer.step(grad_scale=sst.loss_scale)
        self.scaler_state = self.handle.update_scale(sst, found_inf)
        return loss.detach(), found_inf


def build_pretraining(cfg: BertConfig, opt_level: str = "O2",
                      lr: float = 1e-4, weight_decay: float = 0.01,
                      seed: int = 0, device=None) -> PretrainingStep:
    """The model (weights from ``seed``), FusedLAMB and amp, in the JAX
    bench's order: the optimizer is built on the fp32 model, then
    ``amp.initialize`` casts the model and turns on master weights."""
    device = resolve_device(device)
    model = BertForPreTraining(cfg, device=device, seed=seed)
    opt = FusedLAMB(model.parameters(), lr=lr, weight_decay=weight_decay)
    model, opt, handle = amp.initialize(model, opt, opt_level=opt_level,
                                        verbosity=0, device=device)
    return PretrainingStep(model, opt, handle, seed=seed)
