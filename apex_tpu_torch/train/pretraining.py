"""The BERT pretraining step of ``bench.py:build_step`` (amp + FusedLAMB),
on the port.

One step is, as the JAX bench runs it: the forward with dropout, the
loss scaled by the current loss scale and its backward (the gradients stay
scaled), ``FusedLAMB.step(grad_scale=loss_scale)``, which unscales inside
its own reads, returns the overflow flag and skips the step on overflow,
then the scaler update. The step owns the ``torch.Generator`` the model
draws its dropout seeds from.
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
                           seed: int = 0, device=None) -> dict:
    """Inputs in the MLPerf gathered-predictions format, drawn from
    ``seed`` exactly as ``bench.py:89-116`` draws them: random ids, one
    segment, no padding, P = 76 masked positions per row at S = 512 (15%
    of S otherwise), each row using between P/2 and P of them."""
    device = resolve_device(device)
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
        mlm, nsp = self.model(
            batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"], deterministic=self.deterministic,
            masked_positions=batch["masked_positions"],
            generator=self.generator)
        return pretraining_loss(mlm, nsp, batch["mlm_labels"],
                                batch["nsp_labels"], batch["mlm_weights"])

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
