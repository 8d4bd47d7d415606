"""Training (counterpart of :mod:`apex_tpu.train`): ``build_train_step``
with gradient accumulation, the deferred-metrics ``TrainLoop`` with its
retries, watchdog and checkpoints, the BERT pretraining step of
``bench.py``, and the GPT LM's loss function and batches."""

from apex_tpu_torch.train.lm import lm_loss_fn, make_lm_batch
from apex_tpu_torch.train.loop import (
    NonFiniteLossError,
    TrainLoop,
    WatchdogConfig,
)
from apex_tpu_torch.train.pretraining import (
    PretrainingStep,
    build_pretraining,
    make_pretraining_batch,
    pretraining_loss_fn,
)
from apex_tpu_torch.train.step import (
    TrainState,
    TrainStep,
    build_train_step,
)

__all__ = ["NonFiniteLossError", "PretrainingStep", "TrainLoop",
           "TrainState", "TrainStep", "WatchdogConfig", "build_pretraining",
           "build_train_step", "lm_loss_fn", "make_lm_batch",
           "make_pretraining_batch", "pretraining_loss_fn"]
