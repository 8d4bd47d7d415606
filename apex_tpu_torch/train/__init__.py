"""Training steps (counterpart of :mod:`apex_tpu.train`): the BERT
pretraining step so far; ``build_train_step`` is not ported yet."""

from apex_tpu_torch.train.pretraining import (
    PretrainingStep,
    build_pretraining,
    make_pretraining_batch,
)

__all__ = ["PretrainingStep", "build_pretraining", "make_pretraining_batch"]
