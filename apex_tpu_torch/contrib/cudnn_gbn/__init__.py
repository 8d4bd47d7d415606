"""Contrib cudnn_gbn (counterpart of :mod:`apex_tpu.contrib.cudnn_gbn`):
the groupbn module under the reference's cudnn_gbn class name."""

from apex_tpu_torch.contrib.cudnn_gbn.batch_norm import GroupBatchNorm2d

__all__ = ["GroupBatchNorm2d"]
