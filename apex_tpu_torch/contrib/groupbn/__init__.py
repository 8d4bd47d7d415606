"""Contrib groupbn (counterpart of :mod:`apex_tpu.contrib.groupbn`)."""

from apex_tpu_torch.contrib.groupbn.batch_norm import BatchNorm2d_NHWC

__all__ = ["BatchNorm2d_NHWC"]
