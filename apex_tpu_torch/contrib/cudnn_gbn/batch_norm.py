"""``GroupBatchNorm2d`` (counterpart of
:mod:`apex_tpu.contrib.cudnn_gbn.batch_norm`): a factory with the
reference's positional signature ``(num_features, group_size)`` that
returns the groupbn module implementing it."""

from apex_tpu_torch.contrib.groupbn.batch_norm import BatchNorm2d_NHWC


def GroupBatchNorm2d(num_features: int, group_size: int = 1, *,
                     eps: float = 1e-5, momentum: float = 0.1,
                     fuse_relu: bool = False,
                     device=None) -> BatchNorm2d_NHWC:
    """NHWC BatchNorm with statistics shared over ``group_size``-rank
    groups."""
    return BatchNorm2d_NHWC(num_features, eps=eps, momentum=momentum,
                            fuse_relu=fuse_relu, bn_group=group_size,
                            device=device)
