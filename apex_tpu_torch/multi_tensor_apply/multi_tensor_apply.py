"""The ``multi_tensor_applier`` dispatch surface (counterpart of
:mod:`apex_tpu.multi_tensor_apply.multi_tensor_apply`).

The reference chunks tensor lists into ``chunk_size``-element pieces for
its CUDA kernels' argument structs. The port's ops
(:mod:`apex_tpu_torch.ops.multi_tensor`) run ``torch._foreach_*`` passes
over whole lists, so the applier keeps the call shape
(``multi_tensor_applier(op, noop_flag, tensor_lists, *args)``) and
forwards ``chunk_size``, which the ops accept and do not use.
"""

from __future__ import annotations


class MultiTensorApply:
    available = True    # apex call sites check it before using the ops

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag_buffer, tensor_lists, *args, **kwargs):
        """``op(chunk_size, noop_flag_buffer, tensor_lists, *args)``;
        ``noop_flag_buffer`` is None, a bool or a one-element tensor."""
        return op(self.chunk_size, noop_flag_buffer, tensor_lists, *args,
                  **kwargs)


multi_tensor_applier = MultiTensorApply(2048 * 32)
