"""DistributedDataParallel's gradient synchronization over
``torch.distributed`` (counterpart of :mod:`apex_tpu.parallel.distributed`).

A rank's gradients are its own, so every reduction runs: the JAX module's
``_is_varying`` check (which skips gradients autodiff already summed
under ``shard_map``) has no counterpart. The knobs keep their meaning:

- ``message_size``: bucket size in elements; buckets are filled in
  reverse leaf order, the reference's reverse gradient-ready order;
- ``delay_allreduce``: one flat buffer over every gradient;
- ``allreduce_always_fp32``: reduce a buffer in fp32, cast back after;
- ``gradient_predivide_factor`` / ``gradient_average``: divide by
  ``predivide`` before the sum, multiply by ``predivide / world`` after
  (net ``1 / world`` when averaging), the reference's two-stage average;
- ``num_allreduce_streams`` and ``retain_allreduce_buffers``: accepted
  for parity; the reductions run in order after the backward.

``process_group`` is the JAX ``axis_index_groups``: a list of rank lists
(:mod:`apex_tpu_torch.utils.collectives`). The sum is a ``SUM``
all-reduce followed by a multiply on every backend (gloo has no
``ReduceOp.AVG``), so the CPU and the card run the same arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from apex_tpu_torch.utils.collectives import (
    group_size,
    reduction_group,
    psum_groups,
)
from apex_tpu_torch.utils.pytree import (
    flatten_buckets,
    ravel_list,
    unravel_list,
)


@dataclasses.dataclass(frozen=True)
class DistributedDataParallel:
    message_size: int = 10_000_000
    delay_allreduce: bool = False
    allreduce_always_fp32: bool = False
    gradient_average: bool = True
    gradient_predivide_factor: float = 1.0
    num_allreduce_streams: int = 1          # parity knob
    retain_allreduce_buffers: bool = False  # parity knob
    process_group: Optional[tuple] = None   # rank lists (subgroups)

    def _reduce_flat(self, flat):
        """Reduce one fresh buffer in place (or in its fp32 copy) and
        return it in its own dtype."""
        orig_dtype = flat.dtype
        if self.allreduce_always_fp32:
            flat = flat.float()
        if self.gradient_predivide_factor != 1.0:
            flat.div_(self.gradient_predivide_factor)
        psum_groups(flat, self.process_group)
        if self.gradient_average:
            post = self.gradient_predivide_factor / group_size(
                self.process_group)
            if post != 1.0:
                flat.mul_(post)
        elif self.gradient_predivide_factor != 1.0:
            flat.mul_(self.gradient_predivide_factor)
        return flat.to(orig_dtype)

    def allreduce_grads(self, grads):
        """Synchronize a list (or pytree) of this rank's gradients across
        the process group; returns the same structure of reduced (by
        default averaged) tensors, views of the reduction buffers where
        the dtypes allow. The inputs are not changed."""
        leaves, spec = pytree.tree_flatten(grads)
        if not leaves:
            return grads
        out = [None] * len(leaves)
        order = list(range(len(leaves)))[::-1]
        group = [leaves[i] for i in order]
        if self.delay_allreduce:
            flat, meta = ravel_list(group)
            buckets = [(list(range(len(group))), flat, meta)]
        else:
            buckets = flatten_buckets(group, self.message_size)
        for indices, flat, meta in buckets:
            pieces = unravel_list(self._reduce_flat(flat), meta)
            for piece, pos in zip(pieces, indices):
                out[order[pos]] = piece
        return pytree.tree_unflatten(out, spec)

    def allreduce_accumulated(self, acc, accum_steps: int):
        """The train step's one reduction a global step: divide the
        gradient accumulators by ``accum_steps`` (a true division, in
        place, as the step without DDP does), then
        :meth:`allreduce_grads`."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1:
            floating = [a for a in pytree.tree_leaves(acc)
                        if a.is_floating_point()]
            if floating:
                torch._foreach_div_(floating, float(accum_steps))
        return self.allreduce_grads(acc)

    def __call__(self, grads):
        return self.allreduce_grads(grads)

    def value_and_grad(self, loss_fn, params):
        """``f(*args, **kwargs) -> (loss, reduced grads)``: ``loss_fn``'s
        value and its gradients with respect to ``params`` (a list), by
        ``torch.autograd.grad``, synchronized (the wrapped-model use of
        the reference DDP)."""
        params = list(params)

        def wrapped(*args, **kwargs):
            loss = loss_fn(*args, **kwargs)
            grads = torch.autograd.grad(loss, params)
            return loss.detach(), self.allreduce_grads(list(grads))

        return wrapped


_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX}


def flat_dist_call(tensors, group=None, op: str = "sum"):
    """The reference's ``flat_dist_call``: flatten ``tensors``, one
    all-reduce (``"sum"``, ``"mean"`` or ``"max"``) over this rank's group
    of ``group`` (rank lists; every rank when None), unflatten."""
    if op not in _OPS:
        raise ValueError(f"unsupported op {op!r}")
    flat, meta = ravel_list(list(tensors))
    pg, size = reduction_group(group)
    dist.all_reduce(flat, op=_OPS[op], group=pg)
    if op == "mean":
        flat.div_(size)
    return unravel_list(flat, meta)
