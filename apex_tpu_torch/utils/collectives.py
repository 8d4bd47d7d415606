"""Grouped all-reduces over ``torch.distributed`` (counterpart of
:mod:`apex_tpu.utils.collectives`' ``psum_groups`` and ``group_size``).

``groups`` is the JAX package's ``axis_index_groups``: a list of rank
lists, the same on every rank, each rank in exactly one of them. Each
list of groups becomes ``torch.distributed`` process groups once, cached
per default group. ``new_group`` is a collective call: every rank makes
every group, in the same order, also the groups it is not in, or the job
hangs; :func:`reduction_group` does that. A rank then reduces in its own
group only.

JAX's ``compat_shard_map``, ``mark_varying`` and ``axis_is_bound`` have no
counterpart: a torch process holds its own rank's values, and "the axis
is bound" is ``torch.distributed.is_initialized()``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

# default process group -> {groups key: (this rank's group, its size)}
_cache: dict = {}


def _check_initialized():
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "apex_tpu_torch.parallel.init_process_group first")


def reduction_group(groups: Optional[Sequence[Sequence[int]]]):
    """``(group, size)`` of this rank's reduction group: ``(None,
    world size)`` (the default group) for ``groups=None``, else the
    cached ``new_group`` of the list that holds this rank."""
    _check_initialized()
    if groups is None:
        return None, dist.get_world_size()
    key = tuple(tuple(int(r) for r in g) for g in groups)
    world = dist.group.WORLD
    per_world = _cache.get(id(world))
    if per_world is None or per_world[0] is not world:
        per_world = _cache[id(world)] = (world, {})
    if key not in per_world[1]:
        rank = dist.get_rank()
        made = [dist.new_group(list(g)) for g in key]   # on every rank
        own = [(pg, len(g)) for pg, g in zip(made, key) if rank in g]
        if len(own) != 1:
            raise ValueError(f"rank {rank} must be in exactly one of the "
                             f"groups {key}")
        per_world[1][key] = own[0]
    return per_world[1][key]


def psum_groups(x: torch.Tensor, groups=None) -> torch.Tensor:
    """Sum ``x`` over this rank's group of ``groups`` (every rank when
    None), in place; returns ``x``."""
    group, _ = reduction_group(groups)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def group_size(groups=None) -> int:
    """The size of this rank's reduction group."""
    return reduction_group(groups)[1]


class _AllReduceSum(torch.autograd.Function):
    """A differentiable sum over the group: the backward sums the
    cotangent over the same group (psum's transpose), so a rank's input
    gets the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return psum_groups(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return psum_groups(g.contiguous().clone(), ctx.groups), None


def all_reduce_sum(x: torch.Tensor, groups=None) -> torch.Tensor:
    """:func:`psum_groups` that autograd differentiates (a new tensor)."""
    return _AllReduceSum.apply(x, groups)
