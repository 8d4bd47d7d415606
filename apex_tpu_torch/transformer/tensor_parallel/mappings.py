"""Tensor-parallel communication mappings (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.mappings`), as
``torch.autograd.Function``s over the tensor-parallel group.

JAX needs no custom transposes here: ``shard_map`` types each value as
invariant (one value for the group) or varying (one a rank), and AD puts
a ``psum`` where an invariant value meets a varying one. A torch process
holds its own rank's values with no such type, so each mapping states its
backward, and every rank differentiates one loss that all of them hold
(the replicated loss). That is the JAX program's ``jax.grad`` once its
loss is invariant over the tensor axis, a ``pmean`` of the per-rank
value where AD typed it varying; the tests hold each mapping to it:

- ``copy_to``: identity forward, all-reduce backward (the partial
  gradients of the ranks' column shards add up);
- ``reduce_from``: all-reduce forward, identity backward;
- ``scatter_to``: keep this rank's last-dim chunk; all-gather backward;
- ``gather_from``: all-gather the last-dim chunks; the backward keeps
  this rank's chunk (JAX's reduce-scatter of the cotangents, each 1 / tp
  of the replicated loss's);
- ``reduce_scatter_along_first_dim``: reduce-scatter forward, all-gather
  backward (sequence parallelism's exit of a RowParallelLinear);
- ``gather_along_first_dim``: all-gather forward, reduce-scatter
  backward (its entry of a ColumnParallelLinear, whose input gradients
  are partial a rank).

Sequence parallelism's entry and exit around a model's blocks (the JAX
BERT's ``dynamic_slice(mark_varying(x))`` and its last
``gather_along_first_dim``) are :func:`sequence_parallel_enter` (keep
this rank's first-dim shard; all-gather backward) and
:func:`sequence_parallel_exit` (all-gather; the backward keeps this
rank's shard of the replicated gradient). At tensor-parallel size 1
every mapping is the identity and runs no collective.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils import collectives


def _groups():
    return parallel_state.get_tensor_model_parallel_ranks()


def _tp() -> int:
    return parallel_state.get_tensor_model_parallel_world_size()


def _chunk(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``."""
    tp = _tp()
    if x.shape[dim] % tp:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {tp} tensor-parallel ranks")
    rank = parallel_state.get_tensor_model_parallel_rank()
    return x.chunk(tp, dim=dim)[rank].contiguous()


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    return collectives.psum_groups(x.contiguous().clone(), _groups())


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Chunk(torch.autograd.Function):
    """Keep this rank's chunk along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _chunk(x, dim)

    @staticmethod
    def backward(ctx, g):
        return collectives.gather_along(g, ctx.dim, _groups()), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's chunk."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return collectives.gather_along(x, dim, _groups())

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim), None


def copy_to_tensor_model_parallel_region(x):
    """Identity forward, all-reduce backward (reference:
    ``_CopyToModelParallelRegion``): the entry of ColumnParallelLinear."""
    return x if _tp() == 1 else _CopyToRegion.apply(x)


def reduce_from_tensor_model_parallel_region(x):
    """All-reduce forward, identity backward (reference:
    ``_ReduceFromModelParallelRegion``): the exit of RowParallelLinear."""
    return x if _tp() == 1 else _ReduceFromRegion.apply(x)


def scatter_to_tensor_model_parallel_region(x):
    """Keep this rank's last-dim chunk (reference:
    ``_ScatterToModelParallelRegion``); the backward all-gathers."""
    return x if _tp() == 1 else _Chunk.apply(x, -1)


def gather_from_tensor_model_parallel_region(x):
    """All-gather the last-dim chunks (reference:
    ``_GatherFromModelParallelRegion``); the backward keeps this rank's
    chunk."""
    return x if _tp() == 1 else _Gather.apply(x, -1)


def reduce_scatter_along_first_dim(x):
    """Reduce-scatter along the sequence dim (reference:
    ``_reduce_scatter_along_first_dim``); the backward all-gathers."""
    return x if _tp() == 1 else collectives.reduce_scatter(x, 0, _groups())


def gather_along_first_dim(x):
    """All-gather along the sequence dim (reference:
    ``_gather_along_first_dim``); the backward reduce-scatters."""
    return x if _tp() == 1 else collectives.all_gather(x, 0, _groups())


def sequence_parallel_enter(x):
    """This rank's shard of a replicated ``x`` along dim 0; the backward
    all-gathers the shards' gradients into the replicated gradient."""
    return x if _tp() == 1 else _Chunk.apply(x, 0)


def sequence_parallel_exit(x):
    """The replicated ``x`` gathered from the ranks' dim-0 shards; the
    backward keeps this rank's shard of the replicated gradient."""
    return x if _tp() == 1 else _Gather.apply(x, 0)
