"""Tensor-parallel layers (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.layers`): ColumnParallelLinear,
RowParallelLinear and VocabParallelEmbedding, each holding this rank's
shard.

The knobs are the JAX modules': ``gather_output``, ``input_is_parallel``,
``skip_bias_add``, ``bias``, ``sequence_parallel_enabled``,
``gradient_accumulation_fusion`` (accepted for parity: fp32 accumulation
across microbatches is :mod:`.main_grad`'s), ``init_method``,
``master_weight_init`` and ``params_dtype``. Weights are stored as torch
keeps a ``Linear``'s, ``(out, in)``: ColumnParallelLinear splits the
output rows, RowParallelLinear the input columns, VocabParallelEmbedding
the vocabulary rows. A product runs in the input's dtype (the JAX
``kernel.astype(x.dtype)``).

Initialization is the master-weight rule of the JAX ``_master_init``
(the reference's ``_initialize_affine_weight``): the full weight is drawn
on the CPU, from ``generator`` (the global RNG when None), as a layer at
tensor-parallel size 1 draws it, and this rank keeps its slice, so the
ranks' shards assembled are the size-1 layer's weight bit for bit. With
``master_weight_init=False`` each rank draws only its shard, from a seed
that folds in its rank. ``init_method(tensor, generator=None)`` fills a
tensor in place (``torch.nn.init``'s signature; called without the
generator when none is given).

A RowParallelLinear's bias is added once, after the reduction; under
sequence parallelism it is used on this rank's sequence shard only, so
it carries ``sequence_parallel = True``, the mark by which the train step
sums its gradient over the tensor-parallel group.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_along_first_dim,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_along_first_dim,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import fold_seed
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled to variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(tensor: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``lecun_normal`` on a torch ``(out, in)`` weight (fan-in is
    ``in``): the JAX layers' default initializer."""
    std = math.sqrt(1.0 / tensor.shape[-1]) / _TRUNC_STD
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def normal_init(stddev: float = 0.02) -> Callable:
    """flax ``normal(stddev)``: VocabParallelEmbedding's default."""
    def init(tensor, generator=None):
        return nn.init.normal_(tensor, 0.0, stddev, generator=generator)
    return init


def _draw(init_method, t, generator):
    if generator is None:
        init_method(t)
    else:
        init_method(t, generator=generator)
    return t


def _master_init(init_method, full_shape, axis, dtype, generator,
                 enabled=True):
    """This rank's shard along ``axis`` of a weight of ``full_shape``."""
    tp = parallel_state.get_tensor_model_parallel_world_size()
    if tp == 1:
        return _draw(init_method, torch.empty(full_shape, dtype=dtype),
                     generator)
    rank = parallel_state.get_tensor_model_parallel_rank()
    shard_shape = list(full_shape)
    shard_shape[axis] //= tp
    if not enabled:
        base = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=generator).item())
        own = torch.Generator().manual_seed(fold_seed(base, rank))
        return _draw(init_method, torch.empty(shard_shape, dtype=dtype), own)
    full = _draw(init_method, torch.empty(full_shape, dtype=dtype),
                 generator)
    return full.narrow(axis, rank * shard_shape[axis],
                       shard_shape[axis]).clone()


def _check_divisible(what, n, tp):
    if n % tp != 0:
        raise ValueError(f"{what} ({n}) not divisible by tensor parallel "
                         f"size ({tp})")


class ColumnParallelLinear(nn.Module):
    """Y = X A^T + b with A split along its output rows (reference:
    ``ColumnParallelLinear``). The output is this rank's shard unless
    ``gather_output``. Under ``sequence_parallel_enabled`` the input is
    this rank's sequence shard (dim 0), all-gathered in the forward and
    reduce-scattered in the backward."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = True, skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 gradient_accumulation_fusion: bool = False,
                 init_method: Callable = lecun_normal_,
                 master_weight_init: bool = True,
                 params_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        tp = parallel_state.get_tensor_model_parallel_world_size()
        _check_divisible("output_size", output_size, tp)
        if gather_output and sequence_parallel_enabled:
            raise ValueError(
                "gather_output is incompatible with "
                "sequence_parallel_enabled, matching the reference assertion")
        self.input_size, self.output_size = input_size, output_size
        self.gather_output = gather_output
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        device = resolve_device(device)
        w = _master_init(init_method, (output_size, input_size), 0,
                         params_dtype, generator, master_weight_init)
        self.weight = nn.Parameter(w.to(device))
        self.bias = (nn.Parameter(torch.zeros(output_size // tp,
                                              dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x):
        if self.sequence_parallel_enabled:
            x = gather_along_first_dim(x)
        else:
            x = copy_to_tensor_model_parallel_region(x)
        w = self.weight.to(x.dtype)
        b = self.bias
        if b is not None and not self.skip_bias_add:
            y = F.linear(x, w, b.to(x.dtype))
        else:
            y = F.linear(x, w)
        if self.gather_output:
            y = gather_from_tensor_model_parallel_region(y)
        if self.skip_bias_add:
            return y, b
        return y


class RowParallelLinear(nn.Module):
    """Y = X A^T + b with A split along its input columns (reference:
    ``RowParallelLinear``). The input is this rank's shard when
    ``input_is_parallel``, else it is scattered here. The partial
    products are all-reduced, or reduce-scattered along the sequence dim
    under ``sequence_parallel_enabled``; the bias is added after."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = True, skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 gradient_accumulation_fusion: bool = False,
                 init_method: Callable = lecun_normal_,
                 master_weight_init: bool = True,
                 params_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        tp = parallel_state.get_tensor_model_parallel_world_size()
        _check_divisible("input_size", input_size, tp)
        if sequence_parallel_enabled and not input_is_parallel:
            raise ValueError(
                "sequence_parallel_enabled requires input_is_parallel, "
                "matching the reference assertion")
        self.input_size, self.output_size = input_size, output_size
        self.input_is_parallel = input_is_parallel
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        device = resolve_device(device)
        w = _master_init(init_method, (output_size, input_size), 1,
                         params_dtype, generator, master_weight_init)
        self.weight = nn.Parameter(w.to(device))
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.zeros(output_size,
                                                 dtype=params_dtype,
                                                 device=device))
            self.bias.sequence_parallel = sequence_parallel_enabled

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x)
        y = F.linear(x, self.weight.to(x.dtype))
        if self.sequence_parallel_enabled:
            y = reduce_scatter_along_first_dim(y)
        else:
            y = reduce_from_tensor_model_parallel_region(y)
        b = self.bias
        if b is not None and not self.skip_bias_add:
            y = y + b.to(y.dtype)
        if self.skip_bias_add:
            return y, b
        return y


class VocabParallelEmbedding(nn.Module):
    """An embedding table split along the vocabulary (reference:
    ``VocabParallelEmbedding``): ids outside this rank's rows look up
    zeros, and the partial lookups are all-reduced, so each id resolves
    on exactly one rank."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 init_method: Callable = normal_init(0.02),
                 master_weight_init: bool = True,
                 params_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        tp = parallel_state.get_tensor_model_parallel_world_size()
        _check_divisible("num_embeddings", num_embeddings, tp)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.per_partition = num_embeddings // tp
        device = resolve_device(device)
        w = _master_init(init_method, (num_embeddings, embedding_dim), 0,
                         params_dtype, generator, master_weight_init)
        self.weight = nn.Parameter(w.to(device))

    def forward(self, ids):
        tp = parallel_state.get_tensor_model_parallel_world_size()
        if tp == 1:
            return F.embedding(ids, self.weight)
        start, _ = VocabUtility.vocab_range_from_per_partition_vocab_size(
            self.per_partition,
            parallel_state.get_tensor_model_parallel_rank(), tp)
        local = ids - start
        in_range = (local >= 0) & (local < self.per_partition)
        out = F.embedding(torch.where(in_range, local, 0), self.weight)
        out = torch.where(in_range[..., None], out, 0.0)
        return reduce_from_tensor_model_parallel_region(out)
