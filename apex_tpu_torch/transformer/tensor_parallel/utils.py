"""Tensor-parallel sizing helpers (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.utils`): the arithmetic that
shard shapes are built from, on Python ints (a process knows its rank)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = [
    "ensure_divisibility",
    "divide",
    "split_tensor_along_last_dim",
    "VocabUtility",
]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    """Raise unless ``denominator`` divides ``numerator`` exactly."""
    if numerator % denominator != 0:
        raise ValueError(
            f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Exact integer division (raises on remainder)."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(
        tensor: torch.Tensor, num_partitions: int,
        contiguous_split_chunks: bool = False) -> Sequence[torch.Tensor]:
    """Split a tensor into ``num_partitions`` equal chunks along its last
    dimension: views, or contiguous copies with
    ``contiguous_split_chunks`` (the reference's meaning; the JAX arrays
    have no strides, so the JAX module ignores it)."""
    last = divide(tensor.shape[-1], num_partitions)
    chunks = torch.split(tensor, last, dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return chunks


class VocabUtility:
    """[first, last) ranges of a vocabulary dimension split over the
    tensor-parallel ranks (reference: ``VocabUtility``)."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
            global_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, world_size)
