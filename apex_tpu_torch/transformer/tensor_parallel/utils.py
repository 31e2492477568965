"""Shape and vocab partition helpers for tensor parallelism (counterpart
of ``apex_tpu/transformer/tensor_parallel/utils.py``), and the port's
partition spec.

:class:`PartitionSpec` (alias ``P``) stands in for JAX's
``jax.sharding.PartitionSpec``: one entry a tensor dimension, an axis name
where the dimension is split over that mesh axis, ``None`` where it is
whole. The port has no ``shard_map``; ``standalone_gpt.shard_params`` cuts a
global parameter tree into this rank's local tree by such specs and
``gather_grads`` assembles the global gradients back.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(tensor: torch.Tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False):
    """Split along the last dim into ``num_partitions`` equal chunks (a
    tuple of views; contiguous copies with ``contiguous_split_chunks``, the
    reference's flag)."""
    size = divide(tensor.shape[-1], num_partitions)
    chunks = torch.split(tensor, size, dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return tuple(chunks)


class VocabUtility:
    """The vocab range [first, last) that ``rank`` of ``world_size``
    owns."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int, world_size: int):
        index_f = rank * per_partition_vocab_size
        return index_f, index_f + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
            global_vocab_size: int, rank: int,
            world_size: int) -> Tuple[int, int]:
        per_partition = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition, rank, world_size)


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: ``P(None, "tp")`` splits dim 1 over the tp
    axis; trailing dimensions not named are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec
