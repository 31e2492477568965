"""Tensor-parallel pieces of the port (counterpart of
``apex_tpu/transformer/tensor_parallel``), single-device forms so far."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)

__all__ = ["vocab_parallel_cross_entropy"]
