"""Tensor-parallel pieces of the port (counterpart of
``apex_tpu/transformer/tensor_parallel``), single-device forms so far: the
vocab-parallel cross-entropy at tp = 1, and the RNG policy (JAX's
threefry keys, the tracker, the per-rank streams) with activation
checkpointing."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    CHECKPOINT_POLICIES,
    RngStatesTracker,
    attention_dropout_seed,
    bernoulli,
    checkpoint,
    checkpoint_wrapper,
    data_parallel_key,
    fold_in,
    get_cuda_rng_tracker,
    get_rng_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_key,
    model_parallel_seed,
    prng_key,
    random_bits,
    split,
    uniform,
)

__all__ = [
    "CHECKPOINT_POLICIES", "RngStatesTracker", "attention_dropout_seed",
    "bernoulli", "checkpoint", "checkpoint_wrapper", "data_parallel_key",
    "fold_in", "get_cuda_rng_tracker", "get_rng_tracker",
    "model_parallel_cuda_manual_seed", "model_parallel_key",
    "model_parallel_seed", "prng_key", "random_bits", "split", "uniform",
    "vocab_parallel_cross_entropy",
]
