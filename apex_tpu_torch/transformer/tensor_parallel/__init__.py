"""Tensor parallelism (counterpart of
``apex_tpu/transformer/tensor_parallel``): the layers over this rank's
shards (``layers``), the collective mappings (``mappings``), the
vocab-parallel cross-entropy, the data broadcast, the memory buffers, the
partition helpers and the RNG policy (JAX's threefry keys, the tracker,
the per-rank streams) with activation checkpointing."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_parallel_linear,
    param_is_not_tensor_parallel_duplicate,
    row_parallel_linear,
    set_tensor_model_parallel_attributes,
    sharded_init,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.memory import (
    MemoryBuffer,
    RingMemBuffer,
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
    pipeline_stage_key,
    prng_key,
    random_bits,
    split,
    uniform,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    P,
    PartitionSpec,
    VocabUtility,
    divide,
    split_tensor_along_last_dim,
)

__all__ = [
    "CHECKPOINT_POLICIES", "ColumnParallelLinear", "MemoryBuffer", "P",
    "PartitionSpec", "RingMemBuffer", "RngStatesTracker",
    "RowParallelLinear", "VocabParallelEmbedding", "VocabUtility",
    "attention_dropout_seed", "bernoulli", "broadcast_data", "checkpoint",
    "checkpoint_wrapper", "column_parallel_linear",
    "copy_to_tensor_model_parallel_region", "data_parallel_key", "divide",
    "fold_in", "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region", "get_cuda_rng_tracker",
    "get_rng_tracker", "model_parallel_cuda_manual_seed",
    "model_parallel_key", "model_parallel_seed",
    "param_is_not_tensor_parallel_duplicate", "pipeline_stage_key",
    "prng_key", "random_bits",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region", "row_parallel_linear",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "set_tensor_model_parallel_attributes", "sharded_init", "split",
    "split_tensor_along_last_dim", "uniform",
    "vocab_parallel_cross_entropy", "vocab_parallel_embedding",
]
