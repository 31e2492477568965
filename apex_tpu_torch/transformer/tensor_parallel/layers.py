"""Megatron-style tensor-parallel layers (counterpart of
``apex_tpu/transformer/tensor_parallel/layers.py``): the vocab-parallel
embedding and the column- and row-parallel linears, as functions on this
rank's shards and as ``nn.Module``\\ s holding them.

Shards (``tp`` the axis size; JAX's layout, kernels ``(in, out)``):
column-parallel ``(in, out/tp)`` with a ``(out/tp,)`` bias; row-parallel
``(in/tp, out)`` with a whole ``(out,)`` bias added once after the
reduce; the embedding ``(vocab/tp, hidden)``. The collectives come from
``mappings``. ``sequence_parallel`` (Megatron-SP) makes the column entry
an all-gather of the (b, s/tp, h) sequence shards and the row exit (and
the embedding's) a reduce-scatter back to them. ``overlap_comm`` moves
those dependent collectives onto the rings of ``comm.overlap``
(``all_gather_matmul`` at the SP entry, ``matmul_reduce_scatter`` /
``matmul_all_reduce`` at the exit). The large products are plain
``torch.matmul`` in the input's dtype, as JAX's are plain dots.

Megatron-SP's replicated parameters that meet a sequence shard (the row
bias here) get a partial gradient on each rank: the layers pass them
through ``copy_to_tensor_model_parallel_region``, whose backward sums
them over tp exactly once (JAX sums them at the ``shard_map`` boundary).

Initialization is tp-invariant, as JAX's and the reference's master-weight
path: the whole weight is drawn from one generator and each rank keeps its
slice (:func:`sharded_init`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.comm.overlap import (
    all_gather_matmul,
    matmul_all_reduce,
    matmul_reduce_scatter,
)
from apex_tpu_torch.parallel.mesh import TP_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    axis_info,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
)


def set_tensor_model_parallel_attributes(tensor: torch.Tensor,
                                         is_parallel: bool, dim: int,
                                         stride: int = 1) -> torch.Tensor:
    """Mark a parameter as a tensor-parallel shard along ``dim`` (the
    reference's attributes; JAX records a partition spec instead)."""
    tensor.tensor_model_parallel = is_parallel
    tensor.partition_dim = dim
    tensor.partition_stride = stride
    return tensor


def param_is_not_tensor_parallel_duplicate(param) -> bool:
    """A shard, or any parameter on tp rank 0 (the rest are copies)."""
    return (getattr(param, "tensor_model_parallel", False)
            or axis_info(TP_AXIS)[2] == 0)


def sharded_init(init_method: Callable, full_shape, partition_dim: int,
                 axis_name: str = TP_AXIS, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
    """This rank's slice along ``partition_dim`` of a master weight of
    ``full_shape`` initialized in place by ``init_method(tensor,
    generator=)`` (a ``torch.nn.init`` function) on the CPU, so every tp
    degree holds slices of the same weight."""
    master = torch.empty(tuple(full_shape), dtype=torch.float32)
    init_method(master, generator=generator)
    _, world, rank = axis_info(axis_name)
    chunk = divide(full_shape[partition_dim], world)
    shard = master.narrow(partition_dim, rank * chunk, chunk)
    return shard.to(dtype=dtype, device=device).contiguous()


def _normal_002(t, generator=None):
    return nn.init.normal_(t, std=0.02, generator=generator)


# ---------------------------------------------------------------------------
# functions on shards


def vocab_parallel_embedding(ids, weight, axis_name: str = TP_AXIS,
                             sequence_parallel: bool = False):
    """Lookup into this rank's ``(vocab/tp, hidden)`` rows: an id outside
    them gives a zero row, and the ranks' rows are summed (all-reduce; with
    ``sequence_parallel`` reduce-scattered along the sequence into the
    (b, s/tp, h) shard)."""
    _, world, rank = axis_info(axis_name)
    if world == 1:
        return F.embedding(ids, weight)
    start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
        weight.shape[0], rank, world)
    mask = (ids < start) | (ids >= end)
    out = F.embedding(torch.where(mask, 0, ids - start), weight)
    out = out.masked_fill(mask[..., None], 0)
    if sequence_parallel:
        return reduce_scatter_to_sequence_parallel_region(out, axis_name)
    return reduce_from_tensor_model_parallel_region(out, axis_name)


def column_parallel_linear(x, kernel, bias=None, *, gather_output: bool = True,
                           axis_name: str = TP_AXIS,
                           sequence_parallel: bool = False,
                           overlap_comm: bool = False,
                           product: Callable = torch.matmul):
    """``Y_i = X @ A_i (+ b_i)`` with ``kernel`` this rank's ``(in,
    out/tp)`` columns. ``sequence_parallel``: ``x`` is the (b, s/tp, h)
    shard, gathered along the sequence on entry (reduce-scattered in
    backward); with ``overlap_comm`` too, the gather rides
    ``comm.overlap.all_gather_matmul``'s ring. ``gather_output`` gathers
    the output columns. ``product(x, kernel)`` forms the plain product
    (GPT passes its remat-marked one)."""
    world = axis_info(axis_name)[1]
    kernel = kernel.to(x.dtype)
    if sequence_parallel and overlap_comm and world > 1:
        y = all_gather_matmul(x, kernel, axis_name=axis_name, gather_axis=1)
    else:
        if sequence_parallel:
            x = gather_from_sequence_parallel_region(x, axis_name)
        else:
            x = copy_to_tensor_model_parallel_region(x, axis_name)
        y = product(x, kernel)
    if bias is not None:
        y = y + bias
    if gather_output:
        y = gather_from_tensor_model_parallel_region(y, axis_name)
    return y


def row_parallel_linear(x, kernel, bias=None, *,
                        input_is_parallel: bool = False,
                        axis_name: str = TP_AXIS,
                        sequence_parallel: bool = False,
                        overlap_comm: bool = False,
                        product: Callable = torch.matmul):
    """``Y = Σ_i X_i @ A_i (+ b)`` with ``kernel`` this rank's ``(in/tp,
    out)`` rows; the bias is added once, after the reduce. With
    ``sequence_parallel`` the partial sums are reduce-scattered along the
    sequence into the (b, s/tp, out) shard (and the bias's gradient,
    partial on each rank, is summed over tp). ``overlap_comm`` runs the
    exit on a ring (``matmul_reduce_scatter`` under SP,
    ``matmul_all_reduce`` otherwise: the sequence dim divisible by the
    axis size), equal to the monolithic exit up to the order of the
    sum."""
    world = axis_info(axis_name)[1]
    if not input_is_parallel:
        x = scatter_to_tensor_model_parallel_region(x, axis_name)
    kernel = kernel.to(x.dtype)
    if overlap_comm and world > 1:
        ring = matmul_reduce_scatter if sequence_parallel else \
            matmul_all_reduce
        y = ring(x, kernel, axis_name=axis_name, scatter_axis=1)
    else:
        y = product(x, kernel)
        if sequence_parallel:
            y = reduce_scatter_to_sequence_parallel_region(y, axis_name)
        else:
            y = reduce_from_tensor_model_parallel_region(y, axis_name)
    if bias is not None:
        if sequence_parallel:
            bias = copy_to_tensor_model_parallel_region(bias, axis_name)
        y = y + bias
    return y


# ---------------------------------------------------------------------------
# modules


def _tp_world(axis_name: str) -> int:
    return axis_info(axis_name)[1]


class VocabParallelEmbedding(nn.Module):
    """The embedding table's ``(vocab/tp, hidden)`` shard; ``forward(ids)``
    looks up global ids (:func:`vocab_parallel_embedding`)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 init_method: Callable = _normal_002,
                 params_dtype=torch.float32, axis_name: str = TP_AXIS,
                 sequence_parallel: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.axis_name = axis_name
        self.sequence_parallel = sequence_parallel
        divide(num_embeddings, _tp_world(axis_name))
        self.weight = nn.Parameter(sharded_init(
            init_method, (num_embeddings, embedding_dim), 0, axis_name,
            params_dtype, device, generator))
        set_tensor_model_parallel_attributes(self.weight, True, 0)

    def forward(self, ids):
        return vocab_parallel_embedding(ids, self.weight, self.axis_name,
                                        self.sequence_parallel)


class ColumnParallelLinear(nn.Module):
    """``(input_size, output_size/tp)`` kernel and ``(output_size/tp,)``
    bias; ``forward(x)`` returns ``(output, output_bias)``, the bias
    unapplied and returned iff ``skip_bias_add`` (the reference's
    contract)."""

    def __init__(self, input_size: int, output_size: int,
                 use_bias: bool = True, gather_output: bool = True,
                 init_method: Callable = nn.init.xavier_normal_,
                 skip_bias_add: bool = False, params_dtype=torch.float32,
                 axis_name: str = TP_AXIS, sequence_parallel: bool = False,
                 overlap_comm: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gather_output = gather_output
        self.skip_bias_add = skip_bias_add
        self.axis_name = axis_name
        self.sequence_parallel = sequence_parallel
        self.overlap_comm = overlap_comm
        out_local = divide(output_size, _tp_world(axis_name))
        self.kernel = nn.Parameter(sharded_init(
            init_method, (input_size, output_size), 1, axis_name,
            params_dtype, device, generator))
        set_tensor_model_parallel_attributes(self.kernel, True, 1)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_local, dtype=params_dtype,
                                                 device=device))
            set_tensor_model_parallel_attributes(self.bias, True, 0)

    def forward(self, x):
        y = column_parallel_linear(
            x, self.kernel, None if self.skip_bias_add else self.bias,
            gather_output=self.gather_output, axis_name=self.axis_name,
            sequence_parallel=self.sequence_parallel,
            overlap_comm=self.overlap_comm)
        return y, (self.bias if self.skip_bias_add else None)


class RowParallelLinear(nn.Module):
    """``(input_size/tp, output_size)`` kernel and a whole
    ``(output_size,)`` bias (zeros, added after the reduce); ``forward(x)``
    returns ``(output, output_bias)``."""

    def __init__(self, input_size: int, output_size: int,
                 use_bias: bool = True, input_is_parallel: bool = False,
                 init_method: Callable = nn.init.xavier_normal_,
                 skip_bias_add: bool = False, params_dtype=torch.float32,
                 axis_name: str = TP_AXIS, sequence_parallel: bool = False,
                 overlap_comm: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self.skip_bias_add = skip_bias_add
        self.axis_name = axis_name
        self.sequence_parallel = sequence_parallel
        self.overlap_comm = overlap_comm
        divide(input_size, _tp_world(axis_name))
        self.kernel = nn.Parameter(sharded_init(
            init_method, (input_size, output_size), 0, axis_name,
            params_dtype, device, generator))
        set_tensor_model_parallel_attributes(self.kernel, True, 0)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(output_size,
                                                 dtype=params_dtype,
                                                 device=device))

    def forward(self, x):
        y = row_parallel_linear(
            x, self.kernel, None if self.skip_bias_add else self.bias,
            input_is_parallel=self.input_is_parallel,
            axis_name=self.axis_name,
            sequence_parallel=self.sequence_parallel,
            overlap_comm=self.overlap_comm)
        return y, (self.bias if self.skip_bias_add else None)
