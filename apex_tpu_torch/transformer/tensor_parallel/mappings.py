"""The tensor-parallel collective mappings (counterpart of
``apex_tpu/transformer/tensor_parallel/mappings.py``): each a
``torch.autograd.Function`` pairing a forward collective over a mesh axis
(``"tp"`` by default) with the backward of its JAX transpose.

=========================================  ===============  ===============
mapping                                    forward          backward
=========================================  ===============  ===============
``copy_to_tensor_model_parallel_region``   identity         all-reduce
``reduce_from_tensor_model_parallel_...``  all-reduce       identity
``scatter_to_tensor_model_parallel_...``   split last dim   all-gather
``gather_from_tensor_model_parallel_...``  all-gather last  split
``gather_from_sequence_parallel_region``   all-gather seq   reduce-scatter
  (``tensor_parallel_output_grad=False``)                   split seq
``reduce_scatter_to_sequence_parallel_...``reduce-scatter   all-gather seq
``scatter_to_sequence_parallel_region``    slice seq        all-gather seq
=========================================  ===============  ===============

gather's backward is a split, not a reduce-scatter: every tp rank holds
the gathered activations and computes the same loss from them, so each
rank's cotangent is already the whole one (JAX's ``custom_vjp``,
``mappings.py:113-126``). scatter_to_sequence's input is the same on
every rank, so its transpose hands each rank the whole cotangent: the
ranks' shards gathered (JAX: the psum of the zero-padded shards).

The axis resolves on the current mesh (``parallel.mesh.get_mesh``); with
no mesh installed, or on an axis of size 1, every mapping is the
identity, as XLA drops a collective over one device. Each collective is
entered into the open ``comm.accounting`` records under the tag
``"tp"``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.comm import collectives as coll
from apex_tpu_torch.parallel.mesh import TP_AXIS, axis_info  # noqa: F401
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

_TAG = "tp"


def all_reduce(x: torch.Tensor, axis_name: str = TP_AXIS, op=None,
               tag: str = _TAG) -> torch.Tensor:
    """Sum (or ``op``) of ``x`` over the axis, out of place."""
    group, world, _ = axis_info(axis_name)
    if world == 1:
        return x
    return coll.all_reduce(x.contiguous().clone(), group, world, op=op,
                           tag=tag)


def all_gather_dim(x: torch.Tensor, dim: int, axis_name: str = TP_AXIS,
                   tag: str = _TAG) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    group, world, _ = axis_info(axis_name)
    if world == 1:
        return x
    dim = dim % x.dim()
    out = coll.all_gather(x.movedim(dim, 0).contiguous(), group, world,
                          tag=tag)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, axis_name: str = TP_AXIS,
                       tag: str = _TAG) -> torch.Tensor:
    """This rank's 1/W of the ranks' sum of ``x`` along ``dim``."""
    group, world, _ = axis_info(axis_name)
    if world == 1:
        return x
    dim = dim % x.dim()
    divide(x.shape[dim], world)
    out = coll.reduce_scatter(x.movedim(dim, 0).contiguous(), group, world,
                              tag=tag)
    return out.movedim(0, dim).contiguous()


def split_dim(x: torch.Tensor, dim: int,
              axis_name: str = TP_AXIS) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (no communication)."""
    _, world, index = axis_info(axis_name)
    if world == 1:
        return x
    chunk = divide(x.shape[dim], world)
    return x.narrow(dim, index * chunk, chunk).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis_name), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return all_reduce(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return split_dim(x, -1, axis_name)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, -1, ctx.axis_name), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return all_gather_dim(x, -1, axis_name)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, -1, ctx.axis_name), None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, seq_axis):
        ctx.args = (seq_axis, axis_name)
        return all_gather_dim(x, seq_axis, axis_name)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, *ctx.args), None, None


class _SeqGatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, seq_axis):
        ctx.args = (seq_axis, axis_name)
        return all_gather_dim(x, seq_axis, axis_name)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, *ctx.args), None, None


class _SeqReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, seq_axis):
        ctx.args = (seq_axis, axis_name)
        return reduce_scatter_dim(x, seq_axis, axis_name)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, *ctx.args), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, seq_axis):
        ctx.args = (seq_axis, axis_name)
        return split_dim(x, seq_axis, axis_name)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, *ctx.args), None, None


def _world(axis_name) -> int:
    return axis_info(axis_name)[1]


def copy_to_tensor_model_parallel_region(x, axis_name: str = TP_AXIS):
    """Identity forward, all-reduce backward: feeds replicated activations
    (or a replicated parameter that meets a rank's shard) into a
    tensor-parallel region."""
    return x if _world(axis_name) == 1 else _Copy.apply(x, axis_name)


def reduce_from_tensor_model_parallel_region(x, axis_name: str = TP_AXIS):
    """All-reduce forward, identity backward: the partial sums out of a
    row-parallel product."""
    return x if _world(axis_name) == 1 else _Reduce.apply(x, axis_name)


def scatter_to_tensor_model_parallel_region(x, axis_name: str = TP_AXIS):
    """This rank's slice of the last dim forward, all-gather backward."""
    return x if _world(axis_name) == 1 else _Scatter.apply(x, axis_name)


def gather_from_tensor_model_parallel_region(x, axis_name: str = TP_AXIS):
    """All-gather of the last dim forward, split backward."""
    return x if _world(axis_name) == 1 else _Gather.apply(x, axis_name)


def gather_from_sequence_parallel_region(
        x, axis_name: str = TP_AXIS, seq_axis: int = 1,
        tensor_parallel_output_grad: bool = True):
    """Megatron-SP's entry ``g``: the (b, s/tp, h) shards all-gathered along
    the sequence; backward reduce-scatters the cotangent (the ranks hold
    partial cotangents of a tensor-parallel region). With
    ``tensor_parallel_output_grad=False`` (Megatron's flag) the region
    after the gather is computed the same on every rank, its cotangent is
    whole on each, and the backward keeps this rank's slice."""
    if _world(axis_name) == 1:
        return x
    if not tensor_parallel_output_grad:
        return _SeqGatherSplit.apply(x, axis_name, seq_axis)
    return _SeqGather.apply(x, axis_name, seq_axis)


def reduce_scatter_to_sequence_parallel_region(x, axis_name: str = TP_AXIS,
                                               seq_axis: int = 1):
    """Megatron-SP's exit ``ḡ``: the ranks' partial sums reduce-scattered
    along the sequence into this rank's (b, s/tp, h) shard; backward
    all-gathers."""
    if _world(axis_name) == 1:
        return x
    return _SeqReduceScatter.apply(x, axis_name, seq_axis)


def scatter_to_sequence_parallel_region(x, axis_name: str = TP_AXIS,
                                        seq_axis: int = 1):
    """This rank's sequence slice of a tensor that is the same on every
    rank (no reduction); backward all-gathers the shards' cotangents, the
    whole per-token cotangent on every rank."""
    if _world(axis_name) == 1:
        return x
    return _SeqScatter.apply(x, axis_name, seq_axis)
