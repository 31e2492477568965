"""Softmax cross-entropy over vocab-sharded logits (counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

The JAX ``custom_vjp`` computes the loss in fp32 from max-subtracted
logits with the reference's three collectives over the tp axis: the
all-reduce MAX of the row maxima, the all-reduce SUM of the target logit
(each target lives on one rank; the others add 0) and the all-reduce SUM
of the exp-sums. It saves the ORIGINAL-dtype logits, the global row max
and the log partition, and the backward recomputes the softmax in fp32
and returns ``(softmax − onehot)·g`` masked to the local vocab range, cast
to the logits' dtype. Plain PyTorch: JAX runs this in XLA, with no kernel
of its own. At tp = 1 (no mesh, or an axis of one rank) the collectives
are identities and the targets are local.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.parallel.mesh import TP_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_reduce,
    axis_info,
)


class VocabParallelCrossEntropy(ku.OpaqueFunction):
    """Per-position loss (target's shape, fp32) with the JAX residuals."""

    @staticmethod
    def forward(ctx, logits, target, axis_name):
        _, world, rank = axis_info(axis_name)
        v_local = logits.shape[-1]
        x32 = logits.float()
        logits_max = x32.amax(dim=-1)
        if world > 1:
            logits_max = all_reduce(logits_max, axis_name,
                                    op=dist.ReduceOp.MAX)
        x32 = x32 - logits_max[..., None]
        start = rank * v_local
        off_rank = (target < start) | (target >= start + v_local)
        local = torch.where(off_rank, 0, target - start)
        predicted = torch.gather(x32, -1, local[..., None])[..., 0]
        sum_exp = torch.exp(x32).sum(dim=-1)
        if world > 1:
            predicted = all_reduce(torch.where(off_rank, 0.0, predicted),
                                   axis_name)
            sum_exp = all_reduce(sum_exp, axis_name)
        log_sum_exp = torch.log(sum_exp)
        ctx.save_for_backward(logits, logits_max, log_sum_exp, local,
                              off_rank)
        return log_sum_exp - predicted

    @staticmethod
    def backward(ctx, g):
        logits, logits_max, log_sum_exp, local, off_rank = ctx.saved_tensors
        softmax = torch.exp(logits.float() - logits_max[..., None]
                            - log_sum_exp[..., None])
        hit = torch.where(off_rank, 0.0, -1.0)[..., None]
        softmax.scatter_add_(-1, local[..., None], hit)
        grad = softmax * g[..., None].float()
        return grad.to(logits.dtype), None, None


def vocab_parallel_cross_entropy(logits, target, axis_name: str = TP_AXIS):
    """Per-position cross-entropy (same shape as ``target``), fp32.

    ``logits``: (..., vocab/tp), this rank's vocab shard, in the model
    dtype; ``target``: (...) integer ids in the global vocab."""
    return VocabParallelCrossEntropy.apply(logits, target.long(), axis_name)
