"""Softmax cross-entropy over the vocab (counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``), in its
single-device (tp=1) form.

The JAX ``custom_vjp`` computes the loss in fp32 from max-subtracted
logits and saves the ORIGINAL-dtype logits, the row max and the log
partition for the backward, which recomputes the softmax in fp32 and
returns ``(softmax − onehot)·g`` cast to the logits' dtype. Plain PyTorch
here: JAX runs this in XLA, with no kernel of its own.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import _kernel_util as ku


class VocabParallelCrossEntropy(ku.OpaqueFunction):
    """Per-position loss (target's shape, fp32) with the JAX residuals."""

    @staticmethod
    def forward(ctx, logits, target):
        x32 = logits.float()
        logits_max = x32.amax(dim=-1)
        x32 = x32 - logits_max[..., None]
        predicted = torch.gather(x32, -1, target[..., None])[..., 0]
        log_sum_exp = torch.log(torch.exp(x32).sum(dim=-1))
        ctx.save_for_backward(logits, logits_max, log_sum_exp, target)
        return log_sum_exp - predicted

    @staticmethod
    def backward(ctx, g):
        logits, logits_max, log_sum_exp, target = ctx.saved_tensors
        softmax = torch.exp(logits.float() - logits_max[..., None]
                            - log_sum_exp[..., None])
        softmax.scatter_add_(-1, target[..., None],
                             torch.full_like(target[..., None], -1.0,
                                             dtype=softmax.dtype))
        grad = softmax * g[..., None].float()
        return grad.to(logits.dtype), None


def vocab_parallel_cross_entropy(logits, target):
    """Per-position cross-entropy (same shape as ``target``), fp32.

    ``logits``: (..., vocab) in the model dtype; ``target``: (...) integer
    ids. The single-device form: the max, target-logit and partition-sum
    all-reduces over the tp axis are identities at tp=1.
    """
    return VocabParallelCrossEntropy.apply(logits, target.long())
