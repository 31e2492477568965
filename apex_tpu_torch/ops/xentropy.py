"""Softmax cross-entropy with label smoothing (counterpart of
``apex_tpu/ops/xentropy.py``).

JAX computes it in XLA with a ``custom_vjp`` that saves one log-sum-exp a
row and recomputes the softmax from it in the backward, the reference
``xentropy_cuda`` kernel's memory trade. The port is the same as a
``torch.autograd.Function``: the forward saves the logits, labels and the
fp32 lse; the backward forms ``(exp(x - lse) - target) · dloss``, target
the one-hot label smoothed by ``smoothing / V`` (formed by a compare, with
no int64 one-hot of the logits' size).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import _kernel_util as ku


class _SoftmaxCrossEntropy(ku.OpaqueFunction):

    @staticmethod
    def forward(ctx, logits, labels, smoothing, half_to_float):
        x = logits.float()
        m = x.amax(dim=-1, keepdim=True)
        lse = (torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True))
               + m)[..., 0]
        picked = torch.gather(x, -1, labels[..., None].long())[..., 0]
        if smoothing > 0.0:
            nll = (lse - (1.0 - smoothing) * picked
                   - smoothing * x.mean(dim=-1))
        else:
            nll = lse - picked
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        return nll.to(torch.float32 if half_to_float else logits.dtype)

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        x = logits.float()
        n = x.shape[-1]
        p = torch.exp(x - lse[..., None])
        # JAX's (1 - s)·onehot + s/n in fp32, without an int64 one-hot:
        # f32(1 - s) + f32(s/n) at the label, f32(s/n) elsewhere
        s = ctx.smoothing
        off = torch.tensor(s / n if s > 0.0 else 0.0, dtype=torch.float32,
                           device=x.device)
        on = torch.tensor(1.0 - s, dtype=torch.float32, device=x.device) + off
        hit = (torch.arange(n, device=x.device)
               == labels[..., None].to(torch.int64))
        target = torch.where(hit, on, off)
        dx = (p - target) * dloss.float()[..., None]
        return dx.to(logits.dtype), None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               half_to_float: bool = False) -> torch.Tensor:
    """Per-example loss over (N, V) logits and (N,) int labels: ``lse -
    (1 - s)·logit[label] - s·mean(logits)`` with smoothing s, in the
    logits' type (fp32 with ``half_to_float``)."""
    return _SoftmaxCrossEntropy.apply(logits, labels, float(smoothing),
                                      bool(half_to_float))
