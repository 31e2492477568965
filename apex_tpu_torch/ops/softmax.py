"""Fused scale + mask + softmax, Megatron's softmax functions (counterpart
of ``apex_tpu/ops/softmax.py``).

JAX computes these in XLA, outside any Pallas kernel, as a scale -> mask
-> softmax chain with a ``custom_vjp`` whose backward works from the saved
softmax output (the reference kernels' memory trade). The port is the same
chain in PyTorch, with the same backward as a ``torch.autograd.Function``:
the output is saved, not the input, and ``dx = (dy - Σ dy·y) · y · scale``
in fp32. Masked positions are filled with ``MASK_FILL`` = -10000.0 before
the softmax, as the reference kernels fill them. No sequence-length limit.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _kernel_util as ku

MASK_FILL = -10000.0


def _softmax_last(x32: torch.Tensor) -> torch.Tensor:
    m = x32.amax(dim=-1, keepdim=True)
    e = torch.exp(x32 - m)
    return e / e.sum(dim=-1, keepdim=True)


def _softmax_bwd_from_output(y, dy):
    """dx = (dy - Σ dy·y) · y, in fp32 (the reference kernels' backward)."""
    y32, dy32 = y.float(), dy.float()
    return (dy32 - (dy32 * y32).sum(dim=-1, keepdim=True)) * y32


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    q = torch.arange(sq, device=device)[:, None]
    k = torch.arange(sk, device=device)[None, :]
    return k > q


class _ScaledMaskedSoftmax(ku.OpaqueFunction):

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        x32 = x.float() * scale
        fill = None
        if causal:
            fill = _causal_mask(x.shape[-2], x.shape[-1], x.device)
        if mask is not None:
            fill = mask if fill is None else fill | mask
        if fill is not None:
            x32 = torch.where(fill, MASK_FILL, x32)
        y = _softmax_last(x32).to(x.dtype)
        ctx.save_for_backward(y)
        ctx.scale, ctx.causal = scale, causal
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        dx = _softmax_bwd_from_output(y, dy) * ctx.scale
        if ctx.causal:
            # the masked triangle's gradient is zeroed, as the reference
            # kernel zeroes it
            dx = torch.where(_causal_mask(y.shape[-2], y.shape[-1],
                                          y.device), 0.0, dx)
        return dx.to(y.dtype), None, None, None


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0) -> torch.Tensor:
    """softmax(scale · x, masked by ``mask``) over the last axis, in x's
    type. ``mask``: broadcastable boolean, True = masked out (filled with
    -10000 before the softmax), or None."""
    return _ScaledMaskedSoftmax.apply(x, mask, float(scale), False)


def scaled_upper_triang_masked_softmax(x: torch.Tensor, scale: float = 1.0
                                       ) -> torch.Tensor:
    """The causal variant over (..., sq, sk): (q, k) with k > q is masked,
    and its gradient is zero."""
    return _ScaledMaskedSoftmax.apply(x, None, float(scale), True)


def scaled_softmax(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The variant with no mask."""
    return scaled_masked_softmax(x, None, scale)
