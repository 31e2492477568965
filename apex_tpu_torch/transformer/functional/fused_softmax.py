"""FusedScaleMaskSoftmax, the softmax-selection module (counterpart of
``apex_tpu/transformer/functional/fused_softmax.py``).

As in JAX, the "fused" path is :mod:`apex_tpu_torch.ops.softmax` (the
backward from the saved output, any sequence length), taken when fusion is
asked for and the input is fp16 / bf16; otherwise the unfused path: an
optional fp32 upcast, the scale, the mask through ``mask_func`` (or the
-10000 fill), ``torch.softmax``, and the downcast.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.softmax import (
    MASK_FILL,
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.enums import AttnMaskType


class FusedScaleMaskSoftmax:
    """Callable module: ``softmax(input, mask) -> probs`` over (b, np, sq,
    sk) scores, with JAX's constructor checks and gate."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None) -> None:
        if input_in_fp16 and input_in_bf16:
            raise ValueError("both fp16 and bf16 flags cannot be active")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if scale is not None and not softmax_in_fp32:
            raise ValueError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """JAX's gate: fusion asked for and a half-precision input (no
        shape limits)."""
        return self.scaled_masked_softmax_fusion and self.input_in_float16

    def __call__(self, input: torch.Tensor, mask=None) -> torch.Tensor:
        b, np_, sq, sk = input.shape
        if self.is_kernel_available(mask, b, np_, sq, sk):
            return self.forward_fused_softmax(input, mask)
        return self.forward_torch_softmax(input, mask)

    def forward_fused_softmax(self, input, mask):
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            if input.shape[2] != input.shape[3]:
                raise ValueError("causal mask is only for self attention")
            b, np_, sq, sk = input.shape
            out = scaled_upper_triang_masked_softmax(
                input.reshape(b * np_, sq, sk), scale)
            return out.reshape(b, np_, sq, sk)
        return scaled_masked_softmax(input, mask, scale)

    def forward_torch_softmax(self, input, mask):
        orig_dtype = input.dtype
        if self.input_in_float16 and self.softmax_in_fp32:
            input = input.float()
        if self.scale is not None:
            input = input * self.scale
        if mask is not None:
            if self.mask_func is not None:
                input = self.mask_func(input, mask)
            else:
                input = torch.where(mask, MASK_FILL, input)
        probs = torch.softmax(input, dim=-1)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(orig_dtype)
        return probs
