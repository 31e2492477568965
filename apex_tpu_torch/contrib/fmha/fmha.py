"""Packed-varlen attention (counterpart of ``apex_tpu/contrib/fmha/fmha.py``).

Reference: ``apex/contrib/fmha/fmha.py:33-76`` — packed ``qkv``
(total, 3, heads, d) + ``cu_seqlens`` prefix sums. The packed batch maps to
the segment-id convention of :mod:`apex_tpu_torch.ops.attention_varlen`:
the varlen kernels mask cross-document pairs in-tile and skip the tiles
that cannot meet, with no sequence-length limit.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops.attention_varlen import flash_attention_varlen


def cu_seqlens_to_segment_ids(cu_seqlens, total: int):
    """[0, l1, l1+l2, ...] -> per-token document index, int32 (the ref's
    cu_seqlens convention). Tokens at/after the last boundary get segment
    -1 (padding): they attend to nothing — including other padding — and
    output zero."""
    positions = torch.arange(total, device=cu_seqlens.device)
    # segment of token t = number of boundaries <= t, minus 1
    seg = (positions[:, None] >= cu_seqlens[None, :-1]).sum(dim=1) - 1
    pad = positions >= cu_seqlens[-1]
    return torch.where(pad, -1, seg).to(torch.int32)


def fmha_packed(qkv, cu_seqlens, *, causal: bool = False,
                scale: Optional[float] = None):
    """Attention over a packed batch.

    ``qkv``: (total_tokens, 3, heads, head_dim) — the reference's
    interleaved layout (``fmha.py:33``). ``cu_seqlens``: (batch+1,) int
    prefix sums, on any device. Returns (total_tokens, heads, head_dim);
    padding rows are zero. Differentiable in ``qkv``.
    """
    total, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(
            f"qkv must be (total, 3, heads, d), got {tuple(qkv.shape)}")
    seg = cu_seqlens_to_segment_ids(
        torch.as_tensor(cu_seqlens, device=qkv.device), total)[None]
    q, k, v = (qkv[:, i].transpose(0, 1)[None] for i in range(3))
    o = flash_attention_varlen(q, k, v, seg, causal=causal, scale=scale)
    return o[0].transpose(0, 1)


class FMHA(nn.Module):
    """Ref ``fmha.py:59-76`` — module wrapper around the packed op; no
    parameters."""

    def __init__(self, num_heads: int):
        super().__init__()
        self.num_heads = num_heads

    def forward(self, qkv, cu_seqlens, *, causal: bool = False):
        return fmha_packed(qkv, cu_seqlens, causal=causal)
