"""Attention reference math (counterpart of ``apex_tpu/ops/attention.py``).

Only the plain reference is ported so far; the flash-attention kernels
(``_fa_fwd``/``_fa_bwd``) belong to the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# Finite stand-in for -inf: keeps exp() exact zero without nan from
# (-inf) - (-inf).
NEG_INF = -1e30


def attention_reference(q, k, v, mask=None, scale: Optional[float] = None,
                        causal: bool = False):
    """Plain softmax(Q Kᵀ · scale) V with fp32 accumulation (the JAX
    ``attention_reference`` without dropout or bias).

    ``mask``: boolean broadcastable over (..., sq, sk), True = masked OUT.
    Returns q.dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = torch.einsum("...qd,...kd->...qk", q32, k32) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(sq, device=s.device)[:, None]
        kpos = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(kpos > qpos + (sk - sq), NEG_INF, s)
    if mask is not None:
        s = torch.where(mask, NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("...qk,...kd->...qd", p, v32)
    return o.to(q.dtype)
