"""Fused dense layers, GEMM + bias and GEMM + bias + GELU + GEMM + bias
(counterpart of ``apex_tpu/fused_dense/fused_dense.py``).

JAX leaves the epilogues to XLA, outside any Pallas kernel; the port's are
``torch.matmul`` and elementwise torch ops, with the reference's exact
(erf) GELU. The modules keep the flax parameter names and layout —
``kernel`` (in, out) and ``bias``; ``kernel1``, ``bias1``, ``kernel2``,
``bias2`` — so a JAX module's parameters carry over through
:func:`apex_tpu_torch.convert.module_from_numpy`. PyTorch modules need
their input width up front, where flax reads it from the first input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def fused_dense(x, kernel, bias=None):
    dt = torch.promote_types(x.dtype, kernel.dtype)
    y = x.to(dt) @ kernel.to(dt)
    return y if bias is None else y + bias


def fused_dense_gelu_dense(x, kernel1, bias1, kernel2, bias2):
    h = F.gelu(fused_dense(x, kernel1, bias1), approximate="none")
    return fused_dense(h, kernel2, bias2)


def _lecun_normal(fan_in: int, fan_out: int, dtype, device):
    """flax's ``lecun_normal``: a normal truncated at ±2 std, its std
    sqrt(1 / fan_in) corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(fan_in, fan_out, dtype=dtype, device=device)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class FusedDense(nn.Module):
    """y = x @ kernel + bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal(in_features, features,
                                                 dtype, device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x):
        return fused_dense(x, self.kernel, self.bias)


class FusedDenseGeluDense(nn.Module):
    """y = gelu(x @ kernel1 + bias1) @ kernel2 + bias2, exact GELU."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel1 = nn.Parameter(_lecun_normal(
            in_features, intermediate_features, dtype, device))
        self.bias1 = nn.Parameter(torch.zeros(intermediate_features,
                                              dtype=dtype, device=device))
        self.kernel2 = nn.Parameter(_lecun_normal(
            intermediate_features, out_features, dtype, device))
        self.bias2 = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))

    def forward(self, x):
        return fused_dense_gelu_dense(x, self.kernel1, self.bias1,
                                      self.kernel2, self.bias2)
