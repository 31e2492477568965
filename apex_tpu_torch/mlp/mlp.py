"""The fused MLP (counterpart of ``apex_tpu/mlp/mlp.py``): a chain of
GEMM + bias + activation.

JAX leaves the chain to XLA, outside any Pallas kernel, so the port's is
``torch.matmul`` and elementwise torch ops. The module keeps the JAX
constructor (``mlp_sizes``, ``bias``, ``activation`` in none / relu /
sigmoid, applied on the hidden layers only) and the flax parameter names,
``kernel_i`` (in, out) and ``bias_i``, so a JAX module's parameters carry
over through :func:`apex_tpu_torch.convert.module_from_numpy`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

_ACTS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def _promoted(x, w):
    """x and w in their promoted type, as JAX's ``x @ w`` promotes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def mlp_forward(x, kernels, biases=None, activation: str = "relu"):
    """``kernels``: (in, out) matrices; the activation follows every layer
    but the last."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(_ACTS)}")
    act = _ACTS[activation]
    h = x
    n = len(kernels)
    for i, k in enumerate(kernels):
        h, k = _promoted(h, k)
        h = h @ k
        if biases is not None:
            h = h + biases[i]
        if i < n - 1:
            h = act(h)
    return h


class MLP(nn.Module):
    """``MLP([in, h1, ..., out], bias=True, activation="relu")``. Kernels
    start uniform in ±sqrt(3 / fan_in) (flax's ``variance_scaling(1,
    "fan_in", "uniform")``), biases at zero."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        sizes = list(mlp_sizes)
        if len(sizes) < 2:
            raise ValueError("mlp_sizes needs at least [in, out]")
        if activation not in _ACTS:
            raise ValueError(f"activation must be one of {sorted(_ACTS)}")
        self.mlp_sizes, self.bias, self.activation = sizes, bias, activation
        self.num_layers = len(sizes) - 1
        for i in range(self.num_layers):
            bound = math.sqrt(3.0 / sizes[i])
            k = torch.empty(sizes[i], sizes[i + 1], dtype=dtype,
                            device=device).uniform_(-bound, bound)
            self.register_parameter(f"kernel_{i}", nn.Parameter(k))
            if bias:
                self.register_parameter(f"bias_{i}", nn.Parameter(
                    torch.zeros(sizes[i + 1], dtype=dtype, device=device)))

    def forward(self, x):
        n = self.num_layers
        kernels = [getattr(self, f"kernel_{i}") for i in range(n)]
        biases = ([getattr(self, f"bias_{i}") for i in range(n)]
                  if self.bias else None)
        return mlp_forward(x, kernels, biases, self.activation)
