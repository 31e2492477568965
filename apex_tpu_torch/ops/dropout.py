"""Hidden dropout keyed by JAX's threefry: a plain PyTorch version + the
CUDA kernel (no TPU kernel: JAX computes it in XLA).

:func:`hidden_dropout` is the JAX models' ``_hidden_dropout``
(``apex_tpu/transformer/testing/standalone_gpt.py``)::

    keep = jax.random.bernoulli(key, 1 - rate, x.shape)
    y = where(keep, x * (1 / (1 - rate)), 0)          # in x's dtype

with the key a threefry ``uint32[2]`` held on the host
(``transformer.tensor_parallel.random``). Element j of x keeps its value
where ``bits_j >> 9 < T``: ``bits_j`` is JAX's partitionable draw, b0 ^ b1
of threefry2x32(key, (j >> 32, j & 0xFFFFFFFF)), and T =
ceil(float32(1 - rate) · 2**23) (:func:`~apex_tpu_torch.transformer.
tensor_parallel.random.keep_threshold`), which is JAX's fp32 ``uniform <
p`` exactly. The scale is JAX's weakly typed Python float: fp32 for fp32
x, rounded once to bf16 for bf16 x (1.109375 at rate 0.1), and the product
rounded to x's type.

The backward is the same function of dy with the same key (the mask is
a function of (key, index)), so nothing is saved but the key. CUDA tensors
launch ``csrc/dropout.cu`` (counted as ``hidden_dropout``, one launch a
forward and one a backward), CPU tensors run
:func:`hidden_dropout_reference`, the draw in torch int64 arithmetic.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.transformer.tensor_parallel.random import (
    _key_ints,
    keep_threshold,
    random_bits_tensor,
)

# device, x, y, n, k0, k1, threshold, scale, dtype code, stream
_SIGNATURES = {
    "hidden_dropout": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p],
}


def _round_to_bf16(v: float) -> float:
    """A Python float rounded once, to nearest even, to bfloat16's 8
    significant bits (the weakly typed scalar's conversion in JAX)."""
    if v == 0.0 or not math.isfinite(v):
        return v
    m, e = math.frexp(v)
    return math.ldexp(round(m * 256.0), e - 8)


def dropout_scale(rate: float, dtype: torch.dtype) -> float:
    """``1 / (1 - rate)`` as x's type holds it: fp32, bf16 or fp16 (the
    weakly typed scalar's conversion in JAX, rounded once)."""
    s = 1.0 / (1.0 - rate)
    if dtype == torch.bfloat16:
        return _round_to_bf16(s)
    if dtype == torch.float16:
        return float(np.float16(s))
    return float(np.float32(s))


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")


def hidden_dropout_reference(x: torch.Tensor, rate: float, key
                             ) -> torch.Tensor:
    """Plain version: the keep mask from the int64 threefry draw over x's
    flat index, ``where(keep, x * scale, 0)`` in x's type."""
    _check_rate(rate)
    bits = random_bits_tensor(key, x.numel(), device=x.device)
    keep = ((bits >> 9) < keep_threshold(1.0 - rate)).view(x.shape)
    return torch.where(keep, x * dropout_scale(rate, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def hidden_dropout_fwd(x: torch.Tensor, rate: float, key) -> torch.Tensor:
    """Launch the dropout kernel on a CUDA tensor: a new tensor of x's
    shape and type."""
    _check_rate(rate)
    ku.require(x.is_cuda and x.dtype in ku.KERNEL_DTYPES,
               f"hidden_dropout takes fp32, bf16 or fp16 CUDA tensors, got "
               f"{x.dtype} on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # 16-byte vector loads
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    k0, k1 = _key_ints(key)
    lib = ku.load_kernel("dropout", _SIGNATURES)
    status = lib.hidden_dropout(
        x.device.index, x.data_ptr(), y.data_ptr(), n, k0, k1,
        keep_threshold(1.0 - rate), dropout_scale(rate, x.dtype),
        ku.dtype_code(x.dtype), ku.stream_handle(x))
    ku.count_launch("hidden_dropout")
    ku.check_status(lib, status, "hidden_dropout")
    return y


def _apply(x, rate, key):
    if ku.use_kernel(x):
        return hidden_dropout_fwd(x, rate, key)
    return hidden_dropout_reference(x, rate, key)


class HiddenDropout(ku.OpaqueFunction):
    """JAX's ``_hidden_dropout`` and its vjp: dx = the same dropout of dy
    (same key, same index), so the mask is never stored."""

    @staticmethod
    def forward(ctx, x, rate, key):
        ctx.rate, ctx.key = rate, key
        return _apply(x, rate, key)

    @staticmethod
    def backward(ctx, dy):
        return _apply(dy.contiguous(), ctx.rate, ctx.key), None, None


def hidden_dropout(x: torch.Tensor, rate: float, key) -> torch.Tensor:
    """Dropout of x at ``rate`` under the threefry ``key`` (a ``uint32[2]``
    numpy array), bitwise JAX's ``_hidden_dropout``; differentiable."""
    _check_rate(rate)
    return HiddenDropout.apply(x, float(rate), np.asarray(key, np.uint32))
