"""flax's layers as ``nn.Module``s (the pieces ``models`` is built from):
``Conv``, ``ConvTranspose``, ``Dense`` and ``BatchNorm`` with flax's
parameter names, NHWC in and out, flax's arithmetic.

Layouts. A conv kernel is kept in PyTorch's (out, in, kh, kw), flax's
(kh, kw, in, out) transposed; a transposed conv's in PyTorch's (in, out,
kh, kw), flax's flipped in both spatial dims (flax's ``ConvTranspose``,
``lax.conv_transpose`` with ``transpose_kernel=False``, correlates the
stride-dilated input with the kernel as it is, where
``F.conv_transpose2d`` correlates it with the flipped kernel);
``convert.module_from_numpy`` moves flax's arrays across through each
module's ``from_flax`` (``to_flax`` is its inverse). A Dense kernel keeps
flax's (in, out). Inside, activations are NCHW views of the NHWC tensors
(``channels_last`` memory, no copy) for cuDNN.

Padding. lax's ``"SAME"`` pads max((⌈n/s⌉ − 1)·s + k − n, 0) in all,
the odd one on the high side: a 7×7/2 conv on 224 pads (2, 3), a 3×3/2
on 56 (0, 1), a 3×3/2 max pool on 112 (0, 1) with −inf. PyTorch's
symmetric ``padding=`` keeps the output size but shifts the window, so
these pad explicitly. A transposed conv takes lax's own padding
(``_conv_transpose_padding``) as PyTorch's ``padding`` and
``output_padding``.

Types. Each layer computes in ``dtype`` (flax's ``dtype``: inputs and
params cast to it), or, when ``None``, in the promoted type of its
inputs and params, as flax's ``promote_dtype`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch._device import DeviceLike, resolve_device


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax's ``"SAME"`` (low, high) padding of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """lax's ``_conv_transpose_padding``: (before, after) padding of the
    stride-dilated input, for ``"SAME"`` or ``"VALID"``."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
    return pad_a, pad_len - pad_a


def _compute_type(dtype, *ts):
    if dtype is not None:
        return dtype
    out = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            out = torch.promote_types(out, t.dtype)
    return out


def _lecun_normal(shape, fan_in, gen, dtype, dev):
    # flax's default kernel init, drawn from a torch generator (not JAX's
    # bits: parity tests carry JAX's arrays across)
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    return t.to(dtype=dtype, device=dev)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC input: param ``kernel`` (out, in, kh, kw)
    and, with ``use_bias``, ``bias``; ``padding`` "SAME" or "VALID"."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides=1,
                 padding: str = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kh, kw = _pair(kernel_size)
        self.strides, self.padding, self.dtype = _pair(strides), padding, dtype
        self.kernel = nn.Parameter(_lecun_normal(
            (features, in_features, kh, kw), in_features * kh * kw,
            generator, torch.float32, dev))
        self.bias = (nn.Parameter(torch.zeros(features, device=dev))
                     if use_bias else None)

    @staticmethod
    def from_flax(name: str, a: np.ndarray) -> np.ndarray:
        return a.transpose(3, 2, 0, 1) if name == "kernel" else a

    @staticmethod
    def to_flax(name: str, a: np.ndarray) -> np.ndarray:
        return a.transpose(2, 3, 1, 0) if name == "kernel" else a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_type(self.dtype, x, self.kernel, self.bias)
        xc = x.to(dt).permute(0, 3, 1, 2)           # NCHW view of NHWC
        kh, kw = self.kernel.shape[2:]
        if self.padding == "SAME":
            (t, b), (l, r) = (same_pads(xc.shape[2], kh, self.strides[0]),
                              same_pads(xc.shape[3], kw, self.strides[1]))
        else:
            t = b = l = r = 0
        if (t, l) == (b, r):
            pad = (t, l)
        else:
            xc = F.pad(xc, (l, r, t, b))
            pad = 0
        w = self.kernel.to(dt).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(xc, w, None if self.bias is None else self.bias.to(dt),
                     self.strides, pad)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``) on NHWC
    input: param ``kernel`` (in, out, kh, kw), flax's flipped; ``padding``
    "SAME" or "VALID"."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides=1,
                 padding: str = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kh, kw = _pair(kernel_size)
        self.strides, self.padding, self.dtype = _pair(strides), padding, dtype
        self.kernel = nn.Parameter(_lecun_normal(
            (in_features, features, kh, kw), in_features * kh * kw,
            generator, torch.float32, dev))
        self.bias = (nn.Parameter(torch.zeros(features, device=dev))
                     if use_bias else None)

    @staticmethod
    def from_flax(name: str, a: np.ndarray) -> np.ndarray:
        if name != "kernel":
            return a
        return np.ascontiguousarray(a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])

    @staticmethod
    def to_flax(name: str, a: np.ndarray) -> np.ndarray:
        if name != "kernel":
            return a
        return np.ascontiguousarray(a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_type(self.dtype, x, self.kernel, self.bias)
        xc = x.to(dt).permute(0, 3, 1, 2)
        # lax pads the dilated input (a, b); PyTorch's padding P pads it
        # (k - 1 - P) on both sides and output_padding adds to the high
        # side: P = k - 1 - a, the high side's b - a added (b > a) or
        # cropped (b < a)
        pads, extra, crop = [], [], []
        for k, s in zip(self.kernel.shape[2:], self.strides):
            a, b = conv_transpose_pads(k, s, self.padding)
            if not (0 <= k - 1 - a and b - a < s):
                raise ValueError(f"ConvTranspose: lax padding ({a}, {b}) at "
                                 f"kernel {k}, stride {s} has no PyTorch form")
            pads.append(k - 1 - a)
            extra.append(max(b - a, 0))
            crop.append(max(a - b, 0))
        w = self.kernel.to(dt).contiguous(memory_format=torch.channels_last)
        y = F.conv_transpose2d(
            xc, w, None if self.bias is None else self.bias.to(dt),
            self.strides, tuple(pads), tuple(extra))
        if any(crop):
            y = y[:, :, :y.shape[2] - crop[0], :y.shape[3] - crop[1]]
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), ``bias``."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.kernel = nn.Parameter(_lecun_normal(
            (in_features, features), in_features, generator, torch.float32,
            dev))
        self.bias = (nn.Parameter(torch.zeros(features, device=dev))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_type(self.dtype, x, self.kernel, self.bias)
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` on channel-last input (its defaults: decay
    momentum 0.99, eps 1e-5; not ``nn.BatchNorm2d``): statistics in fp32,
    var = E[x²] − E[x]² clamped at 0, the running var the batch's biased
    one; y = (x − mean) · (rsqrt(var + eps) · scale) + bias in fp32, out
    in the promoted type of x and the params. Params ``scale``, ``bias``;
    buffers ``mean``, ``var`` (flax's ``batch_stats``)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        dims = tuple(range(x.dim() - 1))
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            x32 = x.float()
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        y = x.float() - mean
        y = y * (torch.rsqrt(var + self.epsilon) * self.scale.float())
        y = y + self.bias.float()
        out = torch.promote_types(torch.promote_types(x.dtype,
                                                      self.scale.dtype),
                                  self.bias.dtype)
        return y.to(out)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (w, w), (s, s), padding="SAME")`` on NHWC:
    lax's asymmetric padding with −inf."""
    xc = x.permute(0, 3, 1, 2)
    t, b = same_pads(xc.shape[2], window, stride)
    l, r = same_pads(xc.shape[3], window, stride)
    xc = F.pad(xc, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)
