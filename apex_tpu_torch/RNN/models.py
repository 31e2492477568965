"""Fused-gate RNN cells and their stacked / bidirectional wrapper
(counterpart of ``apex_tpu/RNN/models.py``), layout (batch, time,
features), flax's parameter names: a layer ``layer_<i>`` (and
``layer_<i>_rev`` when bidirectional) holds ``w_ih`` (in, gates·hidden),
``w_hh`` (hidden, gates·hidden) and ``bias``; the mLSTM adds ``w_mx`` and
``w_mh``.

The input GEMM runs once over the whole sequence (one large product);
a Python loop over time takes the place of JAX's ``lax.scan``, each step
one (batch, hidden) x (hidden, gates·hidden) product and the gate math.
The products are cuBLAS calls, as JAX leaves them to XLA: no TPU kernel
of the JAX package runs here. GRU is ``torch.nn.GRUCell``'s (JAX's): the
reset gate scales the hidden path's candidate term only, the one fused
bias on the input path. Dropout between stacked layers (training, rate >
0) draws JAX's threefry bits on the device from ``dropout_key`` folded
with the layer's index (``transformer.tensor_parallel.random``): bitwise
``jax.random.bernoulli(fold_in(key, layer), 1 - rate, shape)``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.transformer.tensor_parallel import random as tp_random


def _lecun_normal(shape, gen, dtype, dev):
    # flax's lecun_normal (fan in: the first dim), from a torch generator
    std = 1.0 / math.sqrt(shape[0]) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    return t.to(dtype=dtype, device=dev)


def _lstm_step(xg, hg, carry):
    h, c = carry
    i, f, g, o = torch.chunk(xg + hg, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    h_new = o * torch.tanh(c_new)
    return (h_new, c_new), h_new


def _gru_step(xg, hg, carry):
    (h,) = carry
    xr, xz, xn = torch.chunk(xg, 3, dim=-1)
    hr, hz, hn = torch.chunk(hg, 3, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    h_new = (1 - z) * n + z * h
    return (h_new,), h_new


def _rnn_step(act: Callable):
    def step(xg, hg, carry):
        h_new = act(xg + hg)
        return (h_new,), h_new
    return step


class _Cell(nn.Module):
    """One recurrent layer over time: ``gates`` x hidden fused gate
    columns, ``carry_size`` state tensors (h; or h, c)."""

    def __init__(self, input_size: int, hidden_size: int, gates: int,
                 step_fn: Callable, carry_size: int, dtype, dev, gen):
        super().__init__()
        g = gates * hidden_size
        self.hidden_size, self.step_fn = hidden_size, step_fn
        self.carry_size = carry_size
        self.w_ih = nn.Parameter(_lecun_normal((input_size, g), gen, dtype,
                                               dev))
        self.w_hh = nn.Parameter(_lecun_normal((hidden_size, g), gen, dtype,
                                               dev))
        self.bias = nn.Parameter(torch.zeros(g, dtype=dtype, device=dev))

    def forward(self, x, init_carry=None):
        b = x.shape[0]
        carry = init_carry or tuple(
            torch.zeros(b, self.hidden_size, dtype=self.w_hh.dtype,
                        device=x.device) for _ in range(self.carry_size))
        xg = x @ self.w_ih + self.bias        # the whole sequence at once
        ys = []
        for t in range(x.shape[1]):
            carry, y = self.step_fn(xg[:, t], carry[0] @ self.w_hh, carry)
            ys.append(y)
        return torch.stack(ys, dim=1), carry


class _Stacked(nn.Module):
    """JAX's stacked / bidirectional wrapper: ``x`` (B, T, in) -> (B, T,
    hidden, or 2 hidden bidirectional)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 gates: int, step_fn: Callable, carry_size: int,
                 bidirectional: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.dropout = dropout
        width = input_size
        for layer in range(num_layers):
            self.add_module(f"layer_{layer}", _Cell(
                width, hidden_size, gates, step_fn, carry_size, dtype, dev,
                gen))
            if bidirectional:
                self.add_module(f"layer_{layer}_rev", _Cell(
                    width, hidden_size, gates, step_fn, carry_size, dtype,
                    dev, gen))
            width = hidden_size * (2 if bidirectional else 1)

    def forward(self, x, deterministic: bool = True, dropout_key=None):
        h = x
        for layer in range(self.num_layers):
            fwd, _ = getattr(self, f"layer_{layer}")(h)
            if self.bidirectional:
                bwd, _ = getattr(self, f"layer_{layer}_rev")(h.flip(1))
                h = torch.cat([fwd, bwd.flip(1)], dim=-1)
            else:
                h = fwd
            if (self.dropout > 0 and not deterministic
                    and layer < self.num_layers - 1):
                if dropout_key is None:
                    raise ValueError("RNN dropout in training needs a "
                                     "dropout_key (a threefry uint32[2])")
                h = _dropout(h, self.dropout,
                             tp_random.fold_in(dropout_key, layer))
        return h


def _dropout(x, rate: float, key):
    """flax's ``nn.Dropout``: keep = bernoulli(key, 1 - rate), x / (1 -
    rate) where kept, else 0; the draw is JAX's threefry on the device."""
    keep_prob = 1.0 - rate
    bits = tp_random.random_bits_tensor(key, x.numel(), x.device)
    keep = ((bits >> 9) < tp_random.keep_threshold(keep_prob)).reshape(
        x.shape)
    return torch.where(keep, x / torch.tensor(keep_prob, dtype=x.dtype,
                                              device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def LSTM(input_size: int, hidden_size: int, num_layers: int = 1,
         bidirectional: bool = False, dropout: float = 0.0,
         dtype: torch.dtype = torch.float32, device: DeviceLike = None,
         seed: int = 0) -> _Stacked:
    return _Stacked(input_size, hidden_size, num_layers, 4, _lstm_step, 2,
                    bidirectional, dropout, dtype, device, seed)


def GRU(input_size: int, hidden_size: int, num_layers: int = 1,
        bidirectional: bool = False, dropout: float = 0.0,
        dtype: torch.dtype = torch.float32, device: DeviceLike = None,
        seed: int = 0) -> _Stacked:
    return _Stacked(input_size, hidden_size, num_layers, 3, _gru_step, 1,
                    bidirectional, dropout, dtype, device, seed)


def RNNTanh(input_size: int, hidden_size: int, num_layers: int = 1,
            bidirectional: bool = False, dropout: float = 0.0,
            dtype: torch.dtype = torch.float32, device: DeviceLike = None,
            seed: int = 0) -> _Stacked:
    return _Stacked(input_size, hidden_size, num_layers, 1,
                    _rnn_step(torch.tanh), 1, bidirectional, dropout, dtype,
                    device, seed)


def RNNReLU(input_size: int, hidden_size: int, num_layers: int = 1,
            bidirectional: bool = False, dropout: float = 0.0,
            dtype: torch.dtype = torch.float32, device: DeviceLike = None,
            seed: int = 0) -> _Stacked:
    return _Stacked(input_size, hidden_size, num_layers, 1,
                    _rnn_step(torch.relu), 1, bidirectional, dropout, dtype,
                    device, seed)


class _MLSTMCell(nn.Module):
    """Multiplicative LSTM: m = (x W_mx) * (h W_mh) takes h's place in the
    gate block's hidden product. ``x`` (B, T, in) -> (ys (B, T, hidden),
    (h, c))."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        hs = hidden_size
        self.hidden_size = hs
        self.w_ih = nn.Parameter(_lecun_normal((input_size, 4 * hs), gen,
                                               dtype, dev))
        self.w_hh = nn.Parameter(_lecun_normal((hs, 4 * hs), gen, dtype,
                                               dev))
        self.w_mx = nn.Parameter(_lecun_normal((input_size, hs), gen, dtype,
                                               dev))
        self.w_mh = nn.Parameter(_lecun_normal((hs, hs), gen, dtype, dev))
        self.bias = nn.Parameter(torch.zeros(4 * hs, dtype=dtype,
                                             device=dev))

    def forward(self, x, init_carry: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        b, hs = x.shape[0], self.hidden_size
        carry = tuple(init_carry) if init_carry is not None else tuple(
            torch.zeros(b, hs, dtype=self.w_hh.dtype, device=x.device)
            for _ in range(2))
        xg = x @ self.w_ih + self.bias
        xm = x @ self.w_mx
        ys = []
        for t in range(x.shape[1]):
            m = xm[:, t] * (carry[0] @ self.w_mh)
            carry, y = _lstm_step(xg[:, t], m @ self.w_hh, carry)
            ys.append(y)
        return torch.stack(ys, dim=1), carry


def mLSTM(input_size: int, hidden_size: int,
          dtype: torch.dtype = torch.float32, device: DeviceLike = None,
          seed: int = 0) -> _MLSTMCell:
    return _MLSTMCell(input_size, hidden_size, dtype, device, seed)
