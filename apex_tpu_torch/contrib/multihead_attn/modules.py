"""Self and encoder-decoder multi-head attention with the optional
norm-add fusion (counterpart of
``apex_tpu/contrib/multihead_attn/modules.py``).

The attention core is the port's flash attention (kernels B #5-8 on the
card): without a mask, attention dropout runs inside the flash kernels
(the counter-hash keep mask, seeded by ``jax.random.bits(rng, uint32)``
as int32, computed here on the host with the port's threefry); with a
boolean mask the call takes the plain reference attention, and with
dropout there the keep mask is JAX's ``bernoulli`` over the
probabilities' shape, drawn on the tensors' device. An additive float
mask (``mask_additive``) is folded into the fp32 scores. The optional
pre-LayerNorm is the port's ``layer_norm`` (kernels B #1-4).

Layout: (batch, seq, embed), as the JAX modules take. The parameters
carry JAX's flax names and (in, out) shapes — ``in_proj_weight`` (e, 3e),
``q_weight`` (e, e), ``kv_weight`` (e, 2e), ``out_proj_weight`` (e, e),
their biases, ``ln_weight`` and ``ln_bias`` — so a JAX module's params
copy across with :func:`apex_tpu_torch.convert.module_from_numpy`.
Products run in the promoted type of their operands, as JAX's ``x @ w``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.transformer.tensor_parallel.random import (
    keep_threshold,
    random_bits,
    random_bits_tensor,
)

NEG_INF = -1e30


def _matmul(x, w):
    """``x @ w`` in the promoted type of the two, as JAX's promotes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def _split_heads(x, num_heads):
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def flash_dropout_seed(key) -> int:
    """JAX's ``jax.random.bits(rng, dtype=uint32).astype(int32)`` for a
    threefry key (``uint32[2]``): the flash kernels' dropout seed."""
    return int(np.asarray(random_bits(key, ()), np.uint32).astype(np.int32))


def bernoulli_keep(key, rate: float, shape, device) -> torch.Tensor:
    """JAX's ``jax.random.bernoulli(key, 1 - rate, shape)`` as a bool
    tensor on ``device``: the threefry bits of each flat index, kept where
    ``bits >> 9`` is below the threshold of ``1 - rate``."""
    n = int(np.prod(shape, dtype=np.int64))
    bits = random_bits_tensor(key, n, device=device)
    return ((bits >> 9) < keep_threshold(1.0 - rate)).view(shape)


def _dense_attention(q, k, v, mask, additive, scale, dropout_rate,
                     dropout_rng):
    """The fp32 dense path of JAX's ``_attend`` (an additive mask, or a
    boolean mask with dropout): scores, masks, softmax, the bernoulli
    keep mask, context in q's type."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if additive is not None:
        s = s + additive.float()
    if mask is not None:
        s = torch.where(mask, NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = bernoulli_keep(dropout_rng, dropout_rate, tuple(p.shape),
                              p.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.matmul(p, v.float()).to(q.dtype)


def _attend(q, k, v, *, key_padding_mask, attn_mask, mask_additive,
            dropout_rate, deterministic, dropout_rng, scale):
    """JAX's ``_attend``: ``key_padding_mask`` (b, sk) True = pad;
    ``attn_mask`` (sq, sk) True = masked, or an additive float mask with
    ``mask_additive``."""
    drop = dropout_rate if dropout_rate > 0.0 and not deterministic else 0.0
    if drop and dropout_rng is None:
        raise ValueError("dropout in training needs dropout_rng (a threefry "
                         "key, uint32[2])")
    if mask_additive and attn_mask is not None:
        kpm = (None if key_padding_mask is None
               else key_padding_mask[:, None, None, :])
        return _dense_attention(q, k, v, kpm, attn_mask, scale, drop,
                                dropout_rng)
    mask = None
    if key_padding_mask is not None:
        mask = key_padding_mask[:, None, None, :]
    if attn_mask is not None:
        am = attn_mask[None, None, :, :]
        mask = am if mask is None else (mask | am)
    if drop:
        if mask is None:
            return flash_attention(q, k, v, scale=scale, dropout_rate=drop,
                                   dropout_seed=flash_dropout_seed(
                                       dropout_rng))
        return _dense_attention(q, k, v, mask, None, scale, drop,
                                dropout_rng)
    return flash_attention(q, k, v, mask=mask, scale=scale)


def _fan_in_normal(shape, dtype, device, generator):
    """flax's ``variance_scaling(1.0, "fan_in", "normal")`` for an (in,
    out) kernel: normal with std sqrt(1 / in)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w / math.sqrt(shape[0])).to(device=device, dtype=dtype)


class _MultiheadBase(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 bias: bool, include_norm_add: bool, mask_additive: bool,
                 param_dtype: torch.dtype, device, seed: int):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.bias = float(dropout), bias
        self.include_norm_add = include_norm_add
        self.mask_additive = mask_additive
        self._dtype = param_dtype
        self._device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(seed)
        if include_norm_add:
            self.ln_weight = nn.Parameter(self._full(embed_dim, 1.0))
            self.ln_bias = nn.Parameter(self._full(embed_dim, 0.0))

    def _full(self, n, value):
        return torch.full((n,), value, dtype=self._dtype,
                          device=self._device)

    def _kernel(self, shape):
        return nn.Parameter(_fan_in_normal(shape, self._dtype, self._device,
                                           self._gen))

    def _norm(self, x):
        if not self.include_norm_add:
            return x
        return layer_norm(x, self.ln_weight, self.ln_bias)

    def _core(self, q, k, v, key_padding_mask, attn_mask, is_training,
              dropout_rng):
        q, k, v = (_split_heads(t, self.num_heads) for t in (q, k, v))
        return _merge_heads(_attend(
            q.contiguous(), k.contiguous(), v.contiguous(),
            key_padding_mask=key_padding_mask, attn_mask=attn_mask,
            mask_additive=self.mask_additive, dropout_rate=self.dropout,
            deterministic=not is_training, dropout_rng=dropout_rng,
            scale=1.0 / math.sqrt(self.embed_dim // self.num_heads)))

    def _out(self, ctx, residual):
        out = _matmul(ctx, self.out_proj_weight)
        if self.bias:
            out = out + self.out_proj_bias
        if self.include_norm_add:
            out = out + residual
        return out


class SelfMultiheadAttn(_MultiheadBase):
    """JAX's ``SelfMultiheadAttn``: one fused QKV product, the attention
    core, the out-projection; ``include_norm_add`` adds the pre-LayerNorm
    and the residual. ``forward(query, key_padding_mask=None,
    attn_mask=None, is_training=True, dropout_rng=None)``; dropout in
    training needs ``dropout_rng``, a threefry key."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 mask_additive: bool = False,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, mask_additive, param_dtype, device,
                         seed)
        e = embed_dim
        self.in_proj_weight = self._kernel((e, 3 * e))
        if bias:
            self.in_proj_bias = nn.Parameter(self._full(3 * e, 0.0))
        self.out_proj_weight = self._kernel((e, e))
        if bias:
            self.out_proj_bias = nn.Parameter(self._full(e, 0.0))

    def forward(self, query, key_padding_mask=None, attn_mask=None,
                is_training: bool = True, dropout_rng=None):
        qkv = _matmul(self._norm(query), self.in_proj_weight)
        if self.bias:
            qkv = qkv + self.in_proj_bias
        q, k, v = qkv.chunk(3, dim=-1)
        ctx = self._core(q, k, v, key_padding_mask, attn_mask, is_training,
                         dropout_rng)
        return self._out(ctx, query)


class EncdecMultiheadAttn(_MultiheadBase):
    """JAX's ``EncdecMultiheadAttn``: Q from the decoder stream, K and V
    from the encoder stream by one fused KV product. ``forward(query, key,
    key_padding_mask=None, attn_mask=None, is_training=True,
    dropout_rng=None)``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 mask_additive: bool = False,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, mask_additive, param_dtype, device,
                         seed)
        e = embed_dim
        self.q_weight = self._kernel((e, e))
        self.kv_weight = self._kernel((e, 2 * e))
        if bias:
            self.q_bias = nn.Parameter(self._full(e, 0.0))
            self.kv_bias = nn.Parameter(self._full(2 * e, 0.0))
        self.out_proj_weight = self._kernel((e, e))
        if bias:
            self.out_proj_bias = nn.Parameter(self._full(e, 0.0))

    def forward(self, query, key, key_padding_mask=None, attn_mask=None,
                is_training: bool = True, dropout_rng=None):
        q = _matmul(self._norm(query), self.q_weight)
        kv = _matmul(key, self.kv_weight)
        if self.bias:
            q = q + self.q_bias
            kv = kv + self.kv_bias
        k, v = kv.chunk(2, dim=-1)
        ctx = self._core(q, k, v, key_padding_mask, attn_mask, is_training,
                         dropout_rng)
        return self._out(ctx, query)
