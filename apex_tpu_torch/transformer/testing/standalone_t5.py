"""Standalone T5-style encoder-decoder (counterpart of
``apex_tpu/transformer/testing/standalone_t5.py`` at tp = pp = sp = 1):
config, relative position bias, parameters, and the single-device
sequential forward and loss.

The parameter tree keeps the JAX package's layout so weights carry across
one to one through :func:`apex_tpu_torch.convert.params_from_numpy`:

=================================  =====================================
``embed.tok``                      (vocab, hidden), shared by encoder,
                                   decoder and the tied LM head
``embed.pos_enc`` / ``pos_dec``    (max_seq, hidden), absolute positions
                                   (only without the relative bias)
``embed.rel_enc`` / ``rel_dec``    (buckets, heads), one relative-bias
                                   table per stack (with the bias)
``embed.enc_ln_w`` / ``enc_ln_b``  (hidden,), the encoder-final LayerNorm
                                   (with ``encoder_final_ln``)
``enc_layers.*`` (leading [Le])    LN, per-head interleaved QKV
                                   (head, {q,k,v}, head_dim), out-proj,
                                   MLP
``dec_layers.*`` (leading [Ld])    the encoder's leaves, plus
                                   cross-attention: ``q_kernel`` (hidden,
                                   hidden), ``kv_kernel`` (hidden,
                                   2·hidden) packed (head, {k,v},
                                   head_dim), ``xout_kernel``, ``ln3``
``head.ln_w`` / ``ln_b``           (hidden,)
=================================  =====================================

:func:`t5_loss` is JAX's sequential ``t5_loss``: the encoder stack, the
decoder stack (self-attention, cross-attention to the encoder's memory,
MLP; pre-LN residual blocks), a Python loop over each stack's stacked
layers, each under ``torch.utils.checkpoint`` when ``remat``, then the
fused LM head (kernels B #12-14 on the card) or LN + tied logits + CE.
With ``relative_position_bias`` every self-attention feeds a (heads, s,
s) fp32 logit bias, built once per stack from that stack's table, into
:func:`~apex_tpu_torch.ops.attention.flash_attention` (kernels B #5-8 on
the card); cross-attention carries none. With a ``dropout_key`` (a
threefry ``uint32[2]`` on the host) the model trains with JAX's dropout
sites and keys: the encoder under ``fold_in(key, 0)``, the decoder under
``fold_in(key, 1)``, each stack's embedding dropout under ``fold_in(·,
100)`` (101 for the decoder) then salt 0, layer i under ``fold_in(·,
i)``; in a layer the attention seeds from ``fold_in(k, 0)`` (self) and
``fold_in(k, 3)`` (cross), the hidden dropout after self-attention,
cross-attention and the MLP under ``fold_in(k, 1)``, ``fold_in(k, 4)``
and ``fold_in(k, 2)``. The pipeline and sharding
functions of the JAX module (``t5_param_specs``, ``t5_pipeline_params``,
``t5_pipeline_specs_tree``, ``t5_enc_dec_spec``) are multi-device and not
ported.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch._device import DeviceLike
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.dropout import hidden_dropout
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    attention_dropout_seed,
    checkpoint_saving,
    fold_in,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    _dense,
    _use_fused_loss,
    fused_head_loss,
    tied_vocab_logits,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5-small defaults (Raffel et al. 2020): vocab 32128, hidden 512, 8
    heads of 64, 6 + 6 layers, FFN 2048, bf16, full remat, the fused
    LM-head loss; with ``relative_position_bias=True,
    encoder_final_ln=True`` the architecture of the paper (with LayerNorm
    in place of its bias-free RMSNorm), as in JAX.

    ``relative_position_bias``: bucketed (``rel_pos_buckets``,
    ``rel_pos_max_distance``) logit biases, bidirectional in the encoder
    and causal in the decoder, one (buckets, heads) table per stack, no
    absolute positions. ``encoder_final_ln``: the encoder-exit LayerNorm,
    applied to the memory where the decoder takes it.
    ``attention_dropout`` / ``hidden_dropout``: the rates, active when the
    loss is given a ``dropout_key``. ``remat`` recomputes every layer (JAX
    has no T5 save policy). Refused with ``NotImplementedError``:
    ``megatron_sp`` (multi-device). Left out, as TPU-only tuning:
    ``attn_block_q/k``.
    """

    vocab_size: int = 32128
    hidden: int = 512
    num_heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_mult: int = 4
    max_seq_enc: int = 512
    max_seq_dec: int = 512
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    fused_loss: bool = True
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    megatron_sp: bool = False
    relative_position_bias: bool = False
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    encoder_final_ln: bool = False

    @property
    def ffn_hidden(self) -> int:
        return self.ffn_mult * self.hidden

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    def validate(self) -> None:
        if self.hidden % self.num_heads:
            raise ValueError("hidden must be divisible by num_heads")
        if self.dtype not in (torch.float32, torch.bfloat16,
                              torch.float16):
            raise ValueError(f"dtype must be float32, bfloat16 or float16, "
                             f"got {self.dtype}")
        if self.relative_position_bias:
            if self.rel_pos_buckets % 2:
                raise ValueError("rel_pos_buckets must be even (half the "
                                 "buckets serve each direction in the "
                                 "bidirectional encoder scheme)")
            if self.rel_pos_max_distance <= self.rel_pos_buckets // 2:
                raise ValueError(
                    f"rel_pos_max_distance ({self.rel_pos_max_distance}) "
                    f"must exceed rel_pos_buckets/2 "
                    f"({self.rel_pos_buckets // 2})")
        refused = {
            "megatron_sp": (self.megatron_sp,
                            "sequence parallelism is multi-device (A7c)"),
        }
        for name, (bad, why) in refused.items():
            if bad:
                raise NotImplementedError(
                    f"T5Config.{name}={getattr(self, name)!r} is not ported: "
                    f"{why}")


# ---------------------------------------------------------------------------
# relative position bias (T5 scheme: log-spaced distance buckets)


def _full(x, value):
    return torch.full_like(x, value, dtype=torch.float32)


def _rel_pos_bucket(rel, *, bidirectional: bool, num_buckets: int,
                    max_distance: int):
    """Bucket index for ``rel = k_pos - q_pos`` (an int32 tensor), JAX's
    ``_rel_pos_bucket`` step for step in fp32: exact buckets for small
    distances, one log-spaced bucket per range up to ``max_distance``,
    everything farther in the last bucket. The fp32 divisions are tensor by
    tensor, never by a Python number (which PyTorch may turn into a product
    with the reciprocal), so every distance lands in JAX's bucket."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(torch.int32) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    r32 = rel.to(torch.float32)
    val = (torch.log(r32 / _full(r32, max_exact) + _full(r32, 1e-6))
           / _full(r32, math.log(max_distance / max_exact))
           * _full(r32, num_buckets - max_exact))
    val_large = max_exact + val.to(torch.int32)   # truncation, as XLA's
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, rel, val_large)


@functools.lru_cache(maxsize=16)
def _bucket_index(sq: int, sk: int, bidirectional: bool, num_buckets: int,
                  max_distance: int, device: torch.device):
    """``(buckets, onehot)`` on ``device``, built once per shape and scheme
    on the host: ``buckets`` (sq, sk) int64, the bucket of k − q;
    ``onehot`` (sq + sk − 1, num_buckets) fp32, the bucket of each
    distance k − q = d − (sq − 1) as a one-hot row (the backward's fixed
    summation order)."""
    rel = torch.arange(-(sq - 1), sk, dtype=torch.int32)
    per_rel = _rel_pos_bucket(rel, bidirectional=bidirectional,
                              num_buckets=num_buckets,
                              max_distance=max_distance).long()
    q = torch.arange(sq)[:, None]
    k = torch.arange(sk)[None, :]
    buckets = per_rel[k - q + sq - 1]
    onehot = F.one_hot(per_rel, num_buckets).float()
    return buckets.to(device), onehot.to(device)


class _RelativeBias(torch.autograd.Function):
    """(heads, sq, sk) fp32 bias ``table.float()[buckets]`` (JAX's gather),
    with a backward whose summation order is fixed: the (heads, sq, sk)
    gradient is summed along each diagonal (one distance k − q: a strided
    view and ``sum``), then the distances of each bucket are summed (a
    product with the one-hot rows and ``sum``). No scatter or atomic add,
    so two runs give the same bits."""

    @staticmethod
    def forward(ctx, table, buckets, onehot):
        ctx.save_for_backward(onehot)
        ctx.table_dtype = table.dtype
        return table.float()[buckets].permute(2, 0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        (onehot,) = ctx.saved_tensors
        heads, sq, sk = g.shape
        # gp[h, q, c] = g[h, q, c − (sq − 1)]; diag[h, q, d] = gp[h, q, q + d]
        # holds g at distance k − q = d − (sq − 1), zero off the matrix
        gp = F.pad(g.float().contiguous(), (sq - 1, sq - 1))
        width = gp.shape[-1]
        diag = gp.as_strided((heads, sq, sq + sk - 1),
                             (sq * width, width + 1, 1))
        per_rel = diag.sum(dim=1)                       # (heads, sq+sk-1)
        per_bucket = (per_rel[:, :, None] * onehot).sum(dim=1)
        return per_bucket.t().to(ctx.table_dtype), None, None


def t5_relative_bias(table, sq: int, sk: int, *, bidirectional: bool,
                     cfg: T5Config):
    """(heads, sq, sk) fp32 additive logit bias from the (buckets, heads)
    table (JAX's ``t5_relative_bias`` without the ring-SP strip); feeds
    ``flash_attention(bias=)``. Differentiable in ``table``."""
    buckets, onehot = _bucket_index(sq, sk, bidirectional,
                                    cfg.rel_pos_buckets,
                                    cfg.rel_pos_max_distance, table.device)
    return _RelativeBias.apply(table, buckets, onehot)


# ---------------------------------------------------------------------------
# init


def init_t5_params_numpy(cfg: T5Config, seed: int = 0) -> Dict[str, Any]:
    """The JAX ``init_t5_params`` tree as float32 numpy arrays, drawn from
    ``np.random.default_rng(seed)`` with the JAX package's scheme:
    normal(0.02) input projections, embeddings and bias tables, output
    projections scaled by 1/sqrt(2·Le) in the encoder and 1/sqrt(2·(Le +
    Ld)) in the decoder, zero biases, unit LN weights."""
    cfg.validate()
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden, cfg.ffn_hidden

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def layers(n, out_std, cross):
        p = {
            "ln1_w": ones(n, h), "ln1_b": zeros(n, h),
            "qkv_kernel": normal((n, h, 3 * h), 0.02),
            "qkv_bias": zeros(n, 3 * h),
            "out_kernel": normal((n, h, h), out_std),
            "out_bias": zeros(n, h),
            "ln2_w": ones(n, h), "ln2_b": zeros(n, h),
        }
        if cross:
            p.update({
                "q_kernel": normal((n, h, h), 0.02), "q_bias": zeros(n, h),
                "kv_kernel": normal((n, h, 2 * h), 0.02),
                "kv_bias": zeros(n, 2 * h),
                "xout_kernel": normal((n, h, h), out_std),
                "xout_bias": zeros(n, h),
                "ln3_w": ones(n, h), "ln3_b": zeros(n, h),
            })
        p.update({
            "fc1_kernel": normal((n, h, f), 0.02), "fc1_bias": zeros(n, f),
            "fc2_kernel": normal((n, f, h), out_std), "fc2_bias": zeros(n, h),
        })
        return p

    le, ld = cfg.enc_layers, cfg.dec_layers
    embed = {"tok": normal((cfg.vocab_size, h), 0.02)}
    if cfg.encoder_final_ln:
        embed["enc_ln_w"] = ones(h)
        embed["enc_ln_b"] = zeros(h)
    if cfg.relative_position_bias:
        shape = (cfg.rel_pos_buckets, cfg.num_heads)
        embed["rel_enc"] = normal(shape, 0.02)
        embed["rel_dec"] = normal(shape, 0.02)
    else:
        embed["pos_enc"] = normal((cfg.max_seq_enc, h), 0.02)
        embed["pos_dec"] = normal((cfg.max_seq_dec, h), 0.02)
    return {
        "embed": embed,
        "enc_layers": layers(le, 0.02 / math.sqrt(2.0 * le), cross=False),
        "dec_layers": layers(ld, 0.02 / math.sqrt(2.0 * (le + ld)),
                             cross=True),
        "head": {"ln_w": ones(h), "ln_b": zeros(h)},
    }


def init_t5_params(cfg: T5Config, seed: int = 0,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters from a numpy seed, as ``cfg.dtype`` tensors on
    ``device`` (default ``cuda``)."""
    return params_from_numpy(init_t5_params_numpy(cfg, seed), device,
                             dtype=cfg.dtype)


# ---------------------------------------------------------------------------
# forward (single device; the JAX tp = 1 program)


def _split_heads(x, cfg: T5Config, parts: int):
    """(b, s, parts·hidden) with columns (head, part, head_dim) -> ``parts``
    contiguous (b, heads, s, head_dim) tensors (one copy)."""
    b, s, _ = x.shape
    x = x.view(b, s, cfg.num_heads, parts, cfg.head_dim)
    return x.permute(3, 0, 2, 1, 4).contiguous().unbind(0)


def _merge_heads(ctx):
    b, heads, s, d = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, heads * d)


def _attn_core(q, k, v, cfg: T5Config, causal: bool, dropout_key,
               bias=None):
    """The flash core (JAX ``_attn_core`` at sp = 1): with ``dropout_key``
    the kernels drop the probabilities at ``cfg.attention_dropout`` under
    ``attention_dropout_seed(dropout_key)``."""
    rate = cfg.attention_dropout if dropout_key is not None else 0.0
    if rate > 0.0:
        return flash_attention(q, k, v, causal=causal, bias=bias,
                               dropout_rate=rate,
                               dropout_seed=attention_dropout_seed(
                                   dropout_key))
    return flash_attention(q, k, v, causal=causal, bias=bias)


def _self_attention(p, x, cfg: T5Config, causal: bool, dropout_key=None,
                    rel_bias=None):
    """Fused per-head interleaved QKV, flash core (with the relative bias),
    out-projection (JAX ``_self_attention`` at tp = 1)."""
    q, k, v = _split_heads(_dense(x, p["qkv_kernel"], p["qkv_bias"]), cfg, 3)
    ctx = _attn_core(q, k, v, cfg, causal, dropout_key, bias=rel_bias)
    return _dense(_merge_heads(ctx), p["out_kernel"], p["out_bias"])


def _cross_attention(p, x, mem, cfg: T5Config, dropout_key=None):
    """Q from the decoder stream, packed KV from the memory, a rectangular
    (s_dec x s_enc) non-causal flash core with no bias (JAX
    ``_cross_attention`` at tp = 1)."""
    (q,) = _split_heads(_dense(x, p["q_kernel"], p["q_bias"]), cfg, 1)
    k, v = _split_heads(_dense(mem, p["kv_kernel"], p["kv_bias"]), cfg, 2)
    ctx = _attn_core(q, k, v, cfg, False, dropout_key)
    return _dense(_merge_heads(ctx), p["xout_kernel"], p["xout_bias"])


def _mlp(p, x, cfg: T5Config):
    """FC1 + tanh-approximated GELU + FC2 (JAX ``_mlp``)."""
    y = F.gelu(_dense(x, p["fc1_kernel"], p["fc1_bias"]), approximate="tanh")
    return _dense(y, p["fc2_kernel"], p["fc2_bias"])


def _maybe_hidden_dropout(x, cfg: T5Config, key, salt: int):
    """JAX's ``_maybe_hidden_dropout``: hidden dropout under ``fold_in(key,
    salt)`` when training (a key) with a rate."""
    if key is None or cfg.hidden_dropout <= 0.0:
        return x
    return hidden_dropout(x, cfg.hidden_dropout, fold_in(key, salt))


def _fold(key, data: int):
    return None if key is None else fold_in(key, data)


def enc_layer_fn(p, x, cfg: T5Config, rel_bias=None, dropout_key=None):
    """Pre-LN encoder layer: bidirectional self-attention, MLP."""
    k = dropout_key
    a = _self_attention(p, layer_norm(x, p["ln1_w"], p["ln1_b"]), cfg,
                        causal=False, dropout_key=_fold(k, 0),
                        rel_bias=rel_bias)
    x = x + _maybe_hidden_dropout(a, cfg, k, 1)
    m = _mlp(p, layer_norm(x, p["ln2_w"], p["ln2_b"]), cfg)
    return x + _maybe_hidden_dropout(m, cfg, k, 2)


def dec_layer_fn(p, x, mem, cfg: T5Config, rel_bias=None, dropout_key=None):
    """Pre-LN decoder layer: causal self-attention, cross-attention to the
    memory (no position bias, the T5 scheme), MLP."""
    k = dropout_key
    a = _self_attention(p, layer_norm(x, p["ln1_w"], p["ln1_b"]), cfg,
                        causal=True, dropout_key=_fold(k, 0),
                        rel_bias=rel_bias)
    x = x + _maybe_hidden_dropout(a, cfg, k, 1)
    c = _cross_attention(p, layer_norm(x, p["ln2_w"], p["ln2_b"]), mem, cfg,
                         dropout_key=_fold(k, 3))
    x = x + _maybe_hidden_dropout(c, cfg, k, 4)
    m = _mlp(p, layer_norm(x, p["ln3_w"], p["ln3_b"]), cfg)
    return x + _maybe_hidden_dropout(m, cfg, k, 2)


def _scan_layers(layer_fn, layers, x, cfg: T5Config, *extra,
                 dropout_key=None):
    """JAX's ``lax.scan`` over the stacked layer params as a Python loop
    (the port GPT's ``_layer_stack``): with ``cfg.remat`` (and autograd
    recording) each layer runs under ``torch.utils.checkpoint`` and is
    recomputed in backward. ``extra`` (the memory, the relative bias) goes
    to every layer, and layer i's dropout key is ``fold_in(dropout_key,
    i)``."""
    names = sorted(layers)
    per_leaf = [layers[k].unbind(0) for k in names]
    fn = layer_fn
    if cfg.remat and torch.is_grad_enabled():
        fn = checkpoint_saving(layer_fn)
    for i, vals in enumerate(zip(*per_leaf)):
        x = fn(dict(zip(names, vals)), x, *extra, _fold(dropout_key, i))
    return x


def _embed(embed, tokens, pos_table):
    """Token (+ absolute position) embedding; ``pos_table`` is None under
    the relative bias (T5 proper has no absolute positions)."""
    h = F.embedding(tokens, embed["tok"])
    if pos_table is None:
        return h
    return h + pos_table[:tokens.shape[1]][None].to(h.dtype)


def t5_encode(params, enc_tokens, cfg: T5Config, dropout_key=None):
    """Encoder tokens (b, s_enc) -> memory (b, s_enc, hidden)."""
    rel_on = cfg.relative_position_bias
    embed = params["embed"]
    x = _embed(embed, enc_tokens, None if rel_on else embed["pos_enc"])
    x = _maybe_hidden_dropout(x, cfg, _fold(dropout_key, 100), 0)
    s = enc_tokens.shape[1]
    rel = (t5_relative_bias(embed["rel_enc"], s, s, bidirectional=True,
                            cfg=cfg) if rel_on else None)
    return _scan_layers(lambda lp, h, r, k: enc_layer_fn(lp, h, cfg, r, k),
                        params["enc_layers"], x, cfg, rel,
                        dropout_key=dropout_key)


def t5_decode(params, dec_tokens, mem, cfg: T5Config, dropout_key=None):
    """Decoder tokens (b, s_dec) and memory -> (b, s_dec, hidden). With
    ``encoder_final_ln`` the memory is normalized here, once, before the
    decoder stack (JAX's encoder-exit LayerNorm)."""
    rel_on = cfg.relative_position_bias
    embed = params["embed"]
    if cfg.encoder_final_ln:
        mem = layer_norm(mem, embed["enc_ln_w"], embed["enc_ln_b"])
    x = _embed(embed, dec_tokens, None if rel_on else embed["pos_dec"])
    x = _maybe_hidden_dropout(x, cfg, _fold(dropout_key, 101), 0)
    s = dec_tokens.shape[1]
    rel = (t5_relative_bias(embed["rel_dec"], s, s, bidirectional=False,
                            cfg=cfg) if rel_on else None)
    return _scan_layers(
        lambda lp, h, m, r, k: dec_layer_fn(lp, h, m, cfg, r, k),
        params["dec_layers"], x, cfg, mem, rel, dropout_key=dropout_key)


def t5_loss(params, enc_tokens, dec_tokens, targets, cfg: T5Config,
            dropout_key=None):
    """Mean cross-entropy of the decoder's logits against ``targets`` (JAX's
    sequential ``t5_loss``): a 0-d fp32 tensor. With ``cfg.fused_loss``
    (and, on the card, the kernel's shape gate, as JAX takes its Pallas
    kernel only where ``pallas_fits``) the head LN and the fused LM head +
    CE over ``embed.tok``; otherwise LN, tied logits and
    ``vocab_parallel_cross_entropy``. ``dropout_key`` (a threefry
    ``uint32[2]``) turns on cfg's dropout rates, the encoder under its
    ``fold_in(key, 0)`` and the decoder under ``fold_in(key, 1)``."""
    cfg.validate()
    mem = t5_encode(params, enc_tokens, cfg, _fold(dropout_key, 0))
    x = t5_decode(params, dec_tokens, mem, cfg, _fold(dropout_key, 1))
    head, tok = params["head"], params["embed"]["tok"]
    if _use_fused_loss(cfg, dec_tokens.numel(), dec_tokens.device):
        return fused_head_loss(tok, head["ln_w"], head["ln_b"], x, targets)
    x = layer_norm(x, head["ln_w"], head["ln_b"])
    return vocab_parallel_cross_entropy(tied_vocab_logits(x, tok),
                                        targets).mean()
