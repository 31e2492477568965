"""Standalone T5-style encoder-decoder (counterpart of
``apex_tpu/transformer/testing/standalone_t5.py`` at pp = 1): config,
relative position bias, parameters, their partition specs, and the
sequential forward and loss, on one device or on this rank's shards
under tp / ``megatron_sp`` / ring sp.

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
and ``fold_in(k, 2)``; the hidden-dropout keys fold the sp rank under ring
sp and the tp rank under ``megatron_sp`` (GPT's ``_hidden_key``).

Tensor and sequence parallelism follow JAX's program inside
``shard_map``, as the port's GPT does (``standalone_gpt``'s docstring):
with a mesh installed the functions take this rank's local tree
(``shard_params`` by :func:`t5_param_specs`, the bias tables split by
heads) and, under ring sp, the (b, s/sp) token shards; the projections
are JAX's column / row-parallel layers, ``megatron_sp`` keeps (b, s/tp,
h) shards between them, and over sp the attention is the ring, the
self-attention's relative bias the ring's strip (this shard's rows
against every global column, :func:`_rel_or_strip`), so the strip's
gradient runs the d(bias) kernel with the chunk offsets.

The pipeline wiring (JAX's, for ``pipeline_parallel``'s encoder-decoder
schedule): :func:`t5_pipeline_params_numpy` regroups the tree so every
stage holds one encoder and one decoder chunk, :func:`t5_pipeline_params`
cuts this rank's local tree from it, :func:`t5_pipeline_specs_tree` gives
its specs and :func:`t5_enc_dec_spec` the five stage functions.
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
from apex_tpu_torch.parallel.mesh import PP_AXIS, SP_AXIS, TP_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_enc_dec import (  # noqa: E501
    EncDecPipelineSpec,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    axis_info,
    scatter_to_sequence_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    attention_dropout_seed,
    checkpoint_saving,
    fold_in,
    pipeline_stage_key,
    saved_product,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import P
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    _hidden_key,
    _sp_param,
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
    has no T5 save policy). ``megatron_sp``: Megatron's sequence shards
    over tp between the tp blocks. Left out, as TPU-only tuning:
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

    def validate(self, tp: int = 1) -> None:
        """JAX's checks for tp ranks (and the port's dtypes)."""
        if self.hidden % self.num_heads:
            raise ValueError("hidden must be divisible by num_heads")
        for name, dim in (("vocab_size", self.vocab_size),
                          ("num_heads", self.num_heads),
                          ("ffn_hidden", self.ffn_hidden)):
            if dim % tp:
                raise ValueError(f"{name} ({dim}) not divisible by tp ({tp})")
        if self.megatron_sp and (self.max_seq_enc % tp
                                 or self.max_seq_dec % tp):
            raise ValueError(
                f"megatron_sp needs max_seq_enc ({self.max_seq_enc}) and "
                f"max_seq_dec ({self.max_seq_dec}) divisible by tp ({tp})")
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
                  max_distance: int, device: torch.device, shift: int = 0):
    """``(buckets, onehot)`` on ``device``, built once per shape and scheme
    on the host: ``buckets`` (sq, sk) int64, the bucket of the global
    distance k − q + ``shift`` (``shift`` = the first key position less
    the first query position; 0 for a square bias); ``onehot`` (sq + sk −
    1, num_buckets) fp32, the bucket of each distance d − (sq − 1) +
    shift as a one-hot row (the backward's fixed summation order)."""
    rel = torch.arange(-(sq - 1), sk, dtype=torch.int32) + shift
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


def t5_relative_bias(table, sq: int = None, sk: int = None, *,
                     bidirectional: bool, cfg: T5Config, qpos=None,
                     kpos=None):
    """(heads, sq, sk) fp32 additive logit bias from the (buckets, heads)
    table (this rank's head shard under tp); feeds
    ``flash_attention(bias=)``. Differentiable in ``table``. ``qpos`` /
    ``kpos`` (consecutive global positions, in place of ``sq`` / ``sk``)
    build a ring-SP strip: this shard's rows against every global
    column."""
    shift = 0
    if qpos is not None or kpos is not None:
        qpos = torch.arange(sq) if qpos is None else torch.as_tensor(qpos)
        kpos = torch.arange(sk) if kpos is None else torch.as_tensor(kpos)
        for pos in (qpos, kpos):
            if pos.numel() > 1 and not bool((pos.diff() == 1).all()):
                raise ValueError("qpos / kpos must be consecutive positions")
        sq, sk = qpos.numel(), kpos.numel()
        shift = int(kpos[0]) - int(qpos[0])
    buckets, onehot = _bucket_index(sq, sk, bidirectional,
                                    cfg.rel_pos_buckets,
                                    cfg.rel_pos_max_distance, table.device,
                                    shift)
    return _RelativeBias.apply(table, buckets, onehot)


def t5_param_specs(cfg: T5Config) -> Dict[str, Any]:
    """Partition specs matching :func:`init_t5_params` (JAX's
    ``t5_param_specs``): the Megatron tp dims, as GPT's, and the bias
    tables split by heads."""
    cols = {"qkv_kernel", "fc1_kernel", "q_kernel", "kv_kernel"}
    col_bias = {"qkv_bias", "fc1_bias", "q_bias", "kv_bias"}
    rows = {"out_kernel", "fc2_kernel", "xout_kernel"}

    def layer(keys):
        return {k: (P(None, None, TP_AXIS) if k in cols
                    else P(None, TP_AXIS) if k in col_bias
                    else P(None, TP_AXIS, None) if k in rows else P(None))
                for k in keys}

    enc_keys = ("ln1_w", "ln1_b", "qkv_kernel", "qkv_bias", "out_kernel",
                "out_bias", "ln2_w", "ln2_b", "fc1_kernel", "fc1_bias",
                "fc2_kernel", "fc2_bias")
    dec_keys = enc_keys + ("q_kernel", "q_bias", "kv_kernel", "kv_bias",
                           "xout_kernel", "xout_bias", "ln3_w", "ln3_b")
    embed = {"tok": P(TP_AXIS, None)}
    if cfg.encoder_final_ln:
        embed["enc_ln_w"] = P()
        embed["enc_ln_b"] = P()
    if cfg.relative_position_bias:
        embed["rel_enc"] = P(None, TP_AXIS)
        embed["rel_dec"] = P(None, TP_AXIS)
    else:
        embed["pos_enc"] = P()
        embed["pos_dec"] = P()
    return {"embed": embed, "enc_layers": layer(enc_keys),
            "dec_layers": layer(dec_keys),
            "head": {"ln_w": P(), "ln_b": P()}}


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
# forward (this rank's shards; with no mesh, one device)


def _split_heads(x, cfg: T5Config, parts: int):
    """(b, s, parts·hidden/tp) with columns (head, part, head_dim) ->
    ``parts`` contiguous (b, heads/tp, s, head_dim) tensors (one copy)."""
    b, s, _ = x.shape
    heads = cfg.num_heads // axis_info(TP_AXIS)[1]
    x = x.view(b, s, heads, parts, cfg.head_dim)
    return x.permute(3, 0, 2, 1, 4).contiguous().unbind(0)


def _column(x, kernel, bias, cfg: T5Config):
    return column_parallel_linear(x, kernel, bias, gather_output=False,
                                  sequence_parallel=cfg.megatron_sp,
                                  product=saved_product)


def _row(x, kernel, bias, cfg: T5Config):
    return row_parallel_linear(x, kernel, bias, input_is_parallel=True,
                               sequence_parallel=cfg.megatron_sp,
                               product=saved_product)


def _ln(x, p, w: str, b: str, cfg: T5Config):
    """LayerNorm; under ``megatron_sp`` its parameters meet this rank's
    sequence shard, so their gradients are summed over tp."""
    return layer_norm(x, _sp_param(p[w], cfg), _sp_param(p[b], cfg))


def _merge_heads(ctx):
    b, heads, s, d = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, heads * d)


def _attn_core(q, k, v, cfg: T5Config, causal: bool, dropout_key,
               bias=None):
    """The attention core (JAX ``_attn_core``): the ring over sp shards
    (``bias`` is then the ring's strip), flash otherwise; with
    ``dropout_key`` the kernels drop the probabilities at
    ``cfg.attention_dropout`` under ``attention_dropout_seed(dropout_key)``
    (the tp rank folded in)."""
    rate = cfg.attention_dropout if dropout_key is not None else 0.0
    if axis_info(SP_AXIS)[1] > 1:
        from apex_tpu_torch.transformer.sequence_parallel import (
            ring_attention,
        )

        return ring_attention(
            q, k, v, causal=causal, bias_strip=bias, dropout_rate=rate,
            dropout_seed=(attention_dropout_seed(dropout_key) if rate > 0.0
                          else None))
    if rate > 0.0:
        return flash_attention(q, k, v, causal=causal, bias=bias,
                               dropout_rate=rate,
                               dropout_seed=attention_dropout_seed(
                                   dropout_key))
    return flash_attention(q, k, v, causal=causal, bias=bias)


def _self_attention(p, x, cfg: T5Config, causal: bool, dropout_key=None,
                    rel_bias=None):
    """Column-parallel fused per-head interleaved QKV, the attention core
    (with the relative bias), row-parallel out-projection (JAX
    ``_self_attention``)."""
    q, k, v = _split_heads(_column(x, p["qkv_kernel"], p["qkv_bias"], cfg),
                           cfg, 3)
    ctx = _attn_core(q, k, v, cfg, causal, dropout_key, bias=rel_bias)
    return _row(_merge_heads(ctx), p["out_kernel"], p["out_bias"], cfg)


def _cross_attention(p, x, mem, cfg: T5Config, dropout_key=None):
    """Q from the decoder stream, packed KV from the memory, a rectangular
    (s_dec x s_enc) non-causal core with no bias (the rectangular ring
    under sp; JAX ``_cross_attention``)."""
    (q,) = _split_heads(_column(x, p["q_kernel"], p["q_bias"], cfg), cfg, 1)
    k, v = _split_heads(_column(mem, p["kv_kernel"], p["kv_bias"], cfg),
                        cfg, 2)
    ctx = _attn_core(q, k, v, cfg, False, dropout_key)
    return _row(_merge_heads(ctx), p["xout_kernel"], p["xout_bias"], cfg)


def _mlp(p, x, cfg: T5Config):
    """Column-parallel FC1 + tanh-approximated GELU + row-parallel FC2
    (JAX ``_mlp``)."""
    y = F.gelu(_column(x, p["fc1_kernel"], p["fc1_bias"], cfg),
               approximate="tanh")
    return _row(y, p["fc2_kernel"], p["fc2_bias"], cfg)


def _maybe_hidden_dropout(x, cfg: T5Config, key, salt: int):
    """JAX's ``_maybe_hidden_dropout``: hidden dropout under
    ``_hidden_key(fold_in(key, salt))`` when training (a key) with a
    rate."""
    if key is None or cfg.hidden_dropout <= 0.0:
        return x
    return hidden_dropout(x, cfg.hidden_dropout,
                          _hidden_key(fold_in(key, salt), cfg))


def _fold(key, data: int):
    return None if key is None else fold_in(key, data)


def enc_layer_fn(p, x, cfg: T5Config, rel_bias=None, dropout_key=None):
    """Pre-LN encoder layer: bidirectional self-attention, MLP."""
    k = dropout_key
    a = _self_attention(p, _ln(x, p, "ln1_w", "ln1_b", cfg), cfg,
                        causal=False, dropout_key=_fold(k, 0),
                        rel_bias=rel_bias)
    x = x + _maybe_hidden_dropout(a, cfg, k, 1)
    m = _mlp(p, _ln(x, p, "ln2_w", "ln2_b", cfg), cfg)
    return x + _maybe_hidden_dropout(m, cfg, k, 2)


def dec_layer_fn(p, x, mem, cfg: T5Config, rel_bias=None, dropout_key=None):
    """Pre-LN decoder layer: causal self-attention, cross-attention to the
    memory (no position bias, the T5 scheme), MLP."""
    k = dropout_key
    a = _self_attention(p, _ln(x, p, "ln1_w", "ln1_b", cfg), cfg,
                        causal=True, dropout_key=_fold(k, 0),
                        rel_bias=rel_bias)
    x = x + _maybe_hidden_dropout(a, cfg, k, 1)
    c = _cross_attention(p, _ln(x, p, "ln2_w", "ln2_b", cfg), mem, cfg,
                         dropout_key=_fold(k, 3))
    x = x + _maybe_hidden_dropout(c, cfg, k, 4)
    m = _mlp(p, _ln(x, p, "ln3_w", "ln3_b", cfg), cfg)
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


def _embed(embed, tokens, pos_table, megatron_sp: bool = False):
    """Token (+ absolute position) embedding (JAX ``_embed``);
    ``pos_table`` is None under the relative bias (T5 proper has no
    absolute positions). Under ring sp the positions start at the shard's;
    under ``megatron_sp`` the result is the (b, s/tp, h) shard."""
    s_loc = tokens.shape[1]
    tp = axis_info(TP_AXIS)[1]
    if megatron_sp and s_loc % tp:
        raise ValueError(f"megatron_sp needs the sequence length ({s_loc}) "
                         f"divisible by tp ({tp})")
    h = vocab_parallel_embedding(tokens, embed["tok"],
                                 sequence_parallel=megatron_sp)
    if pos_table is None:
        return h
    start = axis_info(SP_AXIS)[2] * s_loc
    pos = pos_table[start:start + s_loc]
    if megatron_sp:
        pos = scatter_to_sequence_parallel_region(pos, seq_axis=0)
    return h + pos[None].to(h.dtype)


def _rel_or_strip(table, s_tok: int, *, bidirectional: bool,
                  cfg: T5Config):
    """The stack's relative bias, built once: the square (heads, s, s)
    bias at sp = 1 (``s_tok`` the whole sequence), or at sp > 1 the ring's
    strip (heads, s_loc, sp·s_loc) from this shard's global positions
    (``s_tok`` the local shard)."""
    _, sp, my = axis_info(SP_AXIS)
    if sp == 1:
        return t5_relative_bias(table, s_tok, s_tok,
                                bidirectional=bidirectional, cfg=cfg)
    return t5_relative_bias(table, bidirectional=bidirectional, cfg=cfg,
                            qpos=range(my * s_tok, (my + 1) * s_tok),
                            kpos=range(sp * s_tok))


def t5_encode(params, enc_tokens, cfg: T5Config, dropout_key=None):
    """Encoder tokens (b, s_enc) -> memory (b, s_enc, hidden)."""
    rel_on = cfg.relative_position_bias
    embed = params["embed"]
    x = _embed(embed, enc_tokens, None if rel_on else embed["pos_enc"],
               cfg.megatron_sp)
    x = _maybe_hidden_dropout(x, cfg, _fold(dropout_key, 100), 0)
    rel = (_rel_or_strip(embed["rel_enc"], enc_tokens.shape[1],
                         bidirectional=True, cfg=cfg) if rel_on else None)
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
        mem = _ln(mem, embed, "enc_ln_w", "enc_ln_b", cfg)
    x = _embed(embed, dec_tokens, None if rel_on else embed["pos_dec"],
               cfg.megatron_sp)
    x = _maybe_hidden_dropout(x, cfg, _fold(dropout_key, 101), 0)
    rel = (_rel_or_strip(embed["rel_dec"], dec_tokens.shape[1],
                         bidirectional=False, cfg=cfg) if rel_on else None)
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
        return fused_head_loss(tok, head["ln_w"], head["ln_b"], x, targets,
                               gather_sequence=cfg.megatron_sp)
    x = _ln(x, head, "ln_w", "ln_b", cfg)
    return vocab_parallel_cross_entropy(
        tied_vocab_logits(x, tok, cfg.megatron_sp), targets).mean()


# ---------------------------------------------------------------------------
# pipeline wiring (the EncDecPipelineSpec contract)


def _stage_extras(cfg: T5Config):
    """Which stage-consumed extras become per-stage copies: the bias
    tables (``"rel"``) and the encoder-final LayerNorm (on the decoder
    side)."""
    return cfg.relative_position_bias, cfg.encoder_final_ln


def t5_pipeline_params_numpy(cfg: T5Config, pp: int, seed: int = 0
                             ) -> Dict[str, Any]:
    """:func:`init_t5_params_numpy` regrouped into the encoder-decoder
    driver's layout (JAX's ``t5_pipeline_params``): ``{"embed",
    "enc_stages" [pp, Le/pp, ...], "dec_stages" [pp, Ld/pp, ...],
    "head"}``. The head gets its own LM rows (``lm_rows``, initialized
    from the shared table: the loss head sees only the ``head`` group),
    and the extras a stage consumes (the bias tables, the encoder-final
    LN) become per-stage copies, initialized equal and dropped from the
    embedding group."""
    if cfg.enc_layers % pp or cfg.dec_layers % pp:
        raise ValueError("enc_layers and dec_layers must be divisible by pp")
    p = init_t5_params_numpy(cfg, seed)

    def regroup(a, n):
        return a.reshape((pp, n // pp) + a.shape[1:])

    def tile(a):
        return np.broadcast_to(a[None], (pp,) + a.shape).copy()

    head = dict(p["head"], lm_rows=p["embed"]["tok"].copy())
    enc = {k: regroup(v, cfg.enc_layers) for k, v in p["enc_layers"].items()}
    dec = {k: regroup(v, cfg.dec_layers) for k, v in p["dec_layers"].items()}
    embed = dict(p["embed"])
    rel_on, final_ln = _stage_extras(cfg)
    if rel_on:
        enc = {"layers": enc, "rel": tile(embed.pop("rel_enc"))}
        dec = {"layers": dec, "rel": tile(embed.pop("rel_dec"))}
    if final_ln:
        if not rel_on:
            dec = {"layers": dec}
        dec["enc_ln_w"] = tile(embed.pop("enc_ln_w"))
        dec["enc_ln_b"] = tile(embed.pop("enc_ln_b"))
    return {"embed": embed, "enc_stages": enc, "dec_stages": dec,
            "head": head}


def t5_pipeline_specs_tree(cfg: T5Config) -> Dict[str, Any]:
    """Partition specs of :func:`t5_pipeline_params_numpy` (JAX's): the
    layer specs with the stage axis in front, the head's rows over tp."""
    specs = t5_param_specs(cfg)

    def lead(layers):
        return {k: P(PP_AXIS, *v) for k, v in layers.items()}

    enc, dec = lead(specs["enc_layers"]), lead(specs["dec_layers"])
    embed = dict(specs["embed"])
    rel_on, final_ln = _stage_extras(cfg)
    if rel_on:
        rel = P(PP_AXIS, None, TP_AXIS)
        enc, dec = {"layers": enc, "rel": rel}, {"layers": dec, "rel": rel}
        del embed["rel_enc"], embed["rel_dec"]
    if final_ln:
        if not rel_on:
            dec = {"layers": dec}
        dec["enc_ln_w"] = dec["enc_ln_b"] = P(PP_AXIS, None)
        del embed["enc_ln_w"], embed["enc_ln_b"]
    return {"embed": embed, "enc_stages": enc, "dec_stages": dec,
            "head": dict(specs["head"], lm_rows=P(TP_AXIS, None))}


def t5_pipeline_params(cfg: T5Config, pp: int, seed: int = 0,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """This rank's local tree (its encoder and decoder chunks, its tp
    shards on the current mesh) of :func:`t5_pipeline_params_numpy`, as
    ``cfg.dtype`` tensors on ``device``: the driver's ``params``."""
    from apex_tpu_torch.convert import pipeline_params_from_numpy

    return pipeline_params_from_numpy(
        t5_pipeline_params_numpy(cfg, pp, seed), device, dtype=cfg.dtype,
        specs=t5_pipeline_specs_tree(cfg))


def t5_enc_dec_spec(cfg: T5Config, dropout: bool = False
                    ) -> EncDecPipelineSpec:
    """The encoder-decoder stage functions (JAX's ``t5_enc_dec_spec``).
    With ``dropout`` they take the schedule's per-microbatch key: the
    side salt (encoder 0, decoder 1, as ``t5_loss``) and the pp rank are
    folded here (encoder and decoder chunks share a stage's rank, and
    stage-local layer indices restart at 0), the embeddings draw
    ``t5_encode`` / ``t5_decode``'s streams (salts 100 / 101). The loss
    is JAX's pipeline head: LN, the untied LM rows' logits and the
    vocab-parallel cross-entropy."""
    cfg.validate()
    rel_on = cfg.relative_position_bias

    def stage_key(key, side: int):
        return None if key is None else pipeline_stage_key(fold_in(key, side))

    def seq_len(h):
        return h.shape[1] * (axis_info(TP_AXIS)[1] if cfg.megatron_sp else 1)

    def enc_embed(embed, tokens, key=None):
        x = _embed(embed, tokens, None if rel_on else embed["pos_enc"],
                   cfg.megatron_sp)
        return _maybe_hidden_dropout(x, cfg, _fold(key, 100), 0)

    def enc_stage(stage, h, key=None):
        dk = stage_key(key, 0)
        if rel_on:
            rel = _rel_or_strip(stage["rel"], seq_len(h), bidirectional=True,
                                cfg=cfg)
            return _scan_layers(
                lambda lp, x, r, k: enc_layer_fn(lp, x, cfg, r, k),
                stage["layers"], h, cfg, rel, dropout_key=dk)
        return _scan_layers(
            lambda lp, x, k: enc_layer_fn(lp, x, cfg, None, k), stage, h,
            cfg, dropout_key=dk)

    def dec_embed(embed, tokens, key=None):
        x = _embed(embed, tokens, None if rel_on else embed["pos_dec"],
                   cfg.megatron_sp)
        return _maybe_hidden_dropout(x, cfg, _fold(key, 101), 0)

    def dec_stage(stage, h, mem, key=None):
        dk = stage_key(key, 1)
        if cfg.encoder_final_ln:
            # every stage normalizes the broadcast memory with its copy
            # of the encoder-final LN: the sequential model's one LN
            mem = _ln(mem, stage, "enc_ln_w", "enc_ln_b", cfg)
        if rel_on:
            rel = _rel_or_strip(stage["rel"], seq_len(h),
                                bidirectional=False, cfg=cfg)
            return _scan_layers(
                lambda lp, x, m, r, k: dec_layer_fn(lp, x, m, cfg, r, k),
                stage["layers"], h, cfg, mem, rel, dropout_key=dk)
        layers = stage["layers"] if cfg.encoder_final_ln else stage
        return _scan_layers(
            lambda lp, x, m, k: dec_layer_fn(lp, x, m, cfg, None, k),
            layers, h, cfg, mem, dropout_key=dk)

    if dropout:
        enc_embed_fn, dec_embed_fn = enc_embed, dec_embed
        enc_stage_fn, dec_stage_fn = enc_stage, dec_stage
    else:
        def enc_embed_fn(embed, tokens):
            return enc_embed(embed, tokens)

        def dec_embed_fn(embed, tokens):
            return dec_embed(embed, tokens)

        def enc_stage_fn(stage, h):
            return enc_stage(stage, h)

        def dec_stage_fn(stage, h, mem):
            return dec_stage(stage, h, mem)

    def loss_fn(head, h, targets):
        x = _ln(h, head, "ln_w", "ln_b", cfg)
        logits = tied_vocab_logits(x, head["lm_rows"], cfg.megatron_sp)
        return vocab_parallel_cross_entropy(logits, targets).mean()

    return EncDecPipelineSpec(enc_embed_fn, enc_stage_fn, dec_embed_fn,
                              dec_stage_fn, loss_fn,
                              takes_dropout_key=dropout)
