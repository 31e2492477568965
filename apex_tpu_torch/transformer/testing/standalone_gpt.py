"""Standalone GPT config and parameters (counterpart of
``apex_tpu/transformer/testing/standalone_gpt.py``): config, parameters,
and the single-device training forward and loss.

The parameter tree keeps the JAX package's layout so weights carry across
one to one through :func:`apex_tpu_torch.convert.params_from_numpy`:

==============================  ==========================
``embed.tok``                   (vocab, hidden)
``embed.pos``                   (max_seq, hidden)
``layers.*`` (leading [L])      stacked per-layer tensors
``layers.qkv_kernel``           (hidden, 3·hidden), per-head interleaved
``layers.out_kernel``           (hidden, hidden)
``layers.fc1_kernel``           (hidden, ffn)
``layers.fc2_kernel``           (ffn, hidden)
``head.ln_w/ln_b``              (hidden,)
``head.lm`` (untied head)       (hidden, vocab)
==============================  ==========================

Training (single device, the JAX package's tp=1 program): :func:`gpt_loss`
is the JAX ``gpt_loss`` — embedding, a Python loop over the stacked layers
(each under ``torch.utils.checkpoint`` when ``remat``, saving what
``remat_policy`` names), then either the fused head (``fused_loss``, the
default: final LayerNorm and
:func:`~apex_tpu_torch.ops.lm_head_loss.lm_head_loss` over the vocab rows,
kernels B #12-14 on the card) or the unfused one (final LayerNorm, the
vocab logits and the port's ``vocab_parallel_cross_entropy``).
LayerNorm, the attention core and the fused loss go through the port's
kernels; the projections are plain ``torch.matmul`` over the (b·s) rows.

Dropout (training mode, ``dropout_key`` given: a threefry ``uint32[2]``
key on the host, ``transformer.tensor_parallel.random``) follows JAX's
sites and keys at tp = sp = 1: the embedding's hidden dropout under
``fold_in(key, 0x0E0B)``; layer i under ``fold_in(key, i)``, split in
three for the attention seed (the flash kernels' in-kernel dropout,
``attention_dropout_seed``) and the two residual branches' hidden dropout
(``ops.dropout.hidden_dropout``, bitwise JAX's ``_hidden_dropout``).
Without a key the model runs in eval mode.
"""

from __future__ import annotations

import dataclasses
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
from apex_tpu_torch.ops.lm_head_loss import kernel_fits, lm_head_loss
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    attention_dropout_seed,
    checkpoint_saving,
    fold_in,
    saved_product,
    split,
)

# the embedding's dropout stream, apart from the per-layer keys
_EMBED_DROPOUT_SALT = 0x0E0B


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT-2-124M-class defaults: vocab 50304, hidden 768, 12 layers, 12
    heads (head_dim 64), max_seq 1024, bf16, tied embeddings.

    Training fields with the JAX meaning: ``remat`` (recompute each layer
    in backward), ``remat_policy`` (what a recomputed layer saves:
    ``"full"`` nothing, ``"dots"`` the products with no batch dimension —
    the qkv, out, fc1 and fc2 projections, marked by ``_dense`` — and
    ``"dots_attn"`` those and flash's forward outputs, so backward replays
    no attention forward),
    ``fused_loss`` (JAX's default ``True``: the LM head fused into the
    loss, kernels B #12-14 on the card; ``False`` materializes the
    logits), ``attention_dropout`` and ``hidden_dropout`` (active when the
    loss is given a ``dropout_key``), ``megatron_sp``, ``overlap_comm``
    and ``num_experts`` (defaults only: single device, dense FFN). Left
    out, as TPU-only tuning: ``scan_unroll``, ``ln_pallas``,
    ``attn_block_q/k``, ``lm_block_n/v``, and the MoE routing fields.
    """

    vocab_size: int = 50304
    max_seq: int = 1024
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_mult: int = 4
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = True
    remat: bool = True
    remat_policy: str = "full"
    fused_loss: bool = True
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    megatron_sp: bool = False
    overlap_comm: bool = False
    num_experts: int = 0

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
        if self.remat_policy not in ("full", "dots", "dots_attn"):
            raise ValueError(
                f"remat_policy must be 'full', 'dots' or 'dots_attn', "
                f"got {self.remat_policy!r}")
        refused = {
            "megatron_sp": (self.megatron_sp,
                            "sequence parallelism is multi-device (A7c)"),
            "overlap_comm": (self.overlap_comm,
                             "collective overlap is multi-device (A7c)"),
            "num_experts": (self.num_experts != 0,
                            "mixture of experts is multi-device (A7d)"),
        }
        for name, (bad, why) in refused.items():
            if bad:
                raise NotImplementedError(
                    f"GPTConfig.{name}={getattr(self, name)!r} is not ported: "
                    f"{why}")


def init_gpt_params_numpy(cfg: GPTConfig, seed: int = 0
                          ) -> Dict[str, Any]:
    """The parameter tree as float32 numpy arrays, drawn from
    ``np.random.default_rng(seed)`` with the JAX package's scheme:
    normal(0.02) input projections and embeddings, output projections
    scaled by 1/sqrt(2L), zero biases, unit LN weights."""
    cfg.validate()
    rng = np.random.default_rng(seed)
    h, f, L = cfg.hidden, cfg.ffn_hidden, cfg.num_layers
    out_std = 0.02 / math.sqrt(2.0 * L)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    params = {
        "embed": {"tok": normal((cfg.vocab_size, h), 0.02),
                  "pos": normal((cfg.max_seq, h), 0.02)},
        "layers": {
            "ln1_w": ones(L, h), "ln1_b": zeros(L, h),
            "qkv_kernel": normal((L, h, 3 * h), 0.02),
            "qkv_bias": zeros(L, 3 * h),
            "out_kernel": normal((L, h, h), out_std),
            "out_bias": zeros(L, h),
            "ln2_w": ones(L, h), "ln2_b": zeros(L, h),
            "fc1_kernel": normal((L, h, f), 0.02),
            "fc1_bias": zeros(L, f),
            "fc2_kernel": normal((L, f, h), out_std),
            "fc2_bias": zeros(L, h),
        },
        "head": {"ln_w": ones(h), "ln_b": zeros(h)},
    }
    if not cfg.tie_embeddings:
        params["head"]["lm"] = normal((h, cfg.vocab_size), 0.02)
    return params


def init_gpt_params(cfg: GPTConfig, seed: int = 0,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters from a numpy seed, as ``cfg.dtype`` tensors on
    ``device`` (default ``cuda``)."""
    return params_from_numpy(init_gpt_params_numpy(cfg, seed), device,
                             dtype=cfg.dtype)


# ---------------------------------------------------------------------------
# forward and loss (single device; the JAX tp=1 program)


def _dense(x, kernel, bias=None):
    """``x @ kernel (+ bias)`` over the (b·s) rows, in x's dtype, rounded
    after the product and after the bias add as the JAX column/row
    parallel linears are. The product is a "dots" output, saved by a
    remat policy that saves those."""
    y = saved_product(x, kernel)
    return y if bias is None else y + bias


def embed_tokens(embed, tokens):
    """Token + position embedding (the JAX ``embed_tokens`` at tp=1, no
    sequence sharding): tokens (b, s) -> (b, s, hidden)."""
    h = F.embedding(tokens, embed["tok"])
    return h + embed["pos"][:tokens.shape[1]][None].to(h.dtype)


def _attention(p, x, cfg: GPTConfig, causal: bool = True, mask=None,
               dropout_key=None):
    """Fused QKV, flash core, out-projection (JAX ``_attention`` at tp=1).
    The QKV columns are per-head interleaved, (head, {q,k,v}, head_dim),
    as in the JAX tree. With ``dropout_key`` the flash kernels drop the
    attention probabilities at ``cfg.attention_dropout`` under
    ``attention_dropout_seed(dropout_key)``."""
    b, s, h = x.shape
    qkv = _dense(x, p["qkv_kernel"], p["qkv_bias"])
    # (b, s, H, 3, D) -> (3, b, H, s, D): one copy, then q, k, v are
    # contiguous (b, H, s, D) views
    qkv = qkv.view(b, s, cfg.num_heads, 3, cfg.head_dim)
    q, k, v = qkv.permute(3, 0, 2, 1, 4).contiguous().unbind(0)
    rate = cfg.attention_dropout if dropout_key is not None else 0.0
    if rate > 0.0:
        ctx = flash_attention(q, k, v, causal=causal, mask=mask,
                              dropout_rate=rate,
                              dropout_seed=attention_dropout_seed(dropout_key))
    else:
        ctx = flash_attention(q, k, v, causal=causal, mask=mask)
    ctx = ctx.transpose(1, 2).reshape(b, s, h)
    return _dense(ctx, p["out_kernel"], p["out_bias"])


def _mlp(p, x, cfg: GPTConfig):
    """FC1 + tanh-approximated GELU + FC2 (JAX ``_mlp``, dense FFN)."""
    y = F.gelu(_dense(x, p["fc1_kernel"], p["fc1_bias"]), approximate="tanh")
    return _dense(y, p["fc2_kernel"], p["fc2_bias"])


def _layer(p, x, cfg: GPTConfig, causal: bool = True, mask=None,
           dropout_key=None):
    """Pre-LN transformer layer (JAX ``_layer`` at tp = sp = 1): attention
    (with in-kernel attention dropout) -> hidden dropout -> residual; MLP
    -> hidden dropout -> residual. ``dropout_key`` splits in three:
    attention, then each branch's hidden dropout."""
    k_attn = k_h1 = k_h2 = None
    if dropout_key is not None:
        k_attn, k_h1, k_h2 = split(dropout_key, 3)
    a = _attention(p, layer_norm(x, p["ln1_w"], p["ln1_b"]), cfg, causal,
                   mask, dropout_key=k_attn)
    if k_h1 is not None and cfg.hidden_dropout > 0.0:
        a = hidden_dropout(a, cfg.hidden_dropout, k_h1)
    x = x + a
    m = _mlp(p, layer_norm(x, p["ln2_w"], p["ln2_b"]), cfg)
    if k_h2 is not None and cfg.hidden_dropout > 0.0:
        m = hidden_dropout(m, cfg.hidden_dropout, k_h2)
    return x + m


def dots_attn_policy():
    """What the ``"dots_attn"`` policy saves: the products with no batch
    dimension (``"dots"``) and flash's forward outputs (``"attn"``), o and
    lse both, as JAX names ``attn_out`` and ``attn_lse``, or backward would
    replay the forward kernel for lse."""
    return ("dots", "attn")


# what a recomputed layer saves under each remat_policy
_REMAT_SAVES = {"full": (), "dots": ("dots",), "dots_attn": dots_attn_policy()}


def _layer_stack(layers, x, cfg: GPTConfig, causal: bool = True, mask=None,
                 dropout_key=None):
    """The JAX ``lax.scan`` over the stacked layer params as a Python loop;
    with ``cfg.remat`` (and autograd recording) each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in backward, saving what
    ``cfg.remat_policy`` names. Layer i's dropout key is ``fold_in(key,
    i)``, an argument of the recomputed function, so the recompute drops
    the same elements. The stacked leaves are unbound once, so their
    gradients are stacked once in backward."""
    names = sorted(layers)
    per_leaf = [layers[k].unbind(0) for k in names]
    one = _layer
    if cfg.remat and torch.is_grad_enabled():
        one = checkpoint_saving(_layer, _REMAT_SAVES[cfg.remat_policy])
    for i, vals in enumerate(zip(*per_leaf)):
        key = None if dropout_key is None else fold_in(dropout_key, i)
        x = one(dict(zip(names, vals)), x, cfg, causal, mask, key)
    return x


def _embed_with_dropout(embed, tokens, cfg: GPTConfig, dropout_key):
    """The embedding, then (training) its hidden dropout under
    ``fold_in(key, 0x0E0B)``, a stream apart from the layers'."""
    x = embed_tokens(embed, tokens)
    if dropout_key is not None and cfg.hidden_dropout > 0.0:
        x = hidden_dropout(x, cfg.hidden_dropout,
                           fold_in(dropout_key, _EMBED_DROPOUT_SALT))
    return x


def tied_vocab_logits(x, tok_embed):
    """The tied LM head: logits = x @ tokᵀ, (b, s, vocab) in x's dtype."""
    return torch.matmul(x, tok_embed.t())


def gpt_head(params, x, cfg: GPTConfig):
    """Final LN + LM head -> logits (b, s, vocab)."""
    head = params["head"]
    x = layer_norm(x, head["ln_w"], head["ln_b"])
    if cfg.tie_embeddings:
        return tied_vocab_logits(x, params["embed"]["tok"])
    return _dense(x, head["lm"])


def gpt_forward(params, tokens, cfg: GPTConfig, dropout_key=None):
    """tokens (b, s) -> logits (b, s, vocab). ``dropout_key`` (a threefry
    ``uint32[2]``) turns on cfg's dropout rates: training mode."""
    cfg.validate()
    x = _embed_with_dropout(params["embed"], tokens, cfg, dropout_key)
    x = _layer_stack(params["layers"], x, cfg, dropout_key=dropout_key)
    return gpt_head(params, x, cfg)


def _use_fused_loss(cfg: GPTConfig, n_rows: int,
                    device: torch.device) -> bool:
    """The JAX ``_use_fused_loss``: the fused head where ``cfg.fused_loss``
    asks for it and, on the card, the kernel's shape gate holds
    (:func:`kernel_fits`, JAX's ``pallas_fits``); on the CPU always, as
    JAX runs its dense version off the TPU."""
    if not cfg.fused_loss:
        return False
    if device.type == "cpu":
        return True
    return kernel_fits(n_rows, cfg.hidden)


def fused_head_loss(head_rows_w, ln_w, ln_b, x, targets):
    """Final LayerNorm, then the fused LM-head + CE over the (vocab,
    hidden) projection rows ``head_rows_w``: the mean loss, 0-d fp32 (the
    JAX ``fused_head_loss`` at tp = 1)."""
    x = layer_norm(x, ln_w, ln_b)
    return lm_head_loss(x, head_rows_w, targets).mean()


def gpt_loss(params, tokens, targets, cfg: GPTConfig, dropout_key=None):
    """Mean cross-entropy of the next-token logits (the JAX ``gpt_loss``):
    a 0-d fp32 tensor. With ``cfg.fused_loss`` (and the kernel's shape
    gate on the card) the head is fused into the loss and the logits are
    never materialized; otherwise logits + ``vocab_parallel_cross_entropy``.
    ``dropout_key`` (a threefry ``uint32[2]``, JAX's key data) turns on
    cfg's dropout rates; None is eval mode.
    """
    cfg.validate()
    x = _embed_with_dropout(params["embed"], tokens, cfg, dropout_key)
    x = _layer_stack(params["layers"], x, cfg, dropout_key=dropout_key)
    if not _use_fused_loss(cfg, tokens.numel(), tokens.device):
        logits = gpt_head(params, x, cfg)
        return vocab_parallel_cross_entropy(logits, targets).mean()
    head = params["head"]
    w = (params["embed"]["tok"] if cfg.tie_embeddings
         else head["lm"].t())  # (vocab, hidden) rows
    return fused_head_loss(w, head["ln_w"], head["ln_b"], x, targets)
