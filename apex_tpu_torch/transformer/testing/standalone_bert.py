"""Standalone Megatron-style BERT (counterpart of
``apex_tpu/transformer/testing/standalone_bert.py``): the GPT layer stack
run bidirectionally (``causal=False``) with an optional padding mask,
token + position + token-type embeddings and their LayerNorm, and the
tied MLM head with Megatron's dense -> GELU -> LayerNorm transform.

Single device, the JAX tp = 1 program. An unpadded call runs the
non-causal flash kernels (B #5-8 on the card); a padded call takes
:func:`~apex_tpu_torch.ops.attention.attention_reference`, as JAX sends a
masked call to its XLA path. The parameter tree is JAX's:

==============================  ==========================
``embed.tok`` / ``embed.pos``   (vocab, h) / (max_seq, h)
``embed.type``                  (num_token_types, h)
``embed.ln_w`` / ``embed.ln_b`` (h,)
``layers.*``                    GPT's stacked layers
``head.dense_kernel``           (h, h)
``head.dense_bias``, ``head.ln_w``, ``head.ln_b``  (h,)
==============================  ==========================
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch._device import DeviceLike
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTConfig,
    _dense,
    _layer_stack,
    embed_tokens,
    init_gpt_params_numpy,
    tied_vocab_logits,
)


@dataclasses.dataclass(frozen=True)
class BertConfig(GPTConfig):
    """GPT's fields (GPT-2-124M's widths by default) and the number of
    token types. ``megatron_sp`` and ``num_experts`` stay refused (A7c, A7d)."""

    num_token_types: int = 2


def init_bert_params_numpy(cfg: BertConfig, seed: int = 0
                           ) -> Dict[str, Any]:
    """The parameter tree as float32 numpy arrays from numpy seed
    ``seed``, with JAX's scheme: GPT's embeddings and layers
    (:func:`init_gpt_params_numpy`), normal(0.02) token-type table and
    head dense kernel, zero biases, unit LN weights."""
    params = init_gpt_params_numpy(dataclasses.replace(
        cfg, tie_embeddings=True), seed)
    rng = np.random.default_rng([seed, 1])
    h = cfg.hidden

    def normal(shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            0.02)

    params["embed"].update(type=normal((cfg.num_token_types, h)),
                           ln_w=np.ones(h, np.float32),
                           ln_b=np.zeros(h, np.float32))
    params["head"] = {"dense_kernel": normal((h, h)),
                      "dense_bias": np.zeros(h, np.float32),
                      "ln_w": np.ones(h, np.float32),
                      "ln_b": np.zeros(h, np.float32)}
    return params


def init_bert_params(cfg: BertConfig, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters from a numpy seed, as ``cfg.dtype`` tensors on
    ``device`` (default ``cuda``)."""
    return params_from_numpy(init_bert_params_numpy(cfg, seed), device,
                             dtype=cfg.dtype)


def _bert_logits(params, tokens, cfg: BertConfig, token_types=None,
                 padding_mask=None):
    """MLM logits (b, s, vocab) in the model's dtype (JAX's
    ``_bert_logits`` at tp = 1, no MoE aux loss)."""
    cfg.validate()
    e = params["embed"]
    x = embed_tokens(e, tokens)
    if token_types is not None:
        x = x + F.embedding(token_types, e["type"]).to(x.dtype)
    x = layer_norm(x, e["ln_w"], e["ln_b"])
    mask = None if padding_mask is None else padding_mask[:, None, None, :]
    x = _layer_stack(params["layers"], x, cfg, causal=False, mask=mask)
    h = params["head"]
    x = F.gelu(_dense(x, h["dense_kernel"], h["dense_bias"]),
               approximate="tanh")
    x = layer_norm(x, h["ln_w"], h["ln_b"])
    return tied_vocab_logits(x, e["tok"])


def bert_forward(params, tokens, cfg: BertConfig, token_types=None,
                 padding_mask=None):
    """tokens (b, s) -> MLM logits (b, s, vocab). ``padding_mask`` (b, s):
    True = pad, masked out of attention as a key."""
    return _bert_logits(params, tokens, cfg, token_types, padding_mask)


def bert_mlm_loss(params, tokens, targets, loss_mask, cfg: BertConfig,
                  token_types=None, padding_mask=None):
    """Masked-LM loss: the cross entropy over the positions where
    ``loss_mask`` (b, s) is 1, their mean (0-d fp32)."""
    logits = _bert_logits(params, tokens, cfg, token_types, padding_mask)
    per_tok = vocab_parallel_cross_entropy(logits, targets)
    m = loss_mask.to(torch.float32)
    return (per_tok * m).sum() / torch.clamp(m.sum(), min=1.0)
