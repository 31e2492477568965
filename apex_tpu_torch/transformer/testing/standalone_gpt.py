"""Standalone GPT config and parameters (counterpart of
``apex_tpu/transformer/testing/standalone_gpt.py``), for serving.

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

Only the single-device serving fields of ``GPTConfig`` are ported; the
training fields (remat, fused loss, dropout, sequence parallelism, MoE,
kernel block sizes) come with the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from apex_tpu_torch._device import DeviceLike
from apex_tpu_torch.convert import params_from_numpy


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT-2-124M-class defaults: vocab 50304, hidden 768, 12 layers, 12
    heads (head_dim 64), max_seq 1024, bf16, tied embeddings."""

    vocab_size: int = 50304
    max_seq: int = 1024
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_mult: int = 4
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = True

    @property
    def ffn_hidden(self) -> int:
        return self.ffn_mult * self.hidden

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    def validate(self) -> None:
        if self.hidden % self.num_heads:
            raise ValueError("hidden must be divisible by num_heads")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got "
                             f"{self.dtype}")


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
