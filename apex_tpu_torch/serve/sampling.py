"""Token sampling for the decode loop (counterpart of
``apex_tpu/serve/sampling.py``): greedy, temperature, top-k and nucleus
(top-p) filtering in that order, then a Gumbel-max draw.

Greedy (``temperature == 0``) is argmax over fp32 logits with the first
maximal index winning, as ``jnp.argmax`` does, so greedy streams match the
JAX engine token for token.

Sampled draws cannot match JAX: its keys are threefry ``fold_in`` +
``categorical``. The port keys each draw with a counter-based 32-bit
integer hash (murmur3's ``fmix32``) of (request key, absolute position,
vocab index), computed with plain int64 tensor ops, and turns it into a
Gumbel variate. That keeps the two properties of the JAX design: the draw
for "request r, position p" depends on nothing else (request-order
invariance: slot, batch and admission time do not matter), and a verify
step's q draws are exactly the ones sequential decode makes (speculative
streams equal plain streams). Its distribution is the softmax (tested by
a chi-square test).
"""

from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch._hash import M32, fmix32, mul32

_TWO32 = float(2 ** 32)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``temperature == 0`` -> greedy (argmax; top_k/top_p ignored).
    ``top_k == 0`` / ``top_p == 1.0`` disable the respective filter."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def validate(self) -> None:
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")


def request_key(base_seed: int, request_seed: int) -> int:
    """The request's own 32-bit key from the engine's base seed and the
    request-intrinsic seed (never an admission index)."""
    return fmix32(fmix32(int(base_seed) & M32) ^ (int(request_seed) & M32))


def step_keys(keys, positions):
    """Fold each row's absolute position into its request key: int64 (n,)
    keys and positions -> (n,) per-draw keys in [0, 2**32)."""
    p = (positions.long() + 1) & M32
    return fmix32(keys.long() ^ mul32(p, 0x9E3779B1))


def gumbel_noise(keys, positions, vocab: int):
    """(n, vocab) float64 Gumbel variates, a pure function of (key,
    position, vocab index). Within a row, distinct indices give distinct
    hash values (both mixes are bijections)."""
    sk = step_keys(keys, positions)
    vidx = torch.arange(vocab, device=sk.device, dtype=torch.int64)
    bits = fmix32(sk[:, None] ^ fmix32(vidx + 0x632BE5AB)[None, :])
    u = (bits.double() + 0.5) / _TWO32                # in (0, 1)
    return -torch.log(-torch.log(u))


def _top_k_mask(x, k: int):
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    return torch.where(x < kth, float("-inf"), x)


def _top_p_mask(x, p: float):
    """Nucleus filter: keep the smallest prefix of the probability-sorted
    vocab whose exclusive cumulative mass is < p (the top token always
    survives)."""
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_x, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    thresh = torch.where(cum_excl < p, sorted_x,
                         float("inf")).min(dim=-1, keepdim=True).values
    return torch.where(x < thresh, float("-inf"), x)


def sample(logits, keys, positions, cfg: SamplingConfig):
    """(n, vocab) fp32 logits -> (n,) int32 tokens.

    ``keys``: (n,) int64 request keys; ``positions``: (n,) absolute
    position of the token being sampled. Also takes (n, q, vocab) logits
    with (n, q) positions (the verify shape: q draws per slot under one
    request key) and returns (n, q). Greedy ignores keys and positions.
    """
    if logits.dim() == 3:
        n, q, v = logits.shape
        flat = sample(logits.reshape(n * q, v),
                      keys.repeat_interleave(q), positions.reshape(n * q),
                      cfg)
        return flat.reshape(n, q)
    logits = logits.float()
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits / cfg.temperature
    if 0 < cfg.top_k < logits.shape[-1]:
        x = _top_k_mask(x, cfg.top_k)
    if cfg.top_p < 1.0:
        x = _top_p_mask(x, cfg.top_p)
    g = gumbel_noise(keys, positions, logits.shape[-1])
    return torch.argmax(x.double() + g, dim=-1).to(torch.int32)
