"""The port's counter hash: uint32 arithmetic on int64 tensors (or Python
ints) for draws that must be a pure function of their coordinates — the
flash dropout mask (``ops/attention.py``, JAX's ``_hash_keep``), the
sampler's Gumbel noise (``serve/sampling.py``) and the codec's stochastic
rounding (``comm/quantize.py``); the CUDA kernels mix the same bits."""

from __future__ import annotations

M32 = 0xFFFFFFFF


def mul32(h, c: int):
    """(h * c) mod 2**32 for h in [0, 2**32) — python int or int64 tensor —
    without overflowing int64 (the product is split at 16 bits)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h):
    """murmur3's 32-bit finalizer: a bijection on [0, 2**32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)
