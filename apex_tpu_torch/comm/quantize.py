"""Blockwise int8 / group int4 codec (counterpart of
``apex_tpu/comm/quantize.py``), deterministic mode, plain PyTorch.

Flat fp buffers are split into fixed-size blocks; each block carries one
fp32 scale ``absmax / qmax`` (1 for an all-zero block) and its codes
``clip(round(x / scale), -qmax, qmax)``, with round-half-to-even as
``jnp.round`` rounds. int4 codes are nibble-packed two per byte, the even
index in the low nibble.

The serving path's quantized KV cache (``serve/kv_cache.py``) calls this
math at codec-block = head_dim, as the JAX KV path calls it with
``use_pallas=False``. Not ported here, both ROADMAP §A item 7 (the
compressed collectives, the only callers of either):

* ``stochastic=True`` — JAX draws the rounding noise from threefry or the
  TPU core's PRNG; the port's stream is for the comm slice to decide;
* ``use_pallas=True`` — the codec kernels (ROADMAP §B #16-18).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

QMAX = 127.0  # symmetric int8 code range; -128 is never emitted
QMAX4 = 7.0   # symmetric int4 code range; -8 is never emitted


def qmax_for_bits(bits: int) -> float:
    if bits == 8:
        return QMAX
    if bits == 4:
        return QMAX4
    raise ValueError(f"unsupported code width: {bits} bits")


def blocks_for(n: int, block_size: int) -> int:
    """Number of scale blocks covering ``n`` elements."""
    return -(-n // block_size)


def padded_size(n: int, block_size: int) -> int:
    return blocks_for(n, block_size) * block_size


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as XLA and the CUDA kernels divide: PyTorch
    multiplies by the reciprocal when the divisor is a Python number on
    CUDA, which can land one ulp off."""
    return x / torch.full_like(x, d)


def _block_scales(xb: torch.Tensor, qmax: float = QMAX) -> torch.Tensor:
    """(rows, block) fp32 -> (rows,) fp32 scale = absmax/qmax, with all-zero
    blocks mapped to scale 1 (their codes are 0 anyway)."""
    amax = xb.abs().amax(dim=1)
    return torch.where(amax > 0, divide(amax, qmax), torch.ones_like(amax))


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7], even-sized last axis -> uint8 packed pairs
    (last axis halved; even index in the low nibble)."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis: "
                         f"{tuple(q.shape)}")
    lo = q[..., 0::2].to(torch.uint8) & 0xF
    hi = q[..., 1::2].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 packed pairs -> int8 codes (last axis doubled); the exact
    inverse of :func:`pack_int4` for codes in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])


def _refuse_unported(stochastic: bool, use_pallas: Optional[bool]) -> None:
    if stochastic:
        raise NotImplementedError(
            "stochastic rounding is not ported: its random stream is "
            "decided with the compressed collectives, ROADMAP §A item 7")
    if use_pallas:
        raise NotImplementedError(
            "the codec kernels (use_pallas=True) are not ported: they run "
            "only under the compressed collectives, ROADMAP §A item 7")


def _quantize(x_flat, block_size: int, qmax: float):
    xb = x_flat.float().reshape(-1, block_size)
    scales = _block_scales(xb, qmax)
    q = torch.clamp(torch.round(xb / scales[:, None]), -qmax, qmax)
    return q.to(torch.int8).reshape(-1), scales


def quantize_blockwise(x_flat: torch.Tensor, block_size: int = 256,
                       stochastic: bool = False, seed=None,
                       use_pallas: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat fp buffer -> (int8 codes (n,), fp32 per-block scales (n/B,)).
    ``x_flat.numel()`` must be a multiple of ``block_size``."""
    if x_flat.dim() != 1:
        raise ValueError(f"expected flat buffer, got shape "
                         f"{tuple(x_flat.shape)}")
    if x_flat.numel() % block_size != 0:
        raise ValueError(f"size {x_flat.numel()} not a multiple of "
                         f"block_size {block_size}")
    if stochastic and seed is None:
        raise ValueError("stochastic quantization needs a seed")
    _refuse_unported(stochastic, use_pallas)
    return _quantize(x_flat, block_size, QMAX)


def dequantize_blockwise(q_flat: torch.Tensor, scales: torch.Tensor,
                         block_size: int = 256,
                         use_pallas: Optional[bool] = None) -> torch.Tensor:
    """(int8 codes, fp32 scales) -> fp32 flat buffer."""
    if q_flat.numel() % block_size != 0:
        raise ValueError(f"size {q_flat.numel()} not a multiple of "
                         f"block_size {block_size}")
    _refuse_unported(False, use_pallas)
    qb = q_flat.reshape(-1, block_size).float()
    return (qb * scales[:, None]).reshape(-1)


def quantization_error(x_flat: torch.Tensor,
                       block_size: int = 256) -> torch.Tensor:
    """Round-trip error ``x - dq(q(x))`` of the deterministic codec."""
    q, s = quantize_blockwise(x_flat, block_size)
    return x_flat.float() - dequantize_blockwise(q, s, block_size)


def quantize_blockwise_int4(x_flat: torch.Tensor, group_size: int = 128,
                            stochastic: bool = False, seed=None,
                            use_pallas: Optional[bool] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat fp buffer -> (packed uint8 codes (n/2,), fp32 per-group scales
    (n/G,)). ``x_flat.numel()`` must be a multiple of the (even) group."""
    if x_flat.dim() != 1:
        raise ValueError(f"expected flat buffer, got shape "
                         f"{tuple(x_flat.shape)}")
    if group_size % 2:
        raise ValueError(f"int4 group_size must be even (nibble packing): "
                         f"{group_size}")
    if x_flat.numel() % group_size != 0:
        raise ValueError(f"size {x_flat.numel()} not a multiple of "
                         f"group_size {group_size}")
    if stochastic and seed is None:
        raise ValueError("stochastic quantization needs a seed")
    _refuse_unported(stochastic, use_pallas)
    q, s = _quantize(x_flat, group_size, QMAX4)
    return pack_int4(q), s


def dequantize_blockwise_int4(packed: torch.Tensor, scales: torch.Tensor,
                              group_size: int = 128,
                              use_pallas: Optional[bool] = None
                              ) -> torch.Tensor:
    """(packed uint8 codes, fp32 group scales) -> fp32 flat buffer."""
    return dequantize_blockwise(unpack_int4(packed), scales, group_size,
                                use_pallas=use_pallas)


def quantization_error_int4(x_flat: torch.Tensor,
                            group_size: int = 128) -> torch.Tensor:
    """Round-trip error of the deterministic int4 codec."""
    q, s = quantize_blockwise_int4(x_flat, group_size)
    return x_flat.float() - dequantize_blockwise_int4(q, s, group_size)
