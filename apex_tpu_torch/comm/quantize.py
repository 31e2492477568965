"""Blockwise int8 / group int4 codec (counterpart of
``apex_tpu/comm/quantize.py``): plain PyTorch versions + the CUDA quantize
and dequantize kernels (``csrc/quantize.cu``).

Flat fp buffers are split into fixed-size blocks; each block carries one
fp32 scale ``absmax / qmax`` (1 for an all-zero block) and its codes
``clip(round(x / scale), -qmax, qmax)``, with round-half-to-even as
``jnp.round`` rounds. int4 codes are nibble-packed two per byte, the even
index in the low nibble: on the kernel path the quantize kernel writes the
nibbles and the dequantize kernel reads them (JAX packs and unpacks around
its kernels); elsewhere :func:`pack_int4` / :func:`unpack_int4` do.

Dispatch is JAX's (``_pallas_ok``, ``_ROWS_PER_STEP``, under their names):
``use_pallas=None`` launches the kernels for a CUDA tensor where the block
is a multiple of 128 and the rows a multiple of 32, and runs the reference
elsewhere and on the CPU (JAX: off a compiled backend); ``True`` takes the
kernels (their plain versions on the CPU), raising ``ValueError`` with
JAX's message outside the gate; ``False`` is the reference. The two paths
differ as JAX's do: the kernels' scale is amax · fp32(1/qmax) (XLA turns
the kernel's division by the constant qmax into that product), the
reference's the true quotient (``_quantize_jax``), one ulp apart in a few
blocks of a hundred. The serving path's quantized KV cache
(``serve/kv_cache.py``) calls the reference with ``use_pallas=False`` at
codec-block = head_dim, as the JAX KV path does.

Stochastic rounding (``stochastic=True``) rounds ``floor(x / scale + u)``.
JAX draws u from threefry or the TPU core's PRNG; neither is a bitwise
target here. The port's u is the top 24 bits of a counter hash of (seed,
flat element index) times 2⁻²⁴ (:func:`uniform_from_seed`, the sampler's
``fmix32``), computed the same way by the kernel and its plain version,
so the two agree bit for bit; each element's draw depends on nothing but
the seed and its index.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch._hash import M32, fmix32, mul32
from apex_tpu_torch.ops import _kernel_util as ku

QMAX = 127.0  # symmetric int8 code range; -128 is never emitted
QMAX4 = 7.0   # symmetric int4 code range; -8 is never emitted

_SIGNATURES = {
    "quantize_blockwise": [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_uint] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "dequantize_blockwise": [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


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


# ---------------------------------------------------------------------------
# dispatch: JAX's gate (``apex_tpu/comm/quantize.py:165-179``)

# JAX's int8 VREG tiling wants (32, 128) blocks: 32 rows a grid step
_ROWS_PER_STEP = 32


def _pallas_ok(n: int, block_size: int) -> bool:
    """Whether JAX runs its codec kernels at this size (``_pallas_ok`` with
    ``allow_interpret=True``): block % 128 == 0 and whole 32-row steps."""
    if block_size % 128 != 0:
        return False
    rows = n // block_size
    return n % block_size == 0 and rows % _ROWS_PER_STEP == 0


def _use_pallas(t: torch.Tensor, size: int, use_pallas: Optional[bool],
                what: str, arg: str = "block_size",
                n: Optional[int] = None) -> bool:
    """JAX's choice between its kernels and its reference: None takes the
    kernels inside the gate on a CUDA tensor (JAX: on a compiled backend)
    and the reference elsewhere; True takes them, raising JAX's message
    outside the gate; False takes the reference. ``n`` is the element
    count the gate sees (``t.numel()`` unless given: the unpacked length
    for packed int4 codes, as JAX gates after ``unpack_int4``)."""
    n = t.numel() if n is None else n
    if use_pallas is None:
        return _pallas_ok(n, size) and ku.use_kernel(t)
    if use_pallas and not _pallas_ok(n, size):
        raise ValueError(
            f"pallas {what} needs {arg} % 128 == 0 and rows % "
            f"{_ROWS_PER_STEP} == 0; got n={n}, {arg}={size}")
    return bool(use_pallas)


# ---------------------------------------------------------------------------
# plain versions


def uniform_from_seed(seed: int, n: int, device=None) -> torch.Tensor:
    """(n,) fp32 in [0, 1): element i's draw, the top 24 bits of
    ``fmix32(fmix32(seed) + i_lo·0x9E3779B1 + i_hi·0x85EBCA77)`` (uint32
    arithmetic) times 2⁻²⁴, exactly as the stochastic kernel draws it."""
    key = fmix32(int(seed) & M32)
    i = torch.arange(n, dtype=torch.int64, device=device)
    h = fmix32((key + mul32(i & M32, 0x9E3779B1)
                + mul32(i >> 32, 0x85EBCA77)) & M32)
    return (h >> 8).float() * 2.0 ** -24


def _codes(xb, scales, qmax: float, seed: Optional[int]):
    """int8 codes of (rows, block) fp32 ``xb`` at ``scales``: y = x / scale
    (tensor by tensor: IEEE division on every device), rounded half to
    even, or ⌊y + u⌋ with ``seed``; clipped to ±qmax."""
    y = xb / scales[:, None]
    if seed is None:
        q = torch.round(y)
    else:
        u = uniform_from_seed(seed, xb.numel(), xb.device)
        q = torch.floor(y + u.reshape(xb.shape))
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def quantize_blocks_reference(x2d: torch.Tensor, qmax: float = QMAX,
                              seed: Optional[int] = None,
                              packed: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantize kernel: (rows, block) -> (int8 codes
    (rows, block), or with ``packed`` their :func:`pack_int4` bytes (rows,
    block / 2); fp32 scales (rows,)); nearest rounding, or stochastic
    with ``seed``. The scale is amax · fp32(1/qmax), as JAX's kernel
    computes it (XLA turns its division by the constant qmax into that
    product): one ulp off :func:`_block_scales`' quotient in a few blocks
    of a hundred."""
    xb = x2d.float()
    amax = xb.abs().amax(dim=1)
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=xb.device)
    scales = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    codes = _codes(xb, scales, qmax, seed)
    return (pack_int4(codes) if packed else codes), scales


def dequantize_blocks_reference(q2d: torch.Tensor, scales: torch.Tensor,
                                packed: bool = False) -> torch.Tensor:
    """Plain version of the dequantize kernel: codes (or, with ``packed``,
    the :func:`unpack_int4` codes of (rows, block / 2) bytes) × per-row
    scale, fp32 (rows, block)."""
    if packed:
        q2d = unpack_int4(q2d)
    return q2d.float() * scales[:, None]


# ---------------------------------------------------------------------------
# kernel wrappers


class QuantPlan(NamedTuple):
    """Quantize kernel geometry: ``team`` lanes own a row (a power of 2 up
    to a warp), holding ``_VECS`` of its 16-byte vectors a lane at a time;
    ``resident``: a grid of resident CTAs walking the rows (else one row a
    team)."""
    team: int
    resident: bool


# 16-byte vectors of x a quantize lane holds at a time, and a CTA's
# threads (csrc/quantize.cu kVecs, kCta)
_VECS, _CTA = 4, 256


def _quant_plan(block: int, dtype: torch.dtype,
                stochastic: bool = False) -> QuantPlan:
    """The quantize kernel's geometry at (block, x type, rounding mode),
    block % 128 == 0: the fewest lanes, a power of 2 up to a warp, that
    hold the row's ``block / (16 / itemsize)`` vectors ``_VECS`` a lane.
    At a power-of-2 row of 16-128 vectors (the main path's B 256 and G
    128) every lane holds ``_VECS`` and the row stays in registers; a
    longer row is walked by a warp in chunks, read twice. A resident grid
    for stochastic rounding of a half type (bf16, fp16), the cells whose
    arithmetic, not their bytes, bounds them; one row a team elsewhere
    (both timed by chip_codec_compare.py)."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    if block <= 0 or block % 128:
        raise ValueError(f"quantize kernel: block ({block}) must be a "
                         f"positive multiple of 128")
    lanes = -(-(block // per) // _VECS)
    return QuantPlan(min(32, 1 << (lanes - 1).bit_length()),
                     stochastic and per == 8)


def _check_flat(what, t, dtypes, block):
    ku.require(t.is_cuda and t.dim() == 2 and t.is_contiguous(),
               f"{what} takes a contiguous 2-d (rows, block) CUDA tensor, "
               f"got {t.device} {tuple(t.shape)}")
    ku.require(t.dtype in dtypes,
               f"{what} takes {' or '.join(map(str, dtypes))}, got {t.dtype}")
    ku.require(block % 128 == 0,
               f"{what}: block ({block}) must be a multiple of 128")
    ku.require(t.data_ptr() % 16 == 0, f"{what}: tensors must be 16-byte "
                                       f"aligned")


def quantize_blocks(x2d: torch.Tensor, qmax: float = QMAX,
                    seed: Optional[int] = None, packed: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel on a CUDA (rows, block) fp32, bf16 or
    fp16 tensor (read in its own type, upcast inside the kernel, exactly),
    block % 128 == 0: returns (int8 codes (rows, block), or with
    ``packed`` (qmax <= 7) their nibble pairs, uint8 (rows, block / 2) in
    :func:`pack_int4`'s layout; fp32 scales (rows,)), rounded to nearest,
    or stochastically with ``seed``. Launches count as
    ``quantize_blockwise[nearest]`` or ``quantize_blockwise[stochastic]``."""
    _check_flat("quantize_blocks", x2d, ku.KERNEL_DTYPES,
                x2d.shape[-1] if x2d.dim() == 2 else 0)
    ku.require(not packed or qmax <= QMAX4,
               f"quantize_blocks: packed codes need qmax <= {QMAX4:g}, got "
               f"{qmax:g}")
    rows, block = x2d.shape
    plan = _quant_plan(block, x2d.dtype, seed is not None)
    q = torch.empty(rows, block // 2 if packed else block,
                    dtype=torch.uint8 if packed else torch.int8,
                    device=x2d.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    stochastic = seed is not None
    lib = ku.load_kernel("quantize", _SIGNATURES)
    status = lib.quantize_blockwise(
        x2d.device.index, x2d.data_ptr(), q.data_ptr(), scales.data_ptr(),
        rows, block, float(qmax), int(stochastic),
        fmix32(int(seed) & M32) if stochastic else 0,
        ku.dtype_code(x2d.dtype), int(packed), plan.team,
        int(plan.resident), ku.stream_handle(x2d))
    name = "stochastic" if stochastic else "nearest"
    ku.count_launch(f"quantize_blockwise[{name}]")
    ku.check_status(lib, status, "quantize_blocks")
    return q, scales


def dequantize_blocks(q2d: torch.Tensor, scales: torch.Tensor,
                      packed: bool = False) -> torch.Tensor:
    """Launch the dequantize kernel: CUDA int8 codes (rows, block), or with
    ``packed`` uint8 nibble pairs (rows, block / 2), block % 128 == 0, and
    fp32 scales (rows,) -> fp32 (rows, block)."""
    block = (2 if packed else 1) * (q2d.shape[-1] if q2d.dim() == 2 else 0)
    _check_flat("dequantize_blocks", q2d,
                (torch.uint8,) if packed else (torch.int8,), block)
    rows = q2d.shape[0]
    ku.require(scales.device == q2d.device and scales.dtype == torch.float32
               and tuple(scales.shape) == (rows,) and scales.is_contiguous(),
               f"dequantize_blocks: scales must be a contiguous ({rows},) "
               f"fp32 tensor on {q2d.device}")
    y = torch.empty(rows, block, dtype=torch.float32, device=q2d.device)
    lib = ku.load_kernel("quantize", _SIGNATURES)
    status = lib.dequantize_blockwise(
        q2d.device.index, q2d.data_ptr(), scales.data_ptr(), y.data_ptr(),
        rows * block, block, int(packed), ku.stream_handle(q2d))
    ku.count_launch("dequantize_blockwise")
    ku.check_status(lib, status, "dequantize_blocks")
    return y


# ---------------------------------------------------------------------------
# public API


def _check_quantize_args(x_flat, size: int, stochastic: bool, seed,
                         arg: str = "block_size") -> None:
    if x_flat.dim() != 1:
        raise ValueError(f"expected flat buffer, got shape "
                         f"{tuple(x_flat.shape)}")
    if arg == "group_size" and size % 2:
        raise ValueError(f"int4 group_size must be even (nibble packing): "
                         f"{size}")
    if x_flat.numel() % size != 0:
        raise ValueError(f"size {x_flat.numel()} not a multiple of "
                         f"{arg} {size}")
    if stochastic and seed is None:
        raise ValueError("stochastic quantization needs a seed")


def _quantize(x_flat, block_size: int, stochastic: bool, seed, qmax: float,
              use_pallas: bool, packed: bool = False):
    """JAX's two paths: the kernel's math (``use_pallas``: the kernel on
    CUDA, its plain version on the CPU) or its reference (the scale a
    true quotient, as ``_quantize_jax`` divides). ``packed``: the codes as
    nibble pairs (written by the kernel on its path). The kernel takes
    fp32, bf16 and fp16 buffers as they are and upcasts inside, as JAX's
    kernel does (exact: an fp16 buffer's codes and scales are those of its
    fp32 values); another float type is cast to fp32 first."""
    seed = int(seed) if stochastic else None
    x2d = x_flat.reshape(-1, block_size)
    if not use_pallas:
        xb = x2d.float()
        scales = _block_scales(xb, qmax)
        q = _codes(xb, scales, qmax, seed).reshape(-1)
        return (pack_int4(q) if packed else q), scales
    if ku.use_kernel(x_flat):
        x = x2d.contiguous()
        if x.dtype not in ku.KERNEL_DTYPES:
            x = x.float()
        q, s = quantize_blocks(x, qmax, seed, packed)
    else:
        q, s = quantize_blocks_reference(x2d, qmax, seed, packed)
    return q.reshape(-1), s


def quantize_blockwise(x_flat: torch.Tensor, block_size: int = 256,
                       stochastic: bool = False, seed=None,
                       use_pallas: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat fp buffer -> (int8 codes (n,), fp32 per-block scales (n/B,)).
    ``x_flat.numel()`` must be a multiple of ``block_size``; ``seed``
    (an int) is required when ``stochastic``, and the codes are a
    function of it. ``use_pallas`` as the module says."""
    _check_quantize_args(x_flat, block_size, stochastic, seed)
    return _quantize(x_flat, block_size, stochastic, seed, QMAX,
                     _use_pallas(x_flat, block_size, use_pallas, "quantize"))


def _dequantize(q_flat, scales, block_size: int, use_pallas, packed: bool):
    """JAX's checks and gate on the codes' length (for nibble pairs the
    unpacked length, as JAX gates after ``unpack_int4``); the kernel reads
    the codes or nibbles on its path, elsewhere the reference runs on the
    (unpacked) codes."""
    n = (2 if packed else 1) * q_flat.numel()
    if n % block_size != 0:
        raise ValueError(f"size {n} not a multiple of block_size "
                         f"{block_size}")
    return _dequantize_on(
        q_flat, scales, block_size,
        _use_pallas(q_flat, block_size, use_pallas, "dequantize", n=n),
        packed)


def _dequantize_on(q_flat, scales, block_size: int, kernels: bool,
                   packed: bool):
    """The kernel for a CUDA tensor when ``kernels``, else the reference
    on the (unpacked) codes — the dequantize kernel's plain version is
    the same product."""
    if kernels and ku.use_kernel(q_flat):
        width = block_size // 2 if packed else block_size
        return dequantize_blocks(q_flat.reshape(-1, width).contiguous(),
                                 scales.float().contiguous(),
                                 packed).reshape(-1)
    codes = unpack_int4(q_flat) if packed else q_flat
    return dequantize_blocks_reference(codes.reshape(-1, block_size),
                                       scales).reshape(-1)


def dequantize_blockwise(q_flat: torch.Tensor, scales: torch.Tensor,
                         block_size: int = 256,
                         use_pallas: Optional[bool] = None) -> torch.Tensor:
    """(int8 codes, fp32 scales) -> fp32 flat buffer."""
    return _dequantize(q_flat, scales, block_size, use_pallas, False)


def quantization_error(x_flat: torch.Tensor,
                       block_size: int = 256) -> torch.Tensor:
    """Round-trip error ``x - dq(q(x))`` of the deterministic codec — the
    quantity error feedback re-injects."""
    q, s = quantize_blockwise(x_flat, block_size)
    return x_flat.float() - dequantize_blockwise(q, s, block_size)


def quantize_blockwise_int4(x_flat: torch.Tensor, group_size: int = 128,
                            stochastic: bool = False, seed=None,
                            use_pallas: Optional[bool] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat fp buffer -> (packed uint8 codes (n/2,), fp32 per-group scales
    (n/G,)). ``x_flat.numel()`` must be a multiple of the (even) group;
    ``seed`` and ``use_pallas`` as in :func:`quantize_blockwise`."""
    _check_quantize_args(x_flat, group_size, stochastic, seed, "group_size")
    return _quantize(x_flat, group_size, stochastic, seed, QMAX4,
                     _use_pallas(x_flat, group_size, use_pallas,
                                 "int4 quantize", "group_size"), packed=True)


def dequantize_blockwise_int4(packed: torch.Tensor, scales: torch.Tensor,
                              group_size: int = 128,
                              use_pallas: Optional[bool] = None
                              ) -> torch.Tensor:
    """(packed uint8 codes, fp32 group scales) -> fp32 flat buffer. JAX's
    checks and gate on the unpacked length; on the kernel path the
    kernel reads the nibbles, elsewhere :func:`unpack_int4` and the
    reference."""
    return _dequantize(packed, scales, group_size, use_pallas, True)


def quantization_error_int4(x_flat: torch.Tensor,
                            group_size: int = 128) -> torch.Tensor:
    """Round-trip error of the deterministic int4 codec (the EF residual
    quantity for the ``int4_ef`` policy)."""
    q, s = quantize_blockwise_int4(x_flat, group_size)
    return x_flat.float() - dequantize_blockwise_int4(q, s, group_size)
