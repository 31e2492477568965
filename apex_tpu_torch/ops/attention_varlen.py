"""Packed variable-length attention: plain PyTorch versions + the CUDA
varlen flash kernels (counterpart of ``apex_tpu/ops/attention_varlen.py``).

A packed batch holds several documents in one (b, h, s, d) row, told
apart by (b, s) int32 segment ids, -1 for padding. A score is allowed
where ``seg_q == seg_k >= 0`` (and ``kpos <= qpos`` when causal); pad
queries attend to nothing and output 0. The forward kernel
(:func:`flash_varlen_fwd`) returns ``o`` and the row log-sum-exp ``lse``
(fp32, (b, h, s, 1), NEG_INF on rows with no allowed score); the
backward is two kernels, :func:`flash_varlen_bwd_dq` and
:func:`flash_varlen_bwd_dkv`, which mask p by value (a pad row's lse is
NEG_INF and ``exp(s - lse)`` would give 1). :class:`VarlenAttention` ties
them into autograd; each dispatches by device (the kernel for a CUDA
tensor, its plain version for a CPU tensor). One route
(:func:`_varlen_route`) decides all three kernels: bf16 at head_dim <= 256
runs on the tensor cores (``csrc/flash_varlen_mma.cu``, counted as
``flash_varlen_mma_fwd``, ``flash_varlen_mma_bwd_dq`` and
``flash_varlen_mma_bwd_dkv``), fp32 at every head_dim and bf16 above 256
on the CUDA cores (``csrc/flash_varlen.cu``, ``flash_varlen_fwd``,
``flash_varlen_bwd_dq`` and ``flash_varlen_bwd_dkv``).

Block skipping, as JAX does it: per 64-row tile the [min, max] segment id
(:func:`_block_ranges`; the kernels take the min over real tokens,
:func:`_real_ranges`), which tiles can meet at all
(:func:`_interact_matrix`) and each tile's live range of the other axis
(:func:`_live_range`), all computed with torch on the tensor's device,
with no host sync. A block of the forward or dQ kernel walks only its q
tile's live K/V tiles; a dK/dV block only its K/V tile's live q tiles.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _kernel_util as ku
# _TILE: rows of a kernel tile; sequences are padded to a multiple of it
# with segment -1 (pad keys match nothing, pad rows output 0 and are sliced
# off)
from apex_tpu_torch.ops.attention import _MMA_MAX_HEAD_DIM, _TILE, NEG_INF
# device, q, k, v, seg_q, seg_k, q ranges, k ranges
_HEAD = [ctypes.c_int] + [ctypes.c_void_p] * 7
# b, h, sq, sk, d, scale, causal, dtype code, stream
_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
_SIGNATURES = {
    "flash_varlen_fwd": _HEAD + [ctypes.c_void_p] * 2 + _TAIL,
    "flash_varlen_bwd_dq": _HEAD + [ctypes.c_void_p] * 4 + _TAIL,
    "flash_varlen_bwd_dkv": _HEAD + [ctypes.c_void_p] * 5 + _TAIL,
}
# the tensor-core kernels (csrc/flash_varlen_mma.cu): the CUDA-core
# entries' arguments, with the block order after the tables
_MMA_SIGNATURES = {
    "flash_varlen_mma_fwd": _HEAD + [ctypes.c_void_p] * 3 + _TAIL,
    "flash_varlen_mma_bwd_dq": _HEAD + [ctypes.c_void_p] * 5 + _TAIL,
    "flash_varlen_mma_bwd_dkv": _HEAD + [ctypes.c_void_p] * 6 + _TAIL,
}


def _varlen_route(dtype, d: int) -> str:
    """Which kernels run the varlen forward, dQ and dK/dV at this input
    dtype and head dim on the card: ``"tensor_core"`` (bf16 or fp16, d <=
    256: ``flash_varlen_mma.cu``) or ``"cuda_core"`` (fp32 at every d,
    bf16 and fp16 above 256: ``flash_varlen.cu``, fp32 products). A head
    dim that is not a positive multiple of 8 raises, as the kernels' gate
    refuses it."""
    if not (d % 8 == 0 and d > 0):
        raise ValueError(f"head_dim {d} must be a positive multiple of 8")
    if dtype in ku.HALF_DTYPES and d <= _MMA_MAX_HEAD_DIM:
        return "tensor_core"
    return "cuda_core"


# ---------------------------------------------------------------------------
# plain versions


def attention_varlen_reference(q, k, v, seg_q, seg_k=None,
                               causal: bool = False,
                               scale: Optional[float] = None):
    """Dense segment-masked attention, JAX's ``attention_varlen_reference``;
    pad (seg < 0) query rows output 0. ``q``/``k``/``v``: (b, h, s, d);
    ``seg_q``/``seg_k``: (b, s) int32. Returns q.dtype."""
    if seg_k is None:
        seg_k = seg_q
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    allowed = _allowed(seg_q, seg_k, causal)
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)


def _allowed(seg_q, seg_k, causal: bool):
    """(b, 1, sq, sk) bool: seg_q == seg_k >= 0, and kpos <= qpos if
    causal (absolute positions, as JAX's varlen mask)."""
    sq_col = seg_q[:, None, :, None]
    allowed = (sq_col == seg_k[:, None, None, :]) & (sq_col >= 0)
    if causal:
        qpos = torch.arange(seg_q.shape[1], device=seg_q.device)
        kpos = torch.arange(seg_k.shape[1], device=seg_k.device)
        allowed = allowed & (kpos[None, :] <= qpos[:, None])
    return allowed


def _scores(q, k, seg_q, seg_k, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    allowed = _allowed(seg_q, seg_k, causal)
    return torch.where(allowed, s, NEG_INF), allowed


def flash_varlen_fwd_reference(q, k, v, seg_q, seg_k, scale: float,
                               causal: bool):
    """Plain version of the forward kernel over (b, h, s, d): ``(o, lse)``,
    o in q's type, lse fp32 (b, h, sq, 1). Like the kernel, p is masked by
    value and rounded to v's type before p @ v; a row with no allowed
    score gives o = 0 and lse = NEG_INF."""
    s, allowed = _scores(q, k, seg_q, seg_k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    o = (acc / safe_l).to(q.dtype)
    lse = torch.where(empty, NEG_INF, m + torch.log(safe_l))
    return o, lse


def flash_varlen_bwd_reference(q, k, v, seg_q, seg_k, o, lse, do,
                               scale: float, causal: bool):
    """Plain version of the dQ and dK/dV kernels: ``(dq, dk, dv)`` in the
    inputs' types. p = exp(s − lse) where allowed, else 0 (by value: a pad
    row's lse is NEG_INF); dp = dO·vᵀ, ds = p·(dp − Δ)·scale with Δ = Σ
    dO·O; ds and p are rounded to the input type before each product, fp32
    accumulation."""
    s, allowed = _scores(q, k, seg_q, seg_k, scale, causal)
    p = torch.where(allowed, torch.exp(s - lse), 0.0)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# block skipping (JAX's launch plumbing, on the tensor's device)


def _block_ranges(seg, block: int):
    """(b, s) -> per-block (b, s // block) min and max segment ids."""
    b, s = seg.shape
    r = seg.reshape(b, s // block, block)
    return r.amin(dim=2), r.amax(dim=2)


def _interact_matrix(qmin, qmax, kmin, kmax, causal: bool, block_q: int,
                     block_k: int):
    """(b, nq, nk) bool: can q block i and kv block j interact at all?
    The kernels' skip predicate exactly."""
    inter = ((qmin[:, :, None] <= kmax[:, None, :])
             & (qmax[:, :, None] >= kmin[:, None, :])
             & (qmax[:, :, None] >= 0) & (kmax[:, None, :] >= 0))
    if causal:
        i = torch.arange(qmin.shape[1], device=qmin.device)[None, :, None]
        j = torch.arange(kmin.shape[1], device=kmin.device)[None, None, :]
        inter = inter & (j * block_k <= i * block_q + block_q - 1)
    return inter


def _live_range(inter, axis: int):
    """First/last True index along ``axis`` of the interact matrix, int32
    (0 for both when the row is empty: the kernels then skip that one
    tile too)."""
    n = inter.shape[axis]
    hit = inter.to(torch.int32)
    any_ = inter.any(dim=axis)
    lo = torch.where(any_, hit.argmax(dim=axis), 0)
    hi = torch.where(any_, n - 1 - hit.flip(axis).argmax(dim=axis), 0)
    return lo.to(torch.int32), hi.to(torch.int32)


def _real_ranges(seg):
    """Per-tile [min, max] segment ids over the tile's real tokens. JAX's
    ``_block_ranges`` counts a pad as -1, so a tile that holds the end of
    a document and padding spans [-1, doc] and meets every tile up to that
    document: its block walks the whole row (the packed path's critical
    path). Pads match nothing, so leaving them out of the min skips only
    tiles that cannot meet; an all-pad tile gets [INT32_MAX, -1] and meets
    none."""
    _, mx = _block_ranges(seg, _TILE)
    mn, _ = _block_ranges(
        torch.where(seg < 0, torch.iinfo(torch.int32).max, seg), _TILE)
    return mn, mx


def _tile_ranges(seg_q, seg_k, causal: bool):
    """The kernels' per-tile tables, int32: ``(qr, kr)`` of shapes (b, nq,
    4) = [qmin, qmax, jlo, jhi] and (b, nk, 4) = [kmin, kmax, ilo, ihi]
    (each tile's segment range over its real tokens, and its live range of
    the other axis)."""
    qmin, qmax = _real_ranges(seg_q)
    kmin, kmax = _real_ranges(seg_k)
    inter = _interact_matrix(qmin, qmax, kmin, kmax, causal, _TILE, _TILE)
    jlo, jhi = _live_range(inter, axis=2)
    ilo, ihi = _live_range(inter, axis=1)
    qr = torch.stack([qmin, qmax, jlo, jhi], dim=-1).to(torch.int32)
    kr = torch.stack([kmin, kmax, ilo, ihi], dim=-1).to(torch.int32)
    return qr.contiguous(), kr.contiguous()


def _tables(seg_q, seg_k, causal: bool, with_order: bool):
    """What the kernels read beside the tensors: ``(qr, kr, kv_order,
    q_order)``, the per-tile tables of :func:`_tile_ranges` and, when
    ``with_order`` (the tensor-core route, their only reader; else None
    and None), the block orders: ``kv_order`` (b, nk) int32, dK/dV's,
    each batch row's K/V tiles by live q range (``ihi - ilo``), and
    ``q_order`` (b, nq) int32, the forward's and dQ's, its q tiles by live
    K/V range (``jhi - jlo``); longest first (a stable sort: ties in tile
    order), so the blocks that walk the most tiles start first. Built once
    per :class:`VarlenAttention` call, with torch on the tensors'
    device."""
    qr, kr = _tile_ranges(seg_q, seg_k, causal)
    if not with_order:
        return qr, kr, None, None
    kv_order, q_order = (
        torch.argsort(r[..., 2] - r[..., 3], dim=1,
                      stable=True).to(torch.int32).contiguous()
        for r in (kr, qr))
    return qr, kr, kv_order, q_order


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_varlen(what, q, k, v, seg_q, seg_k, *others):
    """Checks the kernels' inputs; returns ``(b, h, sq, sk, d)``."""
    ku.require(q.is_cuda and q.dim() == 4,
               f"{what} takes 4-d (b, h, s, d) CUDA tensors, got {q.device} "
               f"{tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    ku.require(q.dtype in ku.KERNEL_DTYPES,
               f"{what} takes fp32, bf16 or fp16, got {q.dtype}")
    ku.require(d % 8 == 0 and d > 0,
               f"{what}: head_dim {d} must be a positive multiple of 8")
    ku.require(sq % _TILE == 0 and sk % _TILE == 0,
               f"{what}: sequence lengths ({sq}, {sk}) must be multiples of "
               f"{_TILE} (flash_attention_varlen pads them)")
    ku.require(b * h < 65536, f"{what}: b*h ({b * h}) must be < 65536")
    for name, t, shape, dtype in (
            ("k", k, (b, h, sk, d), q.dtype), ("v", v, (b, h, sk, d), q.dtype),
            ("seg_q", seg_q, (b, sq), torch.int32),
            ("seg_k", seg_k, (b, sk), torch.int32), *others):
        ku.require(t.device == q.device and t.dtype == dtype
                   and tuple(t.shape) == shape and t.is_contiguous()
                   and t.data_ptr() % 16 == 0,
                   f"{what}: {name} must be a contiguous, 16-byte aligned "
                   f"{shape} {dtype} tensor on {q.device}")
    ku.require(q.is_contiguous() and q.data_ptr() % 16 == 0,
               f"{what}: q must be contiguous and 16-byte aligned")
    return b, h, sq, sk, d


def _launch(entry, q, k, v, seg_q, seg_k, scale, causal, pointers, others,
            tables=None):
    """Check the inputs, take the tables (``tables``, from :func:`_tables`
    of these segment ids and ``causal``, with the block orders for a
    tensor-core entry; built here when None), launch
    ``entry`` with the tensors of ``pointers`` (in the C order, after q,
    k, v, the segment ids and the tables), count the launch and raise on a
    CUDA error."""
    b, h, sq, sk, d = _check_varlen(entry, q, k, v, seg_q, seg_k, *others)
    mma = entry in _MMA_SIGNATURES
    qr, kr, kv_order, q_order = (tables if tables is not None
                                 else _tables(seg_q, seg_k, causal, mma))
    if mma:
        # dK/dV's blocks take K/V tiles, the forward's and dQ's q tiles
        order = kv_order if entry == "flash_varlen_mma_bwd_dkv" else q_order
        ku.require(order is not None,
                   f"{entry}: its tables need the block order "
                   f"(_tables(..., with_order=True))")
        ku.require(max(sq, sk) // _TILE < 65536,
                   f"{entry}: at most 65,535 tiles of {_TILE} a row")
        lib = ku.load_kernel("flash_varlen_mma", _MMA_SIGNATURES)
        tabs = (qr, kr, order)
    else:
        lib = ku.load_kernel("flash_varlen", _SIGNATURES)
        tabs = (qr, kr)
    status = getattr(lib, entry)(
        q.device.index, *(t.data_ptr() for t in (q, k, v, seg_q, seg_k,
                                                 *tabs, *pointers)),
        b, h, sq, sk, d, float(scale), int(causal),
        ku.dtype_code(q.dtype), ku.stream_handle(q))
    ku.count_launch(entry)
    ku.check_status(lib, status, entry)


def _bwd_others(q, do, lse, delta):
    rows = (*q.shape[:3], 1)
    return (("dO", do, tuple(q.shape), q.dtype),
            ("lse", lse, rows, torch.float32),
            ("delta", delta, rows, torch.float32))


def _entry(kernel: str, q) -> str:
    """The C entry of ``kernel`` (``"fwd"``, ``"bwd_dq"``, ``"bwd_dkv"``)
    on :func:`_varlen_route`'s route for q's type and head dim."""
    mma = _varlen_route(q.dtype, q.shape[-1]) == "tensor_core"
    return f"flash_varlen_{'mma_' if mma else ''}{kernel}"


def flash_varlen_fwd(q, k, v, seg_q, seg_k, scale: float, causal: bool,
                     tables=None):
    """Launch the varlen forward kernel of :func:`_varlen_route` on (b, h,
    s, d) CUDA tensors with int32 (b, s) segment ids, s a multiple of 64:
    returns ``(o, lse)``, lse fp32 (b, h, sq, 1). ``tables``:
    :func:`_tables` of these segment ids, or None to build them."""
    o = torch.empty_like(q)
    lse = torch.empty(*q.shape[:3], 1, dtype=torch.float32, device=q.device)
    _launch(_entry("fwd", q), q, k, v, seg_q, seg_k, scale, causal,
            (o, lse), (), tables)
    return o, lse


def flash_varlen_bwd_dq(q, k, v, seg_q, seg_k, do, lse, delta, scale: float,
                        causal: bool, tables=None):
    """Launch the varlen dQ kernel of :func:`_varlen_route`; ``lse`` and
    ``delta`` are fp32 (b, h, sq, 1)."""
    dq = torch.empty_like(q)
    _launch(_entry("bwd_dq", q), q, k, v, seg_q, seg_k, scale, causal,
            (do, lse, delta, dq), _bwd_others(q, do, lse, delta), tables)
    return dq


def flash_varlen_bwd_dkv(q, k, v, seg_q, seg_k, do, lse, delta, scale: float,
                         causal: bool, tables=None):
    """Launch the varlen dK/dV kernel of :func:`_varlen_route`; returns
    ``(dk, dv)``."""
    entry = _entry("bwd_dkv", q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(entry, q, k, v, seg_q, seg_k, scale, causal,
            (do, lse, delta, dk, dv), _bwd_others(q, do, lse, delta), tables)
    return dk, dv


class VarlenAttention(ku.OpaqueFunction):
    """Varlen flash attention over (b, h, s, d), s a multiple of 64, with
    its JAX ``custom_vjp`` (``_varlen``): the forward saves (q, k, v, o,
    lse), the backward runs the dQ and dK/dV kernels (or their plain
    versions) from them. The segment ids get no gradient. On the card the
    kernels' tables (:func:`_tables`) are built once, in the forward, and
    the three kernels share them."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, scale, causal):
        ctx.kernel = ku.use_kernel(q)
        ctx.args = (scale, causal)
        if ctx.kernel:
            ctx.tables = _tables(seg_q, seg_k, causal, _varlen_route(
                q.dtype, q.shape[-1]) == "tensor_core")
            o, lse = flash_varlen_fwd(q, k, v, seg_q, seg_k, *ctx.args,
                                      tables=ctx.tables)
        else:
            o, lse = flash_varlen_fwd_reference(q, k, v, seg_q, seg_k,
                                                *ctx.args)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if ctx.kernel:
            # delta = Σ dO·O is a torch reduction, as it is XLA outside the
            # kernels in JAX (attention_varlen.py:400)
            delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
            dq = flash_varlen_bwd_dq(q, k, v, seg_q, seg_k, do, lse, delta,
                                     *ctx.args, tables=ctx.tables)
            dk, dv = flash_varlen_bwd_dkv(q, k, v, seg_q, seg_k, do, lse,
                                          delta, *ctx.args,
                                          tables=ctx.tables)
        else:
            dq, dk, dv = flash_varlen_bwd_reference(q, k, v, seg_q, seg_k, o,
                                                    lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_varlen(q, k, v, seg_q, seg_k=None, causal: bool = False,
                           scale: Optional[float] = None):
    """Packed-varlen attention over (b, h, s, d) with (b, s) segment ids,
    the JAX ``flash_attention_varlen`` contract: pads (seg < 0) attend to
    nothing and output zero; differentiable in q, k and v. The varlen
    kernels on CUDA tensors (their plain versions on CPU tensors) for
    head_dim % 8 == 0, the dense :func:`attention_varlen_reference`
    otherwise, as JAX. A length that is
    not a multiple of the kernels' 64-row tile is padded with segment −1
    and sliced back, as JAX pads to its 128 (pad keys match nothing, pad
    rows output 0, so the result is the same). JAX's ``block_q`` /
    ``block_k`` / ``use_pallas`` / ``interpret`` are TPU knobs and are not
    taken."""
    if seg_k is None:
        seg_k = seg_q
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d % 8 != 0:
        return attention_varlen_reference(q, k, v, seg_q, seg_k,
                                          causal=causal, scale=scale)
    pq, pk = (-sq) % _TILE, (-sk) % _TILE
    q, k, v = (F.pad(t, (0, 0, 0, p)).contiguous()
               for t, p in ((q, pq), (k, pk), (v, pk)))
    seg_q, seg_k = (F.pad(s.to(torch.int32), (0, p), value=-1).contiguous()
                    for s, p in ((seg_q, pq), (seg_k, pk)))
    o = VarlenAttention.apply(q, k, v, seg_q, seg_k, float(scale),
                              bool(causal))
    return o[:, :, :sq] if pq else o
