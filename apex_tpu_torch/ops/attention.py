"""Attention: plain PyTorch versions + the CUDA flash-attention kernels
(counterpart of ``apex_tpu/ops/attention.py``).

Layout at the public functions is JAX's, (batch, heads, seq, head_dim);
the kernels take the flattened (batch·heads, seq, head_dim) form. The
forward kernel (:func:`flash_attention_fwd`) returns ``o`` and the row
log-sum-exp ``lse`` (fp32, (bh, sq, 1)); the backward is two kernels,
:func:`flash_attention_bwd_dq` and :func:`flash_attention_bwd_dkv`,
recomputing the scores from ``lse`` and ``delta = Σ dO·O``.
:class:`FlashAttention` ties them into autograd; each dispatches by device
(the kernel for a CUDA tensor, its plain version for a CPU tensor).

An additive logit bias (T5's relative position bias) rides the same
kernels: fp32 (heads, sq, sk), shared by the batch (row ``bh`` of the
flattened form takes head ``bh % heads``), added to the scaled scores
before the causal mask. Its gradient, Σ over the batch of p·(dp − Δ), is
a fourth kernel, :func:`flash_attention_bwd_dbias`.

Dropout is the JAX kernels' counter hash (:func:`attention_dropout_mask`),
bitwise the same keep mask, so the forward, its remat replay and both
backward kernels drop the same entries.

Two routes (:func:`_flash_route`): bf16 inputs at head_dim <= 256 run all
four kernels on the tensor cores (``csrc/flash_mma.cu``); fp32 inputs and
every head_dim above 256 run them on the CUDA cores in fp32
(``csrc/flash_attention.cu``; above 2048 with the head dim in chunks of
2048 columns). Each kernel counts its launches under its own C entry's
name.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch._hash import M32, fmix32, mul32
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.transformer.tensor_parallel.random import saved_output

# Finite stand-in for -inf: keeps exp() exact zero without nan from
# (-inf) - (-inf).
NEG_INF = -1e30

# the tensor-core kernels' largest head dim (bf16 and fp16): six (64, 256)
# half tiles of dQ or dK/dV take 203-204 KB of shared memory
_MMA_MAX_HEAD_DIM = 256
# rows of a kernel tile; the kernels read the bias (and write d(bias)) in
# whole tiles
_TILE = 64
# blocks the tensor-core d(bias) aims to launch: two for each of the H100's
# 132 SMs
_DBIAS_TARGET_BLOCKS = 264
# heads, bh, sq, sk, d, scale, causal, dropout, seed, thresh, inv_keep,
# dtype code, stream
_FLASH_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p]
_SIGNATURES = {
    "flash_attention_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + _FLASH_ARGS,
    "flash_attention_bwd_dq": [ctypes.c_int] + [ctypes.c_void_p] * 8
    + _FLASH_ARGS,
    "flash_attention_bwd_dkv": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + _FLASH_ARGS,
    "flash_attention_bwd_dbias": [ctypes.c_int] + [ctypes.c_void_p] * 8
    + _FLASH_ARGS,
}
# the tensor-core kernels (csrc/flash_mma.cu), the same arguments; d(bias)
# also takes the scratch of its batch chunks' partials (a pointer after
# db) and their count (an int before the stream)
_MMA_SIGNATURES = {
    "flash_mma_fwd": _SIGNATURES["flash_attention_fwd"],
    "flash_mma_bwd_dq": _SIGNATURES["flash_attention_bwd_dq"],
    "flash_mma_bwd_dkv": _SIGNATURES["flash_attention_bwd_dkv"],
    "flash_mma_bwd_dbias": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + _FLASH_ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p],
}


def _flash_route(dtype, d: int) -> str:
    """Which kernels run flash attention at this input dtype and head dim
    on the card: ``"tensor_core"`` (bf16 or fp16, d <= 256:
    ``flash_mma.cu``) or ``"cuda_core"`` (fp32 at every d, bf16 and fp16
    above 256: ``flash_attention.cu``, fp32 products, as JAX's fp32
    reference forms them). A head dim that is not a positive multiple of 8 raises, as
    JAX's gate refuses it."""
    if not (d % 8 == 0 and d > 0):
        raise ValueError(f"head_dim {d} must be a positive multiple of 8")
    if dtype in ku.HALF_DTYPES and d <= _MMA_MAX_HEAD_DIM:
        return "tensor_core"
    return "cuda_core"


def _dbias_chunks(heads: int, sq: int, sk: int, nb: int) -> int:
    """Ordered chunks of the batch that the tensor-core d(bias) sums
    apart (one block per (output tile, head, chunk), each chunk's partial
    added in chunk order by a second launch): enough that the grid
    reaches _DBIAS_TARGET_BLOCKS, at most one a batch item. A function of
    the shape alone, so the sum repeats bitwise."""
    tiles = heads * -(-sq // _TILE) * -(-sk // _TILE)
    return max(1, min(nb, -(-_DBIAS_TARGET_BLOCKS // tiles)))


# ---------------------------------------------------------------------------
# dispatch: JAX's gate (``apex_tpu/ops/attention.py`` ``_pick_block``,
# ``_pallas_ok``), under its names


def _pick_block(seq: int, want: int) -> Optional[int]:
    for cand in (want, 512, 256, 128, 64, 32, 16, 8):
        if cand <= want and seq % cand == 0:
            return cand
    return None


def _pallas_ok(sq: int, sk: int, d: int, causal: bool) -> bool:
    """Whether JAX runs its flash kernel at this shape (``_pallas_ok`` with
    ``allow_interpret=True``): both lengths have a block down to 8, head_dim
    % 8 == 0, sq == sk when causal. Where it holds, a CUDA tensor takes
    the flash kernels; where it fails, every device takes
    :func:`attention_reference`, as JAX does."""
    if _pick_block(sq, 128) is None or _pick_block(sk, 128) is None:
        return False
    if d % 8 != 0:
        return False
    return not (causal and sq != sk)


# ---------------------------------------------------------------------------
# dropout keep mask (the JAX kernels' counter hash, in int64 arithmetic)


def _hash_keep(qpos, kpos, seed, bh, rate: float):
    """``apex_tpu.ops.attention._hash_keep``: murmur3's finalizer over a
    mix of (q position, k position, seed, batch·head), all uint32 values
    held in int64 tensors; keep where the hash >= rate·2**32."""
    x = fmix32((mul32(qpos, 0x9E3779B1) + mul32(kpos, 0x85EBCA77)
                + mul32(seed, 0xC2B2AE3D) + mul32(bh, 0x27D4EB2F)) & M32)
    return x >= _keep_threshold(rate)


def _keep_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def attention_dropout_mask(seed, rate: float, bh: int, sq: int, sk: int,
                           q_off: int = 0, k_off: int = 0, device=None):
    """(bh, sq, sk) boolean keep mask, bitwise JAX's
    ``attention_dropout_mask``: keyed by (seed, batch·head, global q
    position ``q_off + i``, global k position ``k_off + j``)."""
    dev = torch.device("cpu") if device is None else device
    u32 = lambda v: torch.tensor(int(v) & M32, dtype=torch.int64,
                                 device=dev)
    qpos = (u32(q_off) + torch.arange(sq, device=dev)) & M32
    kpos = (u32(k_off) + torch.arange(sk, device=dev)) & M32
    bhi = torch.arange(bh, device=dev)
    return _hash_keep(qpos[None, :, None], kpos[None, None, :], u32(seed),
                      bhi[:, None, None], rate)


# ---------------------------------------------------------------------------
# plain versions


def attention_reference(q, k, v, mask=None, scale: Optional[float] = None,
                        causal: bool = False, dropout_rate: float = 0.0,
                        dropout_keep=None, bias=None):
    """Plain softmax(Q Kᵀ · scale + bias) V with fp32 accumulation (the JAX
    ``attention_reference``; dropout only from an explicit
    ``dropout_keep`` mask, the counter-hash stream).

    ``mask``: boolean broadcastable over (..., sq, sk), True = masked OUT.
    ``bias``: additive logit bias broadcastable over (..., sq, sk), e.g.
    T5's (heads, sq, sk). Returns q.dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = torch.einsum("...qd,...kd->...qk", q32, k32) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = torch.where(_causal_masked(s), NEG_INF, s)
    if mask is not None:
        s = torch.where(mask, NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        if dropout_keep is None:
            raise ValueError("dropout_rate > 0 needs dropout_keep (the "
                             "counter-hash mask)")
        p = torch.where(dropout_keep, p / (1.0 - dropout_rate), 0.0)
    o = torch.einsum("...qk,...kd->...qd", p, v32)
    return o.to(q.dtype)


def _causal_masked(s):
    """True above the causal diagonal of the trailing (sq, sk) dims."""
    sq, sk = s.shape[-2], s.shape[-1]
    qpos = torch.arange(sq, device=s.device)[:, None]
    kpos = torch.arange(sk, device=s.device)[None, :]
    return kpos > qpos + (sk - sq)


def _scores(q3, k3, scale, causal, bias=None):
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if bias is not None:
        s = _per_head(s, bias) + bias.float()
        s = s.reshape(q3.shape[0], *s.shape[2:])
    if causal:
        s = torch.where(_causal_masked(s), NEG_INF, s)
    return s


def _per_head(t3, bias):
    """(bh, ...) -> (b, heads, ...) view, bh = b·heads b-major (the
    flattening of ``flash_attention``), so a (heads, ...) bias lines up."""
    return t3.view(-1, bias.shape[0], *t3.shape[1:])


def _keep(rate, seed, bh, sq, sk, device):
    if rate <= 0.0:
        return None
    return attention_dropout_mask(seed, rate, bh, sq, sk, device=device)


def flash_attention_fwd_reference(q3, k3, v3, scale: float, causal: bool,
                                  dropout_rate: float = 0.0, seed: int = 0,
                                  bias=None):
    """Plain version of the forward kernel over (bh, s, d): ``(o, lse)``,
    o in q's type, lse fp32 (bh, sq, 1). Like the kernel, ``l`` sums the
    UNdropped probabilities, dropout scales the kept ones, and p is
    rounded to v's type before p @ v. ``bias``: None or (heads, sq, sk),
    added in fp32 after the scaling."""
    bh, sq, _ = q3.shape
    s = _scores(q3, k3, scale, causal, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep(dropout_rate, seed, bh, sq, k3.shape[1], q3.device)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v3.dtype).float(), v3.float())
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    o = (acc / safe_l).to(q3.dtype)
    lse = torch.where(empty, NEG_INF, m + torch.log(safe_l))
    return o, lse


def _p_dp_delta(q3, k3, v3, o3, lse, do3, scale, causal, dropout_rate,
                seed, bias):
    """The backward's recomputation: p = exp(s − lse), dp = dO·vᵀ (dropped
    and rescaled), Δ = Σ dO·O, and the dropped p that multiplies dO."""
    bh, sq, _ = q3.shape
    delta = (do3.float() * o3.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(q3, k3, scale, causal, bias) - lse)
    dp = torch.einsum("bqd,bkd->bqk", do3.float(), v3.float())
    keep = _keep(dropout_rate, seed, bh, sq, k3.shape[1], q3.device)
    p_v = p
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_rate)
        p_v = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    return p, dp, delta, p_v


def flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3, scale: float,
                                  causal: bool, dropout_rate: float = 0.0,
                                  seed: int = 0, bias=None):
    """Plain version of the dQ and dK/dV kernels: ``(dq, dk, dv)`` in the
    inputs' types, recomputed from ``lse`` the way the kernels do: p =
    exp(s − lse), dp = dO·vᵀ (dropped and rescaled), ds = p·(dp − Δ)·scale
    with Δ = Σ dO·O; ds and the dropped p are rounded to the input type
    before each product, fp32 accumulation."""
    p, dp, delta, p_v = _p_dp_delta(q3, k3, v3, o3, lse, do3, scale, causal,
                                    dropout_rate, seed, bias)
    ds = (p * (dp - delta) * scale).to(q3.dtype).float()
    dv = torch.einsum("bqk,bqd->bkd", p_v.to(do3.dtype).float(), do3.float())
    dq = torch.einsum("bqk,bkd->bqd", ds, k3.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q3.float())
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_dbias_reference(q3, k3, v3, o3, lse, do3,
                                        scale: float, causal: bool,
                                        dropout_rate: float = 0.0,
                                        seed: int = 0, *, bias):
    """Plain version of the d(bias) kernel: dL/dbias, fp32 (heads, sq, sk),
    Σ over the batch of p·(dp − Δ) — no ``scale`` factor, the bias enters
    after the scaling. Where the causal mask holds p is 0, so those
    entries are 0."""
    p, dp, delta, _ = _p_dp_delta(q3, k3, v3, o3, lse, do3, scale, causal,
                                  dropout_rate, seed, bias)
    return _per_head(p * (dp - delta), bias).sum(dim=0)


def flash_attention_bwd_dbias_chunked_reference(q3, k3, v3, o3, lse, do3,
                                                scale: float, causal: bool,
                                                dropout_rate: float = 0.0,
                                                seed: int = 0, *, bias,
                                                chunks: int):
    """Plain version of the tensor-core d(bias)'s batch split: chunk c sums
    the batch items [c·nb // chunks, (c + 1)·nb // chunks) in order into
    an fp32 partial, and the partials are added in chunk order, as the
    kernel's second launch adds them."""
    p, dp, delta, _ = _p_dp_delta(q3, k3, v3, o3, lse, do3, scale, causal,
                                  dropout_rate, seed, bias)
    per = _per_head(p * (dp - delta), bias)
    nb = per.shape[0]
    out = None
    for c in range(chunks):
        b0, b1 = c * nb // chunks, (c + 1) * nb // chunks
        part = per[b0]
        for b in range(b0 + 1, b1):
            part = part + per[b]
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_flash(what, q3, k3, v3, causal, bias, *others):
    """Checks the kernels' inputs; returns ``(heads, bh, sq, sk, d)``
    (heads 1 without a bias)."""
    ku.require(q3.is_cuda and q3.dim() == 3,
               f"{what} takes 3-d (bh, s, d) CUDA tensors, got {q3.device} "
               f"{tuple(q3.shape)}")
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    ku.require(q3.dtype in ku.KERNEL_DTYPES,
               f"{what} takes fp32, bf16 or fp16, got {q3.dtype}")
    ku.require(d % 8 == 0 and d > 0,
               f"{what}: head_dim {d} must be a positive multiple of 8")
    ku.require(sq % 8 == 0 and sk % 8 == 0,
               f"{what}: sequence lengths ({sq}, {sk}) must be multiples of 8")
    ku.require(not causal or sq == sk,
               f"{what}: causal needs sq == sk, got {sq} and {sk}")
    ku.require(bh < 65536, f"{what}: batch*heads ({bh}) must be < 65536")
    heads = 1
    if bias is not None:
        heads = bias.shape[0] if bias.dim() == 3 else 0
        ku.require(heads > 0 and bh % heads == 0,
                   f"{what}: bias must be (heads, sq, sk) with heads "
                   f"dividing batch*heads ({bh}), got {tuple(bias.shape)}")
        others = (("bias", bias, (heads, sq, sk)), *others)
    for name, t, shape in (("k", k3, (bh, sk, d)), ("v", v3, (bh, sk, d)),
                           *others):
        want_dtype = (torch.float32 if name in ("lse", "delta", "bias")
                      else q3.dtype)
        ku.require(t.device == q3.device and t.dtype == want_dtype
                   and tuple(t.shape) == shape and t.is_contiguous()
                   and t.data_ptr() % 16 == 0,
                   f"{what}: {name} must be a contiguous, 16-byte aligned "
                   f"{shape} {want_dtype} tensor on {q3.device}")
    ku.require(q3.is_contiguous() and q3.data_ptr() % 16 == 0,
               f"{what}: q must be contiguous and 16-byte aligned")
    return heads, bh, sq, sk, d


def _ptr(t):
    return None if t is None else t.data_ptr()


def _whole_tiles(t, rows: int, cols: int, value: float = 0.0):
    """(heads, rows, cols) ``t`` padded with ``value`` to whole 64-row
    tiles, the layout the kernels read the bias (padded with NEG_INF, which
    masks the scores past the end) and write d(bias) in; no copy when
    aligned."""
    pr, pc = (-rows) % _TILE, (-cols) % _TILE
    return F.pad(t, (0, pc, 0, pr), value=value) if pr or pc else t


def _dropout_args(rate: float, seed: int):
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed) & M32, _keep_threshold(rate), 1.0 / (1.0 - rate)


def _launch(entry, q3, k3, v3, bias, scale, causal, dropout_rate, seed,
            pointers, shapes, extra=()):
    """Check the inputs, launch ``entry`` (of ``flash_mma.cu`` or
    ``flash_attention.cu``) with the tensors of ``pointers`` (in the C
    order) and the ints of ``extra`` (after the dtype code), count the
    launch (a launch of the fwd, dQ or dK/dV kernel with a bias also under
    ``entry + "[bias]"``) and raise on a CUDA error."""
    heads, bh, sq, sk, d = _check_flash(entry, q3, k3, v3, causal, bias,
                                        *shapes)
    if bias is not None:
        tiled = _whole_tiles(bias, sq, sk, NEG_INF)
        pointers = tuple(tiled if t is bias else t for t in pointers)
    lib = (ku.load_kernel("flash_mma", _MMA_SIGNATURES)
           if entry in _MMA_SIGNATURES
           else ku.load_kernel("flash_attention", _SIGNATURES))
    status = getattr(lib, entry)(
        q3.device.index, *(_ptr(t) for t in pointers), heads, bh, sq, sk, d,
        float(scale), int(causal), *_dropout_args(dropout_rate, seed),
        ku.dtype_code(q3.dtype), *extra, ku.stream_handle(q3))
    ku.count_launch(entry)
    if bias is not None and not entry.endswith("_dbias"):
        ku.count_launch(entry + "[bias]")
    ku.check_status(lib, status, entry)


def _bwd_shapes(q3, do3, lse, delta):
    rows = (q3.shape[0], q3.shape[1], 1)
    return (("dO", do3, tuple(q3.shape)), ("lse", lse, rows),
            ("delta", delta, rows))


def flash_attention_fwd(q3, k3, v3, scale: float, causal: bool,
                        dropout_rate: float = 0.0, seed: int = 0,
                        bias=None):
    """Launch the flash forward kernel of :func:`_flash_route` on (bh, s, d)
    CUDA tensors: returns ``(o, lse)``, lse fp32 (bh, sq, 1). ``bias``:
    None or a contiguous fp32 (heads, sq, sk) CUDA tensor."""
    entry = ("flash_mma_fwd"
             if _flash_route(q3.dtype, q3.shape[-1]) == "tensor_core"
             else "flash_attention_fwd")
    o = torch.empty_like(q3)
    lse = torch.empty(q3.shape[0], q3.shape[1], 1, dtype=torch.float32,
                      device=q3.device)
    _launch(entry, q3, k3, v3, bias, scale, causal,
            dropout_rate, seed, (q3, k3, v3, bias, o, lse), ())
    return o, lse


def flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, scale: float,
                           causal: bool, dropout_rate: float = 0.0,
                           seed: int = 0, bias=None):
    """Launch the dQ kernel of :func:`_flash_route`; ``lse`` and ``delta``
    are fp32 (bh, sq, 1)."""
    entry = ("flash_mma_bwd_dq"
             if _flash_route(q3.dtype, q3.shape[-1]) == "tensor_core"
             else "flash_attention_bwd_dq")
    dq = torch.empty_like(q3)
    _launch(entry, q3, k3, v3, bias, scale, causal,
            dropout_rate, seed, (q3, k3, v3, do3, lse, delta, bias, dq),
            _bwd_shapes(q3, do3, lse, delta))
    return dq


def flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, scale: float,
                            causal: bool, dropout_rate: float = 0.0,
                            seed: int = 0, bias=None):
    """Launch the dK/dV kernel of :func:`_flash_route`; returns ``(dk,
    dv)``."""
    entry = ("flash_mma_bwd_dkv"
             if _flash_route(q3.dtype, q3.shape[-1]) == "tensor_core"
             else "flash_attention_bwd_dkv")
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _launch(entry, q3, k3, v3, bias, scale, causal,
            dropout_rate, seed, (q3, k3, v3, do3, lse, delta, bias, dk, dv),
            _bwd_shapes(q3, do3, lse, delta))
    return dk, dv


def flash_attention_bwd_dbias(q3, k3, v3, do3, lse, delta, scale: float,
                              causal: bool, dropout_rate: float = 0.0,
                              seed: int = 0, *, bias):
    """Launch the d(bias) kernel of :func:`_flash_route`: dL/dbias, fp32
    (heads, sq, sk), summed over the batch in order by one block per
    output tile (on the tensor cores per chunk of the batch,
    :func:`_dbias_chunks`, the chunks' partials added in chunk order): the
    same bits on every run."""
    ku.require(bias is not None, "flash_attention_bwd_dbias needs the bias")
    sq, sk = q3.shape[1], k3.shape[1]
    db = _whole_tiles(torch.empty(bias.shape, dtype=torch.float32,
                                  device=q3.device), sq, sk)
    pointers = (q3, k3, v3, do3, lse, delta, bias, db)
    shapes = _bwd_shapes(q3, do3, lse, delta)
    if _flash_route(q3.dtype, q3.shape[-1]) == "tensor_core":
        heads = bias.shape[0] if bias.dim() == 3 else 1
        chunks = _dbias_chunks(heads, sq, sk, max(1, q3.shape[0] // heads))
        part = (torch.empty((chunks, *db.shape), dtype=torch.float32,
                            device=q3.device) if chunks > 1 else None)
        _launch("flash_mma_bwd_dbias", q3, k3, v3, bias, scale, causal,
                dropout_rate, seed, (*pointers, part), shapes,
                extra=(chunks,))
    else:
        _launch("flash_attention_bwd_dbias", q3, k3, v3, bias, scale, causal,
                dropout_rate, seed, pointers, shapes)
    return db if db.shape[1:] == (sq, sk) else db[:, :sq, :sk].contiguous()


class FlashAttention(ku.OpaqueFunction):
    """Flash attention over (bh, s, d) with its JAX ``custom_vjp``
    (``_flash3``, and ``_flash3_bias`` when a bias is given): the forward
    saves (q, k, v, o, lse), the backward runs the dQ and dK/dV kernels
    and, with a bias, the d(bias) kernel (or their plain versions) from
    them. The bias is used in fp32; its gradient comes back in the bias's
    dtype, as ``_flash3_bias_bwd`` casts it. The forward's (o, lse) are
    marked ``"attn"`` (JAX's ``attn_out`` / ``attn_lse`` names): a
    checkpointed region that saves them (GPT's ``dots_attn``) hands them
    back in its recompute instead of launching the forward again."""

    @staticmethod
    def forward(ctx, q3, k3, v3, bias, scale, causal, dropout_rate, seed):
        ctx.kernel = ku.use_kernel(q3)
        ctx.args = (scale, causal, dropout_rate, seed)
        ctx.bias_dtype = None if bias is None else bias.dtype
        bias32 = None if bias is None else bias.float().contiguous()
        fwd = (flash_attention_fwd if ctx.kernel
               else flash_attention_fwd_reference)
        o, lse = saved_output("attn", lambda: fwd(q3, k3, v3, *ctx.args,
                                                  bias=bias32))
        ctx.save_for_backward(q3, k3, v3, o, lse, bias32)
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, lse, bias32 = ctx.saved_tensors
        do3 = do3.contiguous()
        db = None
        if ctx.kernel:
            # delta = Σ dO·O stays a torch reduction, as it is XLA outside
            # the kernels in JAX (attention.py:506)
            delta = (do3.float() * o.float()).sum(dim=-1, keepdim=True)
            dq = flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta,
                                        *ctx.args, bias=bias32)
            dk, dv = flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta,
                                             *ctx.args, bias=bias32)
            if bias32 is not None and ctx.needs_input_grad[3]:
                db = flash_attention_bwd_dbias(q3, k3, v3, do3, lse, delta,
                                               *ctx.args, bias=bias32)
        else:
            dq, dk, dv = flash_attention_bwd_reference(
                q3, k3, v3, o, lse, do3, *ctx.args, bias=bias32)
            if bias32 is not None and ctx.needs_input_grad[3]:
                db = flash_attention_bwd_dbias_reference(
                    q3, k3, v3, o, lse, do3, *ctx.args, bias=bias32)
        if db is not None:
            db = db.to(ctx.bias_dtype)
        return dq, dk, dv, db, None, None, None, None


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed=None, bias=None):
    """Memory-efficient attention over (batch, heads, seq, head_dim), the
    JAX ``flash_attention`` contract: the flash kernels on CUDA tensors
    (their plain versions on CPU tensors), differentiable.

    ``mask`` (True = masked out), and every shape JAX's gate
    (:func:`_pallas_ok`) refuses — a length that is not a multiple of 8,
    head_dim % 8 != 0, causal with sq != sk — take the plain
    :func:`attention_reference` path on every device, exactly as JAX sends
    them to its reference (``attention.py:795-821``); with dropout that
    path applies the same counter-hash mask. ``dropout_rate`` > 0 needs
    ``dropout_seed`` (an int). ``bias``: a batch-shared additive logit
    bias of shape (heads, sq, sk) (T5's relative position bias), added
    after the scaling and differentiable; any other shape raises
    ``ValueError``, as in JAX. On CUDA the kernels take fp32/bf16 and
    every head_dim JAX's gate takes; bf16 at head_dim <= 256 runs them on
    the tensor cores (:func:`_flash_route`). The bias is used in fp32
    whatever its dtype.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")
    if bias is not None and tuple(bias.shape) != (h, sq, sk):
        raise ValueError(
            f"bias must be batch-shared (heads, sq, sk) = {(h, sq, sk)}, "
            f"got {tuple(bias.shape)}")
    seed = 0 if dropout_seed is None else int(dropout_seed)
    if mask is not None or not _pallas_ok(sq, sk, d, causal):
        keep = None
        if dropout_rate > 0.0:
            keep = attention_dropout_mask(seed, float(dropout_rate), b * h,
                                          sq, sk, device=q.device)
            keep = keep.reshape(b, h, sq, sk)
        return attention_reference(q, k, v, mask=mask, scale=scale,
                                   causal=causal, dropout_rate=dropout_rate,
                                   dropout_keep=keep, bias=bias)
    o3 = FlashAttention.apply(
        q.reshape(b * h, sq, d), k.reshape(b * h, sk, d),
        v.reshape(b * h, sk, d), bias, float(scale), bool(causal),
        float(dropout_rate), seed)
    return o3.reshape(b, h, sq, d)
