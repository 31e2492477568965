"""Fused LM head + softmax cross-entropy: plain PyTorch versions + the CUDA
forward, dX and dW kernels (counterpart of ``apex_tpu/ops/lm_head_loss.py``
at tp = 1).

The loss of row i is ``lse_i - pred_i`` for the scores ``s = x2 · wᵀ``:
``lse`` the row's log-sum-exp over the vocab, ``pred`` the target's score.
The kernels never write the (rows, vocab) scores to device memory; the
backward recomputes them tile by tile from the saved ``(x2, w, t, lse)``.
:class:`LMHeadLoss` is the JAX ``custom_vjp``: the forward kernel (or its
plain version for CPU tensors) in ``forward``, the dX and dW kernels (or
their plain version) in ``backward``. The plain versions materialize the
fp32 scores and round ``dl`` to the input type before each product, where
the kernels do.

Two routes (:func:`_lm_head_route`): bf16 inputs run the tensor-core
forward, dX and dW of ``csrc/lm_head_mma.cu`` (counted as
``lm_head_mma_fwd`` / ``_bwd_dx`` / ``_bwd_dw``), fp32 inputs the
CUDA-core ones of ``csrc/lm_head_loss.cu`` (``lm_head_loss_fwd`` /
``_bwd_dx`` / ``_bwd_dw``, fp32 products).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.comm import collectives as coll
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.parallel.mesh import axis_info

NEG_INF = -1e30
DEFAULT_BLOCK_N = 1024
_MIN_BLOCK_N = 128

_SIGNATURES = {
    "lm_head_loss_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "lm_head_loss_fwd_splits": [ctypes.c_int, ctypes.c_int],
    "lm_head_loss_bwd_dx": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "lm_head_loss_bwd_dw": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
# the tensor-core forward (csrc/lm_head_mma.cu): x, w, t, the split
# scratch, lse, pred; n, v, h, the split count; the dtype code; the
# stream. dX and dW: x, w, t, lse, g, (dX: the split scratch,) out; n, v,
# h; the hidden layout (cluster, hk, panels) and dX's split count; the
# dtype code; the stream
_MMA_SIGNATURES = {
    "lm_head_mma_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "lm_head_mma_bwd_dx": [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "lm_head_mma_bwd_dw": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}

# the tensor-core backward's tiles (csrc/lm_head_mma.cu): 64 own rows a
# block, 64 streamed rows a tile; a CTA's hidden panel is 128, 256 or 384
# columns in a cluster (its fp32 accumulator, 64 x 384, fills the
# registers beside its part of the scores), or up to 512 alone; a cluster
# holds at most 8 CTAs; dX splits the vocab until its grid reaches one
# block on each of the H100's 132 SMs, at most 16 ways
_MMA_ROWS = 64
_MMA_PANELS = (128, 256, 384)
_MMA_SOLO_PANEL = 512
_MMA_MAX_CLUSTER = 8
_MMA_TARGET_BLOCKS = 132
_MMA_MAX_SPLITS = 16
# the tensor-core forward's tiles: 128 x rows a block, 128 vocab rows a
# tile, two blocks an SM, at most 64 vocab splits
_FWD_ROWS = 128
_FWD_VOCAB = 128
_FWD_BLOCKS = 2 * _MMA_TARGET_BLOCKS
_FWD_MAX_SPLITS = 64


def _lm_head_route(dtype, h: int) -> str:
    """Which kernels run the forward, dX and dW at this input dtype and
    hidden size on the card: ``"tensor_core"`` (bf16 and fp16:
    ``csrc/lm_head_mma.cu``) or ``"cuda_core"`` (fp32:
    ``csrc/lm_head_loss.cu``, fp32 products, as JAX's fp32 kernel forms
    them). A hidden size that is not a positive multiple of 128, or
    another dtype, raises."""
    if not (h > 0 and h % 128 == 0):
        raise ValueError(f"hidden ({h}) must be a positive multiple of 128")
    if dtype in ku.HALF_DTYPES:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"the LM-head kernels take fp32, bf16 or fp16, got "
                     f"{dtype}")


def _mma_layout(h: int):
    """``(cluster, hk, panels)``: how the tensor-core backward covers the
    hidden axis. A cluster of ``cluster`` CTAs, each over ``panels``
    panels of ``hk`` columns (the last CTA's may reach past h, as zeros).
    Up to 512 columns one CTA (no cluster: its scores need no exchange);
    else one panel a CTA where a cluster of at most 8 covers h: the
    narrowest padded width ``cluster · hk``, then the fewest CTAs; above 8
    · 384 columns, as many 384-column panels a CTA as 8 CTAs need, and as
    few CTAs as those panels need."""
    if h <= _MMA_SOLO_PANEL:
        return 1, next(p for p in (*_MMA_PANELS, _MMA_SOLO_PANEL)
                       if p >= h), 1
    best = None
    for c in range(1, _MMA_MAX_CLUSTER + 1):
        per = -(-h // c)
        hk = next((p for p in _MMA_PANELS if p >= per), None)
        if hk is not None and (best is None or c * hk < best[0] * best[1]):
            best = (c, hk, 1)
    if best is None:
        hk = _MMA_PANELS[-1]
        panels = -(-h // (_MMA_MAX_CLUSTER * hk))
        best = (-(-h // (panels * hk)), hk, panels)
    return best


def _dx_splits(n: int, v: int, h: int) -> int:
    """Vocab splits of the tensor-core dX: enough that the (row tile ×
    cluster × panel × split) grid reaches 132 blocks, at most 16 and at
    most one a 64-column vocab tile. A function of the shape alone, so
    the in-order merge of the splits repeats bitwise."""
    c, _, panels = _mma_layout(h)
    blocks = -(-n // _MMA_ROWS) * c * panels
    tiles = -(-v // _MMA_ROWS)
    return max(1, min(_MMA_TARGET_BLOCKS // blocks, _MMA_MAX_SPLITS, tiles))


def _fwd_splits(n: int, v: int, h: int) -> int:
    """Vocab splits of the tensor-core forward: as many as keep the (row
    tile × split) grid within one wave of 264 blocks (two an SM on 132
    SMs), at most 64 and at most one a 128-row vocab tile. A function of
    the shape alone (h does not change it), so the in-order merge of the
    splits' (m, l, p) repeats bitwise."""
    del h
    rows = -(-n // _FWD_ROWS)
    tiles = -(-v // _FWD_VOCAB)
    return max(1, min(_FWD_BLOCKS // rows, _FWD_MAX_SPLITS, tiles))


# ---------------------------------------------------------------------------
# the JAX package's shape gate


def _resolve_block_n(n: int, block_n: int) -> Optional[int]:
    """The JAX ``_resolve_block_n``: the largest block ≤ ``block_n`` that
    divides ``n`` (halving down to 128 rows, a multiple of 8); None when no
    block covers ``n``."""
    if n <= 0 or n % 8:
        return None
    b = min(block_n, n)
    while b >= _MIN_BLOCK_N:
        if n % b == 0 and b % 8 == 0:
            return b
        b //= 2
    return n if n < _MIN_BLOCK_N else None


def kernel_fits(n: int, h: int) -> bool:
    """JAX's ``pallas_fits`` predicate (at its default block), exactly:
    ``h % 128 == 0`` and a row block covers ``n``. The GPT loss takes the fused path on the card
    only where it holds, so one config takes the same branch in both
    packages. (The CUDA kernels themselves take any row count.)"""
    return _resolve_block_n(n, DEFAULT_BLOCK_N) is not None and h % 128 == 0


# ---------------------------------------------------------------------------
# plain versions


def _scores(x2, w):
    return torch.matmul(x2.float(), w.float().t())


def lm_head_loss_reference(x2, w, targets):
    """Per-row CE of ``x2 @ wᵀ`` against ``targets``, fp32 (the JAX
    reference at tp = 1)."""
    logits = _scores(x2, w)
    lse = torch.logsumexp(logits, dim=-1)
    pred = torch.gather(logits, 1, targets.long()[:, None])[:, 0]
    return lse - pred


def lm_head_loss_fwd_reference(x2, w, t):
    """Plain version of the forward kernel: ``(lse, pred)``, fp32 (n,),
    from dense fp32 scores; a target outside [0, V) picks 0."""
    logits = _scores(x2, w)
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    v = w.shape[0]
    t = t.long()
    in_range = (t >= 0) & (t < v)
    picked = torch.gather(logits, 1, torch.where(in_range, t, 0)[:, None])
    return lse, torch.where(in_range, picked[:, 0], 0.0)


def lm_head_loss_fwd_split_reference(x2, w, t, splits: int):
    """Plain emulation of the tensor-core forward's vocab split: split k
    walks its run of 128-row vocab tiles, updating each row's running max
    m, sum l and target score p tile by tile as JAX's kernel does, and the
    splits' (m, l, p) are merged in split order (lse = M + log Σ l·exp(m −
    M), pred = Σ p). Returns ``(lse, pred)``, fp32 (n,)."""
    v = w.shape[0]
    tiles = -(-v // _FWD_VOCAB)
    per = -(-tiles // splits)
    s = _scores(x2, w)
    n = s.shape[0]
    t = t.long()
    parts = []
    for k in range(splits):
        m = torch.full((n,), NEG_INF, device=s.device)
        l = torch.zeros(n, device=s.device)
        p = torch.zeros(n, device=s.device)
        for tile in range(k * per, min(tiles, (k + 1) * per)):
            lo, hi = tile * _FWD_VOCAB, min(v, (tile + 1) * _FWD_VOCAB)
            st = s[:, lo:hi]
            hit = (t[:, None] == torch.arange(lo, hi, device=s.device))
            p = p + torch.where(hit, st, 0.0).sum(dim=1)
            m_new = torch.maximum(m, st.amax(dim=1))
            l = l * torch.exp(m - m_new) + torch.exp(
                st - m_new[:, None]).sum(dim=1)
            m = m_new
        parts.append((m, l, p))
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = sum(l * torch.exp(m - big) for m, l, _ in parts)
    return big + torch.log(l), sum(p for _, _, p in parts)


def _dl(x2, w, t, lse, g):
    """``(exp(s − lse) − onehot)·g`` over dense fp32 scores."""
    p = torch.exp(_scores(x2, w) - lse[:, None])
    hit = torch.arange(w.shape[0], device=x2.device)[None, :] == \
        t.long()[:, None]
    return (p - hit.float()) * g.float()[:, None]


def lm_head_loss_bwd_reference(x2, w, t, lse, g):
    """Plain version of the dX and dW kernels: ``dl = (exp(s − lse) −
    onehot)·g`` over dense fp32 scores, rounded to the input type before
    each product (``lm_head_loss.py:152,179``); returns ``(dx, dw)`` in
    x2's and w's types."""
    dl = _dl(x2, w, t, lse, g)
    dx = torch.matmul(dl.to(w.dtype).float(), w.float()).to(x2.dtype)
    dw = torch.matmul(dl.to(x2.dtype).float().t(), x2.float()).to(w.dtype)
    return dx, dw


def lm_head_loss_bwd_dx_split_reference(x2, w, t, lse, g, splits: int):
    """Plain emulation of the tensor-core dX's vocab split: split k sums
    ``dl·W`` over its run of 64-column vocab tiles into an fp32 partial,
    and the partials are added in split order (the kernel's merge).
    Returns fp32 dx (n, h)."""
    v = w.shape[0]
    tiles = -(-v // _MMA_ROWS)
    per = -(-tiles // splits) * _MMA_ROWS
    dl = _dl(x2, w, t, lse, g).to(w.dtype).float()
    out = None
    for k in range(splits):
        lo, hi = min(v, k * per), min(v, (k + 1) * per)
        part = torch.matmul(dl[:, lo:hi], w[lo:hi].float())
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(what, x2, w, t, *rows):
    ku.require(x2.is_cuda and x2.dim() == 2,
               f"{what} takes a 2-d (rows, hidden) CUDA tensor, got "
               f"{x2.device} {tuple(x2.shape)}")
    n, h = x2.shape
    ku.require(x2.dtype in ku.KERNEL_DTYPES,
               f"{what} takes fp32, bf16 or fp16, got {x2.dtype}")
    ku.require(h % 128 == 0, f"{what}: hidden ({h}) must be a multiple of "
                             f"128")
    ku.require(0 < n < 2 ** 31, f"{what}: rows ({n}) out of range")
    ku.require(w.dim() == 2 and w.shape[1] == h and w.dtype == x2.dtype
               and w.device == x2.device and w.is_contiguous()
               and 0 < w.shape[0] < 2 ** 31,
               f"{what}: w must be a contiguous (vocab, {h}) {x2.dtype} "
               f"tensor on {x2.device}, got {w.dtype} {tuple(w.shape)}")
    ku.require(t.device == x2.device and t.dtype == torch.int64
               and tuple(t.shape) == (n,) and t.is_contiguous(),
               f"{what}: targets must be a contiguous ({n},) int64 tensor")
    for name, r in rows:
        ku.require(r.device == x2.device and r.dtype == torch.float32
                   and tuple(r.shape) == (n,) and r.is_contiguous(),
                   f"{what}: {name} must be a contiguous ({n},) fp32 tensor")
    ku.require(x2.is_contiguous(), f"{what}: x must be contiguous")
    ku.require(x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
               f"{what}: x and w must be 16-byte aligned")
    return n, w.shape[0], h


def lm_head_loss_fwd(x2, w, t):
    """Launch the forward kernels of :func:`_lm_head_route` (per vocab
    split, then their in-order merge): ``(lse, pred)``, fp32 (n,)."""
    n, v, h = _check("lm_head_loss_fwd", x2, w, t)
    lse = torch.empty(n, dtype=torch.float32, device=x2.device)
    pred = torch.empty_like(lse)
    ptrs = (x2.data_ptr(), w.data_ptr(), t.data_ptr())
    if _lm_head_route(x2.dtype, h) == "tensor_core":
        entry = "lm_head_mma_fwd"
        lib = ku.load_kernel("lm_head_mma", _MMA_SIGNATURES)
        splits = _fwd_splits(n, v, h)
        part = torch.empty(3 * splits * n, dtype=torch.float32,
                           device=x2.device)
        status = lib.lm_head_mma_fwd(
            x2.device.index, *ptrs, part.data_ptr(), lse.data_ptr(),
            pred.data_ptr(), n, v, h, splits, ku.dtype_code(x2.dtype),
            ku.stream_handle(x2))
    else:
        entry = "lm_head_loss_fwd"
        lib = ku.load_kernel("lm_head_loss", _SIGNATURES)
        part = torch.empty(3 * lib.lm_head_loss_fwd_splits(n, v) * n,
                           dtype=torch.float32, device=x2.device)
        status = lib.lm_head_loss_fwd(
            x2.device.index, *ptrs, part.data_ptr(), lse.data_ptr(),
            pred.data_ptr(), n, v, h, 0, ku.stream_handle(x2))  # is_bf16 0
    ku.count_launch(entry)
    ku.check_status(lib, status, entry)
    return lse, pred


def _launch_bwd(which, x2, w, t, lse, g, out):
    """Launch the dX (``which`` "dx") or dW kernel of
    :func:`_lm_head_route` into ``out``, count it under its C entry's
    name and raise on a CUDA error."""
    n, v, h = _check(f"lm_head_loss_bwd_{which}", x2, w, t, ("lse", lse),
                     ("g", g))
    ptrs = (x2.data_ptr(), w.data_ptr(), t.data_ptr(), lse.data_ptr(),
            g.data_ptr())
    if _lm_head_route(x2.dtype, h) == "cuda_core":
        entry = f"lm_head_loss_bwd_{which}"
        lib = ku.load_kernel("lm_head_loss", _SIGNATURES)
        status = getattr(lib, entry)(x2.device.index, *ptrs,
                                     out.data_ptr(), n, v, h, 0,
                                     ku.stream_handle(x2))
    else:
        entry = f"lm_head_mma_bwd_{which}"
        lib = ku.load_kernel("lm_head_mma", _MMA_SIGNATURES)
        layout = _mma_layout(h)
        if which == "dx":
            splits = _dx_splits(n, v, h)
            part = (torch.empty(splits * n * h, dtype=torch.float32,
                                device=x2.device) if splits > 1 else None)
            status = lib.lm_head_mma_bwd_dx(
                x2.device.index, *ptrs,
                None if part is None else part.data_ptr(), out.data_ptr(),
                n, v, h, *layout, splits, ku.dtype_code(x2.dtype),
                ku.stream_handle(x2))
        else:
            status = lib.lm_head_mma_bwd_dw(
                x2.device.index, *ptrs, out.data_ptr(), n, v, h, *layout,
                ku.dtype_code(x2.dtype), ku.stream_handle(x2))
    ku.count_launch(entry)
    ku.check_status(lib, status, entry)
    return out


def lm_head_loss_bwd_dx(x2, w, t, lse, g):
    """Launch the dX kernel of :func:`_lm_head_route`: dx (n, h) in x2's
    type (bf16: per vocab split an fp32 partial, added in split order)."""
    return _launch_bwd("dx", x2, w, t, lse, g, torch.empty_like(x2))


def lm_head_loss_bwd_dw(x2, w, t, lse, g):
    """Launch the dW kernel of :func:`_lm_head_route`: dw (V, h) in w's
    type. Each vocab row has one owning block that sums the rows in order:
    dw repeats bitwise."""
    return _launch_bwd("dw", x2, w, t, lse, g, torch.empty_like(w))


class LMHeadLoss(ku.OpaqueFunction):
    """Per-row loss ``lse − pred`` of ``x2 · wᵀ`` (fp32, (n,)),
    differentiable in ``x2`` and ``w``: the kernels for CUDA tensors,
    their plain versions for CPU tensors (or under ``force_plain``). Saves
    ``(x2, w, t, lse)``, as ``_lm_fwd`` does. With ``axis_name`` (the
    vocab-parallel form: ``w`` is this rank's vocab shard, ``t`` the
    targets localized to it) the shards' ``(lse, pred)`` are merged over
    the axis (JAX ``lm_head_loss.py:346-353``: ``lse`` by pmax and the log
    of the psum of ``exp(lse − max)``, ``pred`` by psum) and the backward
    runs against the merged ``lse``; its ``dx`` is this rank's partial,
    which the caller's ``copy_to_tensor_model_parallel_region`` sums."""

    @staticmethod
    def forward(ctx, x2, w, t, axis_name=None):
        ctx.kernel = ku.use_kernel(x2)
        if ctx.kernel:
            lse, pred = lm_head_loss_fwd(x2, w, t)
        else:
            lse, pred = lm_head_loss_fwd_reference(x2, w, t)
        if axis_name is not None:
            lse, pred = _merge_shards(lse, pred, axis_name)
        ctx.save_for_backward(x2, w, t, lse)
        return lse - pred

    @staticmethod
    def backward(ctx, g):
        x2, w, t, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.kernel:
            dx = lm_head_loss_bwd_dx(x2, w, t, lse, g)
            dw = lm_head_loss_bwd_dw(x2, w, t, lse, g)
        else:
            dx, dw = lm_head_loss_bwd_reference(x2, w, t, lse, g)
        return dx, dw, None, None


def _merge_shards(lse, pred, axis_name: str):
    """The vocab shards' ``(lse, pred)`` merged over ``axis_name`` (of more
    than one rank): the reference's MAX / SUM / SUM triple on (n,) rows."""
    group, world, _ = axis_info(axis_name)

    def reduce(t, op=None):
        return coll.all_reduce(t.contiguous().clone(), group, world, op=op,
                               tag="tp")

    m = reduce(lse, op=torch.distributed.ReduceOp.MAX)
    lse = m + torch.log(reduce(torch.exp(lse - m)))
    return lse.contiguous(), reduce(pred).contiguous()


def lm_head_loss(x, w, targets, axis_name: Optional[str] = None):
    """Per-position CE of the projection ``x @ wᵀ`` without materializing
    it (on the card). ``x``: (..., h) hidden states; ``w``: (vocab, h);
    ``targets``: (...) int ids. Returns the fp32 loss shaped like
    ``targets``, differentiable in ``x`` and ``w``. On CUDA the kernels
    take fp32, bf16 or fp16 with ``h % 128 == 0`` and raise on anything else.

    ``axis_name`` (JAX's vocab-parallel form, a mesh axis such as
    ``"tp"``): ``w`` is this rank's (V_local, h) shard of the vocab rows,
    ``targets`` are global ids, localized by ``rank · V_local`` (on the
    other ranks' rows they fall outside [0, V_local), where the kernels
    pick no target); the shards' results merge over the axis, and ``dx``
    is this rank's partial (summed by the enclosing
    ``copy_to_tensor_model_parallel_region``'s backward). On an axis of
    one rank (or with no mesh) the shard is the whole vocab and the form
    is the plain one, as every tp mapping is the identity there."""
    h = x.shape[-1]
    lead = targets.shape
    x2 = x.reshape(-1, h)
    t = targets.reshape(-1).long()
    if axis_name is not None:
        _, world, index = axis_info(axis_name)
        if world == 1:
            axis_name = None
        else:
            t = t - index * w.shape[0]
    if ku.use_kernel(x2):
        x2, w, t = x2.contiguous(), w.contiguous(), t.contiguous()
    return LMHeadLoss.apply(x2, w, t, axis_name).reshape(lead)
