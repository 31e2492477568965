"""Fused LM head + softmax cross-entropy: plain PyTorch versions + the CUDA
forward, dX and dW kernels (counterpart of ``apex_tpu/ops/lm_head_loss.py``
at tp = 1).

The loss of row i is ``lse_i - pred_i`` for the scores ``s = x2 · wᵀ``:
``lse`` the row's log-sum-exp over the vocab, ``pred`` the target's score.
The kernels (``csrc/lm_head_loss.cu``) never write the (rows, vocab)
scores to device memory; the backward recomputes them tile by tile from
the saved ``(x2, w, t, lse)``. :class:`LMHeadLoss` is the JAX
``custom_vjp``: the forward kernel (or its plain version for CPU tensors)
in ``forward``, the dX and dW kernels (or their plain version) in
``backward``. The plain versions materialize the fp32 scores and round
``dl`` to the input type before each product, where the kernels do.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.ops import _kernel_util as ku

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
_DTYPES = (torch.float32, torch.bfloat16)


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


def lm_head_loss_bwd_reference(x2, w, t, lse, g):
    """Plain version of the dX and dW kernels: ``dl = (exp(s − lse) −
    onehot)·g`` over dense fp32 scores, rounded to the input type before
    each product (``lm_head_loss.py:152,179``); returns ``(dx, dw)`` in
    x2's and w's types."""
    p = torch.exp(_scores(x2, w) - lse[:, None])
    hit = torch.arange(w.shape[0], device=x2.device)[None, :] == \
        t.long()[:, None]
    dl = (p - hit.float()) * g.float()[:, None]
    dx = torch.matmul(dl.to(w.dtype).float(), w.float()).to(x2.dtype)
    dw = torch.matmul(dl.to(x2.dtype).float().t(), x2.float()).to(w.dtype)
    return dx, dw


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(what, x2, w, t, *rows):
    ku.require(x2.is_cuda and x2.dim() == 2,
               f"{what} takes a 2-d (rows, hidden) CUDA tensor, got "
               f"{x2.device} {tuple(x2.shape)}")
    n, h = x2.shape
    ku.require(x2.dtype in _DTYPES, f"{what} takes fp32 or bf16, got "
                                    f"{x2.dtype}")
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
    """Launch the forward kernels (per vocab split, then their in-order
    merge): ``(lse, pred)``, fp32 (n,)."""
    n, v, h = _check("lm_head_loss_fwd", x2, w, t)
    lse = torch.empty(n, dtype=torch.float32, device=x2.device)
    pred = torch.empty_like(lse)
    lib = ku.load_kernel("lm_head_loss", _SIGNATURES)
    part = torch.empty(3 * lib.lm_head_loss_fwd_splits(n, v) * n,
                       dtype=torch.float32, device=x2.device)
    status = lib.lm_head_loss_fwd(
        x2.device.index, x2.data_ptr(), w.data_ptr(), t.data_ptr(),
        part.data_ptr(), lse.data_ptr(), pred.data_ptr(), n, v, h,
        int(x2.dtype == torch.bfloat16), ku.stream_handle(x2))
    ku.count_launch("lm_head_loss_fwd")
    ku.check_status(lib, status, "lm_head_loss_fwd")
    return lse, pred


def lm_head_loss_bwd_dx(x2, w, t, lse, g):
    """Launch the dX kernel: dx (n, h) in x2's type."""
    n, v, h = _check("lm_head_loss_bwd_dx", x2, w, t, ("lse", lse),
                     ("g", g))
    dx = torch.empty_like(x2)
    lib = ku.load_kernel("lm_head_loss", _SIGNATURES)
    status = lib.lm_head_loss_bwd_dx(
        x2.device.index, x2.data_ptr(), w.data_ptr(), t.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dx.data_ptr(), n, v, h,
        int(x2.dtype == torch.bfloat16), ku.stream_handle(x2))
    ku.count_launch("lm_head_loss_bwd_dx")
    ku.check_status(lib, status, "lm_head_loss_bwd_dx")
    return dx


def lm_head_loss_bwd_dw(x2, w, t, lse, g):
    """Launch the dW kernel: dw (V, h) in w's type. Each vocab row has one
    owning block that sums the rows in order: dw repeats bitwise."""
    n, v, h = _check("lm_head_loss_bwd_dw", x2, w, t, ("lse", lse),
                     ("g", g))
    dw = torch.empty_like(w)
    lib = ku.load_kernel("lm_head_loss", _SIGNATURES)
    status = lib.lm_head_loss_bwd_dw(
        x2.device.index, x2.data_ptr(), w.data_ptr(), t.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dw.data_ptr(), n, v, h,
        int(x2.dtype == torch.bfloat16), ku.stream_handle(x2))
    ku.count_launch("lm_head_loss_bwd_dw")
    ku.check_status(lib, status, "lm_head_loss_bwd_dw")
    return dw


class LMHeadLoss(torch.autograd.Function):
    """Per-row loss ``lse − pred`` of ``x2 · wᵀ`` (fp32, (n,)),
    differentiable in ``x2`` and ``w``: the kernels for CUDA tensors,
    their plain versions for CPU tensors (or under ``force_plain``). Saves
    ``(x2, w, t, lse)``, as ``_lm_fwd`` does."""

    @staticmethod
    def forward(ctx, x2, w, t):
        ctx.kernel = ku.use_kernel(x2)
        if ctx.kernel:
            lse, pred = lm_head_loss_fwd(x2, w, t)
        else:
            lse, pred = lm_head_loss_fwd_reference(x2, w, t)
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
        return dx, dw, None


def lm_head_loss(x, w, targets, axis_name: Optional[str] = None):
    """Per-position CE of the projection ``x @ wᵀ`` without materializing
    it (on the card). ``x``: (..., h) hidden states; ``w``: (vocab, h);
    ``targets``: (...) int ids. Returns the fp32 loss shaped like
    ``targets``, differentiable in ``x`` and ``w``. On CUDA the kernels
    take fp32 or bf16 with ``h % 128 == 0`` and raise on anything else.
    ``axis_name`` (the vocab-sharded tensor-parallel form) is
    multi-device and not ported (ROADMAP A7)."""
    if axis_name is not None:
        raise NotImplementedError(
            f"lm_head_loss(axis_name={axis_name!r}): the vocab-parallel "
            f"loss is multi-device and not ported yet (ROADMAP A7)")
    h = x.shape[-1]
    lead = targets.shape
    x2 = x.reshape(-1, h)
    t = targets.reshape(-1).long()
    if ku.use_kernel(x2):
        x2, w, t = x2.contiguous(), w.contiguous(), t.contiguous()
    return LMHeadLoss.apply(x2, w, t).reshape(lead)
