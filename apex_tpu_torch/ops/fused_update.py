"""Fused optimizer update tail: plain PyTorch versions + the CUDA kernel
(counterpart of ``apex_tpu/ops/fused_update.py``).

:func:`fused_adam_tail` runs the whole Adam tail of one leaf — moments,
bias correction, the update direction, either decay mode — as one kernel
(``csrc/fused_update.cu``) for CUDA tensors and as its plain version
(:func:`adam_tail_reference`) for CPU tensors. :func:`fused_lamb_tail`
also returns the leaf's Σp² and Σu², which LAMB's trust ratio needs; the
kernel sums them in two stages (per-block partials, then one in-order
sum), so they repeat bitwise.

Both update ``m`` and ``v`` **in place** (the kernel writes m' and v' over
them, the plain version updates them with ``mul_``/``add_``) and return
``(u, m, v)`` (plus the two sums for LAMB), u in fp32. The caller applies
``p + (-lr·u)``, as the JAX ``FusedAdam`` leaf does. ``g`` and ``p`` may
be fp32, bf16 or fp16; ``m`` and ``v`` are fp32; the math is fp32 in JAX's
order.

Two optional 0-d/1-d fp32 tensors on the leaf's device keep a step on the
card with no host read (JAX's always capturable ``FusedAdam``):
``corr`` = (c1, c2), computed on the card from a device step count, in
place of the host's ``c1``/``c2``; ``found_inf``, a 0/1 flag: when set, m
and v are left as they were and u is 0 (the LAMB sums 0), so ``p +
(-lr·u)`` leaves p bitwise unchanged. Left out, the path is the host's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from apex_tpu_torch.ops import _kernel_util as ku

_SIGNATURES = {
    "fused_adam_tail": [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_longlong] + [ctypes.c_float] * 6 + [ctypes.c_int]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6,
    "fused_update_blocks": [ctypes.c_longlong],
}


def adam_tail_reference(g, m, v, p, c1, c2, *, betas, eps,
                        weight_decay: float = 0.0, adam_w_mode: bool = True,
                        in_place: bool = False, corr=None, found_inf=None):
    """Plain version: the elementwise Adam tail in fp32 -> ``(u, m', v')``
    (the JAX reference's exact op order). m' and v' are new tensors, or
    with ``in_place`` ``m`` and ``v`` themselves, updated by the same
    operations (``mul_`` then ``add_``) and so to the same bits. ``corr``
    (c1, c2 as a tensor) replaces ``c1``/``c2``; a set ``found_inf``
    keeps m and v and gives u = 0, as the kernel does."""
    b1, b2 = betas
    g, p = g.float(), p.float()
    if corr is not None:
        c1, c2 = corr[0], corr[1]
    if not adam_w_mode and weight_decay:
        g = g + weight_decay * p
    if found_inf is not None:
        skip = found_inf != 0
        m_new = torch.where(skip, m, b1 * m + (1.0 - b1) * g)
        v_new = torch.where(skip, v, b2 * v + (1.0 - b2) * g * g)
        u = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if adam_w_mode and weight_decay:
            u = u + weight_decay * p
        u = torch.where(skip, torch.zeros_like(u), u)
        if in_place:
            m_new, v_new = m.copy_(m_new), v.copy_(v_new)
        return u, m_new, v_new
    if in_place:
        m_new = m.mul_(b1).add_((1.0 - b1) * g)
        v_new = v.mul_(b2).add_((1.0 - b2) * g * g)
    else:
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
    u = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    if adam_w_mode and weight_decay:
        u = u + weight_decay * p
    return u, m_new, v_new


def lamb_tail_reference(g, m, v, p, c1, c2, *, betas, eps,
                        weight_decay: float = 0.0, in_place: bool = False,
                        corr=None, found_inf=None):
    """LAMB's plain tail -> ``(u, m', v', Σp², Σu²)``, the sums 0-d fp32
    (decoupled decay always, as in JAX; both 0 under a set flag)."""
    u, m_new, v_new = adam_tail_reference(
        g, m, v, p, c1, c2, betas=betas, eps=eps,
        weight_decay=weight_decay, adam_w_mode=True, in_place=in_place,
        corr=corr, found_inf=found_inf)
    p32 = p.float()
    wsq = (p32 * p32).sum()
    if found_inf is not None:
        wsq = torch.where(found_inf.reshape(()) != 0, torch.zeros_like(wsq),
                          wsq)
    return u, m_new, v_new, wsq, (u * u).sum()


def _check_flags(g, corr, found_inf):
    for name, t, n in (("corr", corr, 2), ("found_inf", found_inf, 1)):
        if t is not None:
            ku.require(t.device == g.device and t.dtype == torch.float32
                       and t.numel() == n and t.is_contiguous(),
                       f"fused_adam_tail: {name} must be {n} contiguous "
                       f"fp32 on {g.device}, got {t.dtype} "
                       f"{tuple(t.shape)} on {t.device}")


def _check(g, m, v, p):
    n = g.numel()
    ku.require(g.is_cuda, f"fused_adam_tail takes CUDA tensors, got "
                          f"{g.device}")
    for name, t, dtypes in (("g", g, ku.KERNEL_DTYPES),
                            ("p", p, ku.KERNEL_DTYPES),
                            ("m", m, (torch.float32,)),
                            ("v", v, (torch.float32,))):
        ku.require(t.device == g.device and t.dtype in dtypes
                   and t.numel() == n and t.shape == g.shape
                   and t.is_contiguous(),
                   f"fused_adam_tail: {name} must be a contiguous "
                   f"{tuple(g.shape)} tensor of {dtypes} on {g.device}, got "
                   f"{t.dtype} {tuple(t.shape)}")
    ku.require(n > 0, "fused_adam_tail: empty leaf")
    return n


def _launch(g, m, v, p, c1, c2, betas, eps, weight_decay, adam_w_mode,
            norms: bool, corr=None, found_inf=None):
    n = _check(g, m, v, p)
    _check_flags(g, corr, found_inf)
    b1, b2 = betas
    u = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    lib = ku.load_kernel("fused_update", _SIGNATURES)
    parts = sums = None
    if norms:
        blocks = lib.fused_update_blocks(n)
        parts = torch.empty(2, blocks, dtype=torch.float32, device=g.device)
        sums = torch.empty(2, dtype=torch.float32, device=g.device)
    # (1 - b) in double, then fp32: what JAX feeds its kernel for the
    # weakly typed Python constant
    status = lib.fused_adam_tail(
        g.device.index, g.data_ptr(), p.data_ptr(), m.data_ptr(),
        v.data_ptr(), u.data_ptr(), n, float(b1), float(1.0 - b1),
        float(b2), float(1.0 - b2), float(eps), float(weight_decay),
        int(adam_w_mode), float(np.float32(c1)), float(np.float32(c2)),
        ku.dtype_code(g.dtype), ku.dtype_code(p.dtype),
        parts[0].data_ptr() if norms else None,
        parts[1].data_ptr() if norms else None,
        sums.data_ptr() if norms else None,
        corr.data_ptr() if corr is not None else None,
        found_inf.data_ptr() if found_inf is not None else None,
        ku.stream_handle(g))
    ku.count_launch("fused_lamb_tail" if norms else "fused_adam_tail")
    ku.check_status(lib, status, "fused_adam_tail")
    return u, sums


def fused_adam_tail(g, m, v, p, c1, c2, *, betas, eps,
                    weight_decay: float = 0.0, adam_w_mode: bool = True,
                    corr=None, found_inf=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Adam tail of one leaf: the kernel for CUDA tensors, the plain
    version for CPU tensors. ``c1``/``c2`` are the bias corrections ``1 -
    βᵗ`` (fp32 values), or ``corr`` holds them on the device; a set
    ``found_inf`` skips the update (module docstring). Updates ``m``/``v``
    in place; returns ``(u, m, v)``, apply with ``p + (-lr·u)``."""
    if ku.use_kernel(g):
        u, _ = _launch(g, m, v, p, c1, c2, betas, eps, weight_decay,
                       adam_w_mode, norms=False, corr=corr,
                       found_inf=found_inf)
        return u, m, v
    return adam_tail_reference(
        g, m, v, p, c1, c2, betas=betas, eps=eps,
        weight_decay=weight_decay, adam_w_mode=adam_w_mode, in_place=True,
        corr=corr, found_inf=found_inf)


def fused_lamb_tail(g, m, v, p, c1, c2, *, betas, eps,
                    weight_decay: float = 0.0, corr=None,
                    found_inf=None) -> Tuple:
    """LAMB variant: ``(u, m, v, Σp², Σu²)``, m/v updated in place, the
    sums 0-d fp32 tensors (LOCAL: a data-parallel caller all-reduces them
    before the trust ratio)."""
    if ku.use_kernel(g):
        u, sums = _launch(g, m, v, p, c1, c2, betas, eps, weight_decay,
                          True, norms=True, corr=corr, found_inf=found_inf)
        return u, m, v, sums[0], sums[1]
    return lamb_tail_reference(g, m, v, p, c1, c2, betas=betas, eps=eps,
                               weight_decay=weight_decay, in_place=True,
                               corr=corr, found_inf=found_inf)


def resolve_fused(mode: str, what: str = "fused_update") -> bool:
    """``"auto" | "on" | "off"`` -> whether to run the fused tail. "auto"
    and "on" both take it: :func:`fused_adam_tail` launches the kernel on
    CUDA tensors and runs its plain version on CPU tensors, as JAX runs
    interpret mode off the TPU. "off" keeps the optimizer's op chain."""
    if mode == "off":
        return False
    if mode in ("auto", "on"):
        return True
    raise ValueError(
        f"{what} must be 'auto', 'on' or 'off', got {mode!r}")
