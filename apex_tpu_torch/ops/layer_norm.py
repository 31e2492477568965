"""LayerNorm: plain PyTorch versions + the CUDA forward and backward kernels
(counterpart of ``apex_tpu/ops/layer_norm.py``).

``layer_norm`` dispatches by the tensor's device: the plain versions for a
CPU tensor, the ``csrc/layer_norm.cu`` kernels (:func:`layer_norm_fwd`,
:func:`layer_norm_bwd`) for a CUDA tensor; the non-affine form takes the
plain version everywhere, as in JAX. A CUDA input the kernels do not take
raises. The affine form is differentiable through
:class:`LayerNormAffine` (the JAX ``custom_vjp``, ``layer_norm.py:180-249``):
its forward saves ``(x2d, w, mean, rstd)`` and its backward is the
backward kernel (or its plain version). RMSNorm is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch.ops import _kernel_util as ku

_SIGNATURES = {
    "layer_norm_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p],
    "layer_norm_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
_DTYPES = (torch.float32, torch.bfloat16)
# blocks of the backward's first stage (each owns ceil(rows / parts) rows);
# a function of the row count alone, so dw/db repeat bitwise
_BWD_PARTS = 256


def layer_norm_fwd_reference(x2d, weight=None, bias=None, eps: float = 1e-5):
    """Plain version of the forward kernel with its statistics: fp32
    statistics with E[x²]−E[x]² clamped at 0 (the JAX reference's exact
    form), then ``x̂·w + b`` cast back to x2d.dtype. Returns ``(y, mean,
    rstd)``, mean and rstd fp32 of shape (rows,)."""
    x32 = x2d.float()
    mean = x32.mean(dim=-1)
    var = torch.clamp((x32 * x32).mean(dim=-1) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean[:, None]) * rstd[:, None]
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2d.dtype), mean, rstd


def layer_norm_reference(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last axis of any shape: the forward reference's
    ``y`` alone."""
    y, _, _ = layer_norm_fwd_reference(x.reshape(-1, x.shape[-1]), weight,
                                       bias, eps)
    return y.reshape(x.shape)


def layer_norm_bwd_reference(dy, x2d, mean, rstd, weight):
    """Plain version of the backward kernel (the JAX kernel's formula, not
    autograd), all in fp32: ``g = dy·w``, ``dx = rstd·(g − mean(g) −
    x̂·mean(g·x̂))``, ``dw = Σ dy·x̂``, ``db = Σ dy``. Returns ``dx`` in
    x2d's type and ``dw``, ``db`` in the weight's type."""
    dy32, x32 = dy.float(), x2d.float()
    xhat = (x32 - mean[:, None]) * rstd[:, None]
    g = dy32 * weight.float()
    c1 = g.mean(dim=-1, keepdim=True)
    c2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (g - c1 - xhat * c2) * rstd[:, None]
    dw = (dy32 * xhat).sum(dim=0)
    db = dy32.sum(dim=0)
    return dx.to(x2d.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def _check_rows(what, x2d, *vectors):
    """The kernels' shared input rules: 2-d contiguous CUDA (rows, hidden)
    in fp32 or bf16; (hidden,) vectors of the same type and device;
    16-byte aligned; hidden a multiple of the 16-byte vector width."""
    ku.require(x2d.is_cuda and x2d.dim() == 2,
               f"{what} takes a 2-d CUDA tensor, got {x2d.device} "
               f"{tuple(x2d.shape)}")
    rows, hidden = x2d.shape
    ku.require(x2d.dtype in _DTYPES,
               f"{what} takes fp32 or bf16, got {x2d.dtype}")
    for name, t in vectors:
        ku.require(t.device == x2d.device and t.dtype == x2d.dtype
                   and tuple(t.shape) == (hidden,) and t.is_contiguous(),
                   f"{what}: {name} must be a contiguous ({hidden},) "
                   f"{x2d.dtype} tensor on {x2d.device}")
    vec = 16 // x2d.element_size()
    ku.require(hidden % vec == 0,
               f"{what}: hidden ({hidden}) must be a multiple of {vec} for "
               f"16-byte vector loads")
    ku.require(x2d.is_contiguous(), f"{what}: x must be contiguous")
    ku.require(all(t.data_ptr() % 16 == 0
                   for t in (x2d, *(t for _, t in vectors))),
               f"{what}: tensors must be 16-byte aligned")
    ku.require(rows < 2 ** 31, f"{what}: too many rows")
    return rows, hidden


def layer_norm_fwd(x2d, weight, bias, eps: float = 1e-5, stats: bool = False):
    """Launch the LayerNorm forward kernel on CUDA tensors: ``x2d`` (rows,
    hidden) contiguous, ``weight``/``bias`` (hidden,), one dtype (fp32 or
    bf16). Returns y like x2d, or ``(y, mean, rstd)`` (fp32, (rows,)) with
    ``stats``."""
    rows, hidden = _check_rows("layer_norm_fwd", x2d, ("weight", weight),
                               ("bias", bias))
    y = torch.empty_like(x2d)
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
        rstd = torch.empty_like(mean)
    lib = ku.load_kernel("layer_norm", _SIGNATURES)
    status = lib.layer_norm_fwd(
        x2d.device.index, x2d.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), mean.data_ptr() if stats else None,
        rstd.data_ptr() if stats else None, rows, hidden, float(eps),
        int(x2d.dtype == torch.bfloat16), ku.stream_handle(x2d))
    ku.count_launch("layer_norm_fwd")
    ku.check_status(lib, status, "layer_norm_fwd")
    return (y, mean, rstd) if stats else y


def layer_norm_bwd(dy, x2d, mean, rstd, weight):
    """Launch the LayerNorm backward kernels on CUDA tensors (the
    per-block partial dw/db rows, then their in-order sum): returns ``(dx,
    dw, db)``, dx like x2d, dw and db in the weight's type. dw/db are
    bitwise the same for the same inputs (no atomics)."""
    rows, hidden = _check_rows("layer_norm_bwd", x2d, ("weight", weight))
    ku.require(dy.shape == x2d.shape and dy.dtype == x2d.dtype
               and dy.device == x2d.device and dy.is_contiguous()
               and dy.data_ptr() % 16 == 0,
               f"layer_norm_bwd: dy must be a contiguous, aligned "
               f"{tuple(x2d.shape)} {x2d.dtype} tensor like x")
    for name, t in (("mean", mean), ("rstd", rstd)):
        ku.require(t.device == x2d.device and t.dtype == torch.float32
                   and tuple(t.shape) == (rows,) and t.is_contiguous(),
                   f"layer_norm_bwd: {name} must be a contiguous ({rows},) "
                   f"fp32 tensor on {x2d.device}")
    dx = torch.empty_like(x2d)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    parts = max(1, min(rows, _BWD_PARTS))
    work = torch.empty(2 * parts * hidden, dtype=torch.float32,
                       device=x2d.device)
    lib = ku.load_kernel("layer_norm", _SIGNATURES)
    status = lib.layer_norm_bwd(
        x2d.device.index, dy.data_ptr(), x2d.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), weight.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), work.data_ptr(), rows, hidden, parts,
        int(x2d.dtype == torch.bfloat16), ku.stream_handle(x2d))
    ku.count_launch("layer_norm_bwd")
    ku.check_status(lib, status, "layer_norm_bwd")
    return dx, dw, db


class LayerNormAffine(torch.autograd.Function):
    """Differentiable affine LayerNorm over (rows, hidden): the kernels for
    CUDA tensors, their plain versions for CPU tensors (or under
    ``force_plain``)."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps):
        ctx.kernel = ku.use_kernel(x2d)
        if ctx.kernel:
            y, mean, rstd = layer_norm_fwd(x2d, weight, bias, eps, stats=True)
        else:
            y, mean, rstd = layer_norm_fwd_reference(x2d, weight, bias, eps)
        ctx.save_for_backward(x2d, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.kernel:
            dx, dw, db = layer_norm_bwd(dy, x2d, mean, rstd, weight)
        else:
            dx, dw, db = layer_norm_bwd_reference(dy, x2d, mean, rstd,
                                                  weight)
        return dx, dw, db, None


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last axis: the plain versions on the CPU, the
    kernels on CUDA for the affine form. The non-affine form (``weight`` or
    ``bias`` None) is :func:`layer_norm_reference` on every device, as JAX
    sends it to its reference (``apex_tpu/ops/layer_norm.py:344``).
    Differentiable: with autograd recording, the affine form goes through
    :class:`LayerNormAffine`; without it, the forward alone runs and no
    statistics are kept."""
    if weight is None or bias is None:
        return layer_norm_reference(x, weight, bias, eps)
    hidden = x.shape[-1]
    kernel = ku.use_kernel(x)
    if kernel:
        ku.require(x.is_contiguous(), "layer_norm: x must be contiguous")
    x2d = x.reshape(-1, hidden)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        y = LayerNormAffine.apply(x2d, weight, bias, eps)
    elif kernel:
        y = layer_norm_fwd(x2d, weight, bias, eps)
    else:
        return layer_norm_reference(x, weight, bias, eps)
    return y.reshape(x.shape)
