"""LayerNorm: plain PyTorch version + the CUDA forward kernel (counterpart
of ``apex_tpu/ops/layer_norm.py``).

``layer_norm`` dispatches by the tensor's device: the plain
:func:`layer_norm_reference` for a CPU tensor, the ``csrc/layer_norm.cu``
kernel (:func:`layer_norm_fwd`) for a CUDA tensor. A CUDA input the kernel
does not take raises. The backward kernel and RMSNorm come with the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch.ops import _kernel_util as ku

_SIGNATURES = {
    "layer_norm_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p],
}
_DTYPES = (torch.float32, torch.bfloat16)


def layer_norm_reference(x, weight=None, bias=None, eps: float = 1e-5):
    """fp32 statistics with E[x²]−E[x]² clamped at 0 (the JAX reference's
    exact form), then ``x̂·w + b`` cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp(
        (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm_fwd(x2d, weight, bias, eps: float = 1e-5):
    """Launch the LayerNorm forward kernel on CUDA tensors: ``x2d`` (rows,
    hidden) contiguous, ``weight``/``bias`` (hidden,), one dtype (fp32 or
    bf16). Returns y like x2d."""
    ku.require(x2d.is_cuda and x2d.dim() == 2,
               f"layer_norm_fwd takes a 2-d CUDA tensor, got {x2d.device} "
               f"{tuple(x2d.shape)}")
    rows, hidden = x2d.shape
    ku.require(x2d.dtype in _DTYPES,
               f"layer_norm_fwd takes fp32 or bf16, got {x2d.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        ku.require(t.device == x2d.device and t.dtype == x2d.dtype
                   and tuple(t.shape) == (hidden,) and t.is_contiguous(),
                   f"layer_norm_fwd: {name} must be a contiguous ({hidden},) "
                   f"{x2d.dtype} tensor on {x2d.device}")
    vec = 16 // x2d.element_size()
    ku.require(hidden % vec == 0,
               f"layer_norm_fwd: hidden ({hidden}) must be a multiple of "
               f"{vec} for 16-byte vector loads")
    ku.require(x2d.is_contiguous(), "layer_norm_fwd: x must be contiguous")
    ku.require(all(t.data_ptr() % 16 == 0 for t in (x2d, weight, bias)),
               "layer_norm_fwd: tensors must be 16-byte aligned")
    ku.require(rows < 2 ** 31, "layer_norm_fwd: too many rows")
    y = torch.empty_like(x2d)
    lib = ku.load_kernel("layer_norm", _SIGNATURES)
    status = lib.layer_norm_fwd(
        x2d.device.index, x2d.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), rows, hidden, float(eps),
        int(x2d.dtype == torch.bfloat16), ku.stream_handle(x2d))
    ku.count_launch("layer_norm_fwd")
    ku.check_status(lib, status, "layer_norm_fwd")
    return y


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last axis: the plain version on the CPU, the
    kernel on CUDA (affine form only — serving always passes w and b)."""
    if not ku.use_kernel(x):
        return layer_norm_reference(x, weight, bias, eps)
    ku.require(weight is not None and bias is not None,
               "the CUDA layer_norm kernel takes the affine form (weight "
               "and bias)")
    hidden = x.shape[-1]
    ku.require(x.is_contiguous(), "layer_norm: x must be contiguous")
    y = layer_norm_fwd(x.reshape(-1, hidden), weight, bias, eps)
    return y.reshape(x.shape)
