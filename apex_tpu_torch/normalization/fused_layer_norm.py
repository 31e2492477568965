"""FusedLayerNorm / FusedRMSNorm as ``torch.nn.Module``\\ s (counterpart of
``apex_tpu/normalization/fused_layer_norm.py``, ref
``apex/normalization/fused_layer_norm.py``).

Each module normalizes over the trailing ``normalized_shape`` dims,
flattened to one hidden axis as JAX's ``__call__`` does, through
:func:`~apex_tpu_torch.ops.layer_norm.layer_norm` /
:func:`~apex_tpu_torch.ops.layer_norm.rms_norm` (JAX's dispatch: the
kernels on CUDA where its gate holds). The parameters are ``weight``
(ones) and, for LayerNorm, ``bias`` (zeros), flattened to (hidden,), in
``param_dtype`` — fp32 by default, as in JAX, whatever the input's type:
the kernels take a bf16 x with an fp32 weight, compute in fp32 and return
x's type. The ``Mixed*`` variants (Megatron's mixed-dtype modules) are the
base classes with fp32 parameters, kept under their names for API parity,
as JAX keeps them. JAX names the weight ``scale``;
:func:`apex_tpu_torch.convert.norm_state_from_numpy` carries a flax
module's params over.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm


def _norm_shape(shape: Union[int, Sequence[int]]):
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


class _FusedNorm(nn.Module):
    has_bias = True

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        hidden = math.prod(self.normalized_shape)
        dev = resolve_device(device)
        self.weight = self.bias = None
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(hidden, dtype=param_dtype,
                                                  device=dev))
            if self.has_bias:
                self.bias = nn.Parameter(torch.zeros(
                    hidden, dtype=param_dtype, device=dev))

    def _norm(self, x2):
        raise NotImplementedError

    def forward(self, x):
        shape = self.normalized_shape
        lead = x.shape[:x.dim() - len(shape)]
        y = self._norm(x.reshape(*lead, math.prod(shape)))
        return y.reshape(x.shape)

    def extra_repr(self) -> str:
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")


class FusedLayerNorm(_FusedNorm):
    """Layer norm over the trailing ``normalized_shape`` dims (ref
    ``fused_layer_norm.py:204-298``)."""

    def _norm(self, x2):
        return layer_norm(x2, self.weight, self.bias, self.eps)


class FusedRMSNorm(_FusedNorm):
    """RMS norm (ref ``fused_layer_norm.py:300-396``): a weight and no
    bias."""

    has_bias = False

    def _norm(self, x2):
        return rms_norm(x2, self.weight, self.eps)


class MixedFusedLayerNorm(FusedLayerNorm):
    """Megatron's mixed-dtype variant (ref ``fused_layer_norm.py:398-418``):
    fp32 params and fp32 math with bf16/fp16 input and output — the base
    class, whose params default to fp32."""


class MixedFusedRMSNorm(FusedRMSNorm):
    """Ref ``fused_layer_norm.py:420-438``."""
