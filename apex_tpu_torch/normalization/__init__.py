"""Fused normalization modules (counterpart of ``apex_tpu/normalization``;
ref ``apex/normalization/__init__.py``)."""

from apex_tpu_torch.normalization.fused_layer_norm import (  # noqa: F401
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
)
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm  # noqa: F401

__all__ = [
    "FusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
    "layer_norm",
    "rms_norm",
]
