"""Fused dense layers (counterpart of ``apex_tpu/fused_dense``)."""

from apex_tpu_torch.fused_dense.fused_dense import (  # noqa: F401
    FusedDense,
    FusedDenseGeluDense,
    fused_dense,
    fused_dense_gelu_dense,
)

__all__ = [
    "FusedDense",
    "FusedDenseGeluDense",
    "fused_dense",
    "fused_dense_gelu_dense",
]
