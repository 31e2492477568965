"""Contrib FastLayerNorm API (counterpart of
``apex_tpu/contrib/layer_norm``; ref ``apex/contrib/layer_norm/
layer_norm.py:40``, the ``fast_layer_norm`` extension for hidden sizes up
to 65k). The LayerNorm kernels here take every width JAX's gate admits,
so this package re-exports them under the contrib names."""

from apex_tpu_torch.normalization import \
    FusedLayerNorm as FastLayerNorm  # noqa: F401
from apex_tpu_torch.ops.layer_norm import \
    layer_norm as fast_layer_norm  # noqa: F401

__all__ = ["FastLayerNorm", "fast_layer_norm"]
