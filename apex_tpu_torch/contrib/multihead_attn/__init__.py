"""Fused multi-head attention modules (counterpart of
``apex_tpu/contrib/multihead_attn``)."""

from apex_tpu_torch.contrib.multihead_attn.modules import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]
