"""Fused functional ops of the transformer stack (counterpart of
``apex_tpu/transformer/functional``)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    AttnMaskType,
    FusedScaleMaskSoftmax,
)

__all__ = ["AttnMaskType", "FusedScaleMaskSoftmax"]
