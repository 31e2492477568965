"""Transformer models of the port (counterpart of ``apex_tpu/transformer``):
the enums, ``functional`` (``FusedScaleMaskSoftmax``), ``tensor_parallel``
(single-device forms and the RNG policy) and ``testing`` (GPT and T5)."""

from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
