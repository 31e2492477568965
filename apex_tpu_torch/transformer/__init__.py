"""Transformer models of the port (counterpart of ``apex_tpu/transformer``):
the enums, ``functional`` (``FusedScaleMaskSoftmax``), ``parallel_state``,
``tensor_parallel`` (the tp layers, mappings and the RNG policy),
``sequence_parallel``, ``pipeline_parallel`` (the p2p ring shifts, the
microbatch calculators and the four schedules), ``moe`` (mixture of
experts, experts over dp), ``_data`` (the batch samplers) and ``testing``
(GPT, T5, BERT and their pipeline wiring)."""

from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
