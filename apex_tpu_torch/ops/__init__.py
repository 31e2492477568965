"""Ops of the port: plain PyTorch versions beside the CUDA kernels."""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF,
    FlashAttention,
    attention_dropout_mask,
    attention_reference,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    LayerNormAffine,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_fwd_reference,
    layer_norm_reference,
)
