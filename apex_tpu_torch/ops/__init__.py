"""Ops of the port: plain PyTorch versions beside the CUDA kernels."""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF,
    FlashAttention,
    attention_dropout_mask,
    attention_reference,
    flash_attention,
    flash_attention_bwd_dbias,
    flash_attention_bwd_dbias_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from apex_tpu_torch.ops.attention_varlen import (  # noqa: F401
    VarlenAttention,
    attention_varlen_reference,
    flash_attention_varlen,
    flash_varlen_bwd_dkv,
    flash_varlen_bwd_dq,
    flash_varlen_bwd_reference,
    flash_varlen_fwd,
    flash_varlen_fwd_reference,
)
from apex_tpu_torch.ops.dropout import (  # noqa: F401
    HiddenDropout,
    hidden_dropout,
    hidden_dropout_fwd,
    hidden_dropout_reference,
)
from apex_tpu_torch.ops.fused_update import (  # noqa: F401
    adam_tail_reference,
    fused_adam_tail,
    fused_lamb_tail,
    lamb_tail_reference,
    resolve_fused,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    LayerNormAffine,
    RMSNormAffine,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_fwd_reference,
    layer_norm_reference,
    rms_norm,
    rms_norm_bwd,
    rms_norm_bwd_reference,
    rms_norm_fwd,
    rms_norm_fwd_reference,
    rms_norm_reference,
)
from apex_tpu_torch.ops.lm_head_loss import (  # noqa: F401
    LMHeadLoss,
    kernel_fits,
    lm_head_loss,
    lm_head_loss_bwd_dw,
    lm_head_loss_bwd_dx,
    lm_head_loss_bwd_reference,
    lm_head_loss_fwd,
    lm_head_loss_fwd_reference,
    lm_head_loss_reference,
)
from apex_tpu_torch.ops.softmax import (  # noqa: F401
    MASK_FILL,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    softmax_cross_entropy_loss,
)
