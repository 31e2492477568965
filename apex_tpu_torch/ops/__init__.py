"""Ops of the port: plain PyTorch versions beside the CUDA kernels."""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF,
    attention_reference,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    layer_norm,
    layer_norm_fwd,
    layer_norm_reference,
)
