"""Packed variable-length attention (counterpart of
``apex_tpu/contrib/fmha``; ref ``apex/contrib/fmha``): documents of
different lengths concatenated into one (total_tokens, ...) tensor with
``cu_seqlens`` boundaries, attending only within their own document, with
no padding to a common length and no dense (total, total) mask."""

from apex_tpu_torch.contrib.fmha.fmha import (  # noqa: F401
    FMHA,
    cu_seqlens_to_segment_ids,
    fmha_packed,
)

__all__ = ["FMHA", "fmha_packed", "cu_seqlens_to_segment_ids"]
