"""Autocast interop helpers (counterpart of ``apex_tpu/_autocast_utils.py``):
the half types in order of preference, the active one, and the cast of a
call's float arguments."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch


def _get_autocast_dtypes() -> Sequence[torch.dtype]:
    """The half types, preferred first: bf16, then fp16 (Hopper takes
    both)."""
    return [torch.bfloat16, torch.float16]


def _get_current_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The caller's type, or bf16 (JAX's default; its policies are
    explicit, not a thread-local autocast state)."""
    return torch.bfloat16 if dtype is None else dtype


def _cast_if_autocast_enabled(*args: Any, dtype: torch.dtype = torch.bfloat16
                              ) -> tuple:
    """Each floating tensor among ``args`` cast to ``dtype``, the rest as
    they are (always on, as JAX's)."""
    return tuple(a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)
