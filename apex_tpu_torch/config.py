"""The mixed-precision policy (counterpart of ``apex_tpu/config.py``'s
:class:`PrecisionConfig`; its ``MeshConfig`` and
``TransformerParallelConfig`` are multi-device and wait for ROADMAP A7c /
A8). The amp opt levels O0-O3 and FP8 resolve to one of these.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Declarative mixed-precision policy, JAX's fields with torch dtypes.

    ``cast_model_type``      — dtype model params are cast to before the
                               forward (None: leave them)
    ``compute_dtype``        — dtype the O1 autocast runs matmuls in (None:
                               off)
    ``keep_batchnorm_fp32``  — keep normalization params fp32
    ``master_weights``       — keep fp32 master params for the optimizer
    ``loss_scale``           — a number (static) or ``"dynamic"``
    """

    opt_level: str = "O0"
    cast_model_type: Optional[torch.dtype] = None
    compute_dtype: Optional[torch.dtype] = None
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: object = 1.0  # float | "dynamic"

    def __post_init__(self):
        self._check({})

    def replace(self, **kw) -> "PrecisionConfig":
        self._check(kw)
        return dataclasses.replace(self, **kw)

    def _check(self, kw) -> None:
        # O1-style per-op casting manages its own casts: it and a
        # whole-model cast are mutually exclusive (JAX's refusals)
        compute = kw.get("compute_dtype", self.compute_dtype)
        cast_model = kw.get("cast_model_type", self.cast_model_type)
        if compute is not None and cast_model is not None:
            raise ValueError(
                "compute_dtype (O1-style per-op autocast) and cast_model_type "
                "(O2/O3-style whole-model cast) are mutually exclusive"
            )
        ls = kw.get("loss_scale", self.loss_scale)
        if not (ls == "dynamic" or isinstance(ls, (int, float))):
            raise ValueError(
                f"loss_scale must be a number or 'dynamic', got {ls!r}")
