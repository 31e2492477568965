"""Optimizers of the port (counterpart of ``apex_tpu/optimizers``)."""

from apex_tpu_torch.optimizers._common import Schedule, value_at  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
