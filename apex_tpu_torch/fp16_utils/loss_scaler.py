"""The legacy loss scalers (counterpart of
``apex_tpu/fp16_utils/loss_scaler.py``): the static and the pre-amp
dynamic policy, over the port's :class:`apex_tpu_torch.amp.LossScaler`
(its state a :class:`LossScalerState` of device tensors)."""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.scaler import LossScaler as _ModernScaler
from apex_tpu_torch.optimizers._common import tree_leaves


class LossScaler(_ModernScaler):
    """A static scale: :meth:`update_scale` keeps it."""

    def __init__(self, scale: float = 1.0):
        super().__init__(loss_scale=float(scale))

    @property
    def cur_scale(self) -> float:
        """The legacy attribute: the configured scale."""
        return self._init_scale


class DynamicLossScaler(_ModernScaler):
    """The legacy dynamic knobs: ``init_scale`` (2**32), ``scale_factor``,
    ``scale_window``."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000):
        super().__init__("dynamic", init_scale=init_scale,
                         scale_factor=scale_factor, scale_window=scale_window)

    @staticmethod
    def has_overflow(grads) -> torch.Tensor:
        """A 0-d bool tensor: does any leaf hold an inf or a NaN."""
        leaves = tree_leaves(grads)
        if not leaves:
            return torch.zeros((), dtype=torch.bool)
        return ~torch.stack([torch.isfinite(g).all() for g in leaves]).all()
