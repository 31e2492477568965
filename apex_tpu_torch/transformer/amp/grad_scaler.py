"""Model-parallel-aware gradient scaler (counterpart of
``apex_tpu/transformer/amp/grad_scaler.py``): a :class:`LossScaler`,
always dynamic, whose overflow flag is MAX-reduced over the model-parallel
ranks before the scale update, so every rank skips together."""

from __future__ import annotations

from typing import Any, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState


class GradScaler(LossScaler):
    """JAX's constructor (``init_scale``, ``growth_factor``,
    ``backoff_factor``, ``growth_interval`` and the LossScaler keywords).
    ``group`` takes the place of JAX's ``axis_names``: the
    ``torch.distributed`` group of the model-parallel ranks. Without one,
    :meth:`sync_found_inf` raises: ``parallel_state`` (the mesh JAX
    defaults to) is not ported (ROADMAP A7)."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, group=None, **kw: Any) -> None:
        super().__init__("dynamic", init_scale=float(init_scale),
                         scale_factor=growth_factor,
                         scale_window=growth_interval,
                         backoff_factor=backoff_factor, **kw)
        self.group = group

    def sync_found_inf(self, found_inf: torch.Tensor) -> torch.Tensor:
        """MAX all-reduce of the flag over the model-parallel group."""
        if self.group is None:
            raise NotImplementedError(
                "GradScaler.sync_found_inf needs the model-parallel "
                "torch.distributed group (GradScaler(group=...)): "
                "parallel_state is not ported (ROADMAP A7)")
        return LossScaler.all_reduce_found_inf(found_inf, self.group)

    def update_scale(self, state: LossScalerState, found_inf: torch.Tensor,
                     *, synced: bool = True
                     ) -> Tuple[LossScalerState, torch.Tensor]:
        """JAX's ``update``: ``synced=False`` reduces the flag over the
        group first."""
        if not synced:
            found_inf = self.sync_found_inf(found_inf)
        return super().update_scale(state, found_inf)
