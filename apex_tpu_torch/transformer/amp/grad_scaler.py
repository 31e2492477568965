"""Model-parallel-aware gradient scaler (counterpart of
``apex_tpu/transformer/amp/grad_scaler.py``): a :class:`LossScaler`,
always dynamic, whose overflow flag is MAX-reduced over the model-parallel
ranks before the scale update, so every rank skips together."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState


class GradScaler(LossScaler):
    """JAX's constructor (``init_scale``, ``growth_factor``,
    ``backoff_factor``, ``growth_interval``, ``axis_names`` and the
    LossScaler keywords).

    ``axis_names``: the mesh axes the flag is MAX-reduced over; by
    default, JAX's, every model-parallel axis of ``parallel_state``'s
    mesh, read when the flag is synced (``()``: none, as on one device).
    ``group`` is the ``torch.distributed`` form: the group of the
    model-parallel ranks, in place of axis names."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000,
                 axis_names: Optional[Sequence[str]] = None, group=None,
                 **kw: Any) -> None:
        super().__init__("dynamic", init_scale=float(init_scale),
                         scale_factor=growth_factor,
                         scale_window=growth_interval,
                         backoff_factor=backoff_factor, **kw)
        self.axis_names = tuple(axis_names) if axis_names is not None else None
        if self.axis_names is not None and group is not None:
            raise ValueError("GradScaler takes axis_names= or group=, "
                             "not both")
        self.group = group

    def _mp_axes(self) -> Sequence[str]:
        if self.axis_names is not None:
            return self.axis_names
        from apex_tpu_torch.transformer import parallel_state

        return parallel_state.get_model_parallel_axes()

    def sync_found_inf(self, found_inf: torch.Tensor) -> torch.Tensor:
        """MAX all-reduce of the flag over the model-parallel axes (or the
        group); the flag itself over no axis."""
        if self.group is not None:
            return LossScaler.all_reduce_found_inf(found_inf,
                                                   group=self.group)
        axes = tuple(self._mp_axes())
        if not axes:
            return found_inf
        return LossScaler.all_reduce_found_inf(found_inf, axes)

    def update_scale(self, state: LossScalerState, found_inf: torch.Tensor,
                     *, synced: bool = True
                     ) -> Tuple[LossScalerState, torch.Tensor]:
        """JAX's ``update``: ``synced=False`` reduces the flag over the
        group first."""
        if not synced:
            found_inf = self.sync_found_inf(found_inf)
        return super().update_scale(state, found_inf)
