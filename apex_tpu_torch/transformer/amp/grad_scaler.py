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

    ``axis_names=()`` names no model-parallel axis, as on one device with
    no mesh: :meth:`sync_found_inf` is the identity, as JAX's loop over no
    axes is. A non-empty ``axis_names`` raises: JAX reads the
    model-parallel axes off ``parallel_state``, which is not ported
    (ROADMAP A7c; ``LossScaler.all_reduce_found_inf`` takes mesh axis
    names). ``group`` is the ``torch.distributed`` form: the group of the
    model-parallel ranks. With neither (JAX's default, every non-dp axis
    of ``parallel_state``'s mesh) :meth:`sync_found_inf` raises, naming
    A7c."""

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
        if self.axis_names:
            raise NotImplementedError(
                f"GradScaler(axis_names={self.axis_names!r}) reduces over "
                "parallel_state's model-parallel axes: parallel_state is "
                "not ported (ROADMAP A7c); pass group= (a torch.distributed "
                "group) or axis_names=() on one device")
        if self.axis_names is not None and group is not None:
            raise ValueError("GradScaler takes axis_names=() or group=, "
                             "not both")
        self.group = group

    def sync_found_inf(self, found_inf: torch.Tensor) -> torch.Tensor:
        """MAX all-reduce of the flag over the model-parallel group; the
        flag itself under ``axis_names=()``."""
        if self.axis_names is not None:
            return found_inf
        if self.group is None:
            raise NotImplementedError(
                "GradScaler.sync_found_inf needs the model-parallel "
                "torch.distributed group (GradScaler(group=...)) or "
                "axis_names=(): parallel_state is not ported (ROADMAP A7c)")
        return LossScaler.all_reduce_found_inf(found_inf, group=self.group)

    def update_scale(self, state: LossScalerState, found_inf: torch.Tensor,
                     *, synced: bool = True
                     ) -> Tuple[LossScalerState, torch.Tensor]:
        """JAX's ``update``: ``synced=False`` reduces the flag over the
        group first."""
        if not synced:
            found_inf = self.sync_found_inf(found_inf)
        return super().update_scale(state, found_inf)
