"""Dynamic loss scaling as a functional transform (counterpart of
``apex_tpu/amp/scaler.py``).

The scaler's state is three 0-d tensors on the device
(:class:`LossScalerState`): the fp32 scale, the int32 count of clean steps
since the last growth and the int32 hysteresis credits. Unscaling, the
overflow check, the scale update and the skip decision are device ops
(``torch.where``): no value is read back to the host in a step, where the
reference reads its overflow flag (``.item()``) every step.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.optimizers._common import tree_leaves, tree_map


class LossScalerState(NamedTuple):
    """The scaler's checkpointable state (0-d tensors on one device)."""

    loss_scale: torch.Tensor       # fp32
    unskipped: torch.Tensor        # int32: clean steps since last growth
    hysteresis_left: torch.Tensor  # int32: overflows until backoff


class LossScaler:
    """Static config + pure methods over :class:`LossScalerState`, JAX's
    arguments: ``LossScaler("dynamic")`` (init 2**16, x2 after 2000 clean
    steps, /2 on overflow, max 2**24, Megatron's ``hysteresis``) or
    ``LossScaler(128.0)`` (static: the update keeps it)."""

    def __init__(self, loss_scale: Union[str, float] = "dynamic",
                 init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24,
                 backoff_factor: Optional[float] = None,
                 hysteresis: int = 1):
        if loss_scale == "dynamic":
            self.dynamic = True
            self._init_scale = init_scale
        else:
            self.dynamic = False
            self._init_scale = float(loss_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.backoff_factor = (backoff_factor if backoff_factor is not None
                               else 1.0 / scale_factor)
        self.min_loss_scale = (min_loss_scale if min_loss_scale is not None
                               else 1.0)
        self.max_loss_scale = max_loss_scale
        self.hysteresis = int(hysteresis)

    # -- state ------------------------------------------------------------
    def init_state(self, device: DeviceLike = None) -> LossScalerState:
        """The initial state on ``device`` (default ``cuda``), made with
        fills: no copy from the host."""
        dev = resolve_device(device)
        full = lambda v, dt: torch.full((), v, dtype=dt, device=dev)
        return LossScalerState(full(self._init_scale, torch.float32),
                               full(0, torch.int32),
                               full(self.hysteresis, torch.int32))

    def loss_scale(self, state: LossScalerState) -> torch.Tensor:
        return state.loss_scale

    # -- train-step ops ---------------------------------------------------
    def scale_loss(self, loss: torch.Tensor,
                   state: LossScalerState) -> torch.Tensor:
        """``loss`` in fp32 times the scale (fp32: a 2**16 scale overflows
        an fp16 loss of 1.0)."""
        return loss.to(torch.float32) * state.loss_scale

    def unscale(self, grads: Any, state: LossScalerState,
                out_dtype: Optional[torch.dtype] = torch.float32
                ) -> Tuple[Any, torch.Tensor]:
        """``(unscaled_grads, found_inf)``: each leaf cast to fp32, times
        1/scale (fp32: JAX's product, not an in-place product in the
        grad's own type), then cast to ``out_dtype`` (None keeps each
        leaf's dtype); ``found_inf`` a 0-d fp32 0/1 over every leaf."""
        inv = 1.0 / state.loss_scale
        leaves = tree_leaves(grads)
        if leaves:
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in leaves]).all()
        else:
            finite = torch.ones((), dtype=torch.bool,
                                device=state.loss_scale.device)
        out = tree_map(lambda g: (g.to(torch.float32) * inv).to(
            g.dtype if out_dtype is None else out_dtype), grads)
        return out, (~finite).to(torch.float32)

    def update_scale(self, state: LossScalerState, found_inf: torch.Tensor
                     ) -> Tuple[LossScalerState, torch.Tensor]:
        """``(new_state, should_skip)``: on overflow spend a hysteresis
        credit and, with none left, multiply the scale by the backoff
        factor (bounded below) and reset the clean count; after
        ``scale_window`` clean steps grow it (bounded above) and refill the
        credits. ``should_skip`` is a 0-d bool tensor."""
        overflow = found_inf > 0
        if not self.dynamic:
            return state, overflow
        new_unskipped = torch.where(overflow, 0, state.unskipped + 1)
        grow = new_unskipped >= self.scale_window
        new_hyst = torch.where(
            overflow, state.hysteresis_left - 1,
            torch.where(grow, self.hysteresis, state.hysteresis_left))
        backoff = overflow & (new_hyst <= 0)
        new_scale = torch.where(
            backoff,
            torch.clamp(state.loss_scale * self.backoff_factor,
                        min=self.min_loss_scale),
            torch.where(
                grow,
                torch.clamp(state.loss_scale * self.scale_factor,
                            max=self.max_loss_scale),
                state.loss_scale))
        new_unskipped = torch.where(grow, 0, new_unskipped)
        return LossScalerState(
            new_scale, new_unskipped.to(torch.int32),
            torch.clamp(new_hyst, min=0).to(torch.int32)), overflow

    # -- telemetry --------------------------------------------------------
    @staticmethod
    def metrics(state: LossScalerState, found_inf=None, metrics=None):
        """Record the scaler's telemetry into a port
        :class:`~apex_tpu_torch.monitor.metrics.Metrics`: ``loss_scale``,
        the step's ``overflow`` and the cumulative ``overflow_total`` /
        ``skipped_total`` (pass last step's Metrics to keep counting)."""
        from apex_tpu_torch.monitor.metrics import Metrics

        m = Metrics() if metrics is None else metrics
        entries = {"loss_scale": state.loss_scale}
        if found_inf is not None:
            overflow = (torch.as_tensor(found_inf) > 0).to(torch.float32)
            entries["overflow"] = overflow
            m = m.accumulate(overflow_total=overflow, skipped_total=overflow)
        return m.record(**entries)

    # -- distributed ------------------------------------------------------
    @staticmethod
    def all_reduce_found_inf(found_inf: torch.Tensor, axis_names=None,
                             group=None) -> torch.Tensor:
        """MAX all-reduce of the overflow flag, so every rank skips
        together: over the current mesh's ``axis_names`` (a name or a
        sequence, JAX's ``lax.pmax``: one all-reduce an axis, the max over
        their product), or over ``group`` (a ``torch.distributed`` process
        group; also accepted in ``axis_names``' place). A new tensor."""
        if (axis_names is None) == (group is None):
            raise TypeError(
                "all_reduce_found_inf takes the mesh's axis_names (JAX's "
                "argument) or group= (a torch.distributed group): exactly "
                "one of them")
        from apex_tpu_torch.comm.collectives import all_reduce
        from apex_tpu_torch.parallel.mesh import resolve_axis

        import torch.distributed as dist

        out = found_inf.clone()
        if group is not None:
            axes = [group]
        elif isinstance(axis_names, (list, tuple)):
            axes = list(axis_names)
        else:
            axes = [axis_names]         # one name, or a process group
        for axis in axes:
            g, world, _ = resolve_axis(axis)
            all_reduce(out, g, world, op=dist.ReduceOp.MAX,
                       tag="found_inf")
        return out

    # -- checkpointing ------------------------------------------------------
    def state_dict(self, state: LossScalerState) -> dict:
        return {"loss_scale": float(state.loss_scale),
                "unskipped": int(state.unskipped),
                "hysteresis_left": int(state.hysteresis_left)}

    def load_state_dict(self, d: dict,
                        device: DeviceLike = None) -> LossScalerState:
        """A state from :meth:`state_dict`, on ``device`` (default
        ``cuda``). A NaN, zero or negative scale is refused (one bad
        restore would poison every later step with no overflow to catch
        it); a dynamic scaler clamps the scale into its bounds."""
        raw = float(d["loss_scale"])
        if not math.isfinite(raw) or raw <= 0.0:
            raise ValueError(
                f"restored loss_scale {raw!r} is not a finite positive "
                "number — the checkpoint's scaler state is corrupt; "
                "re-initialize the scaler or resume from an older "
                "checkpoint")
        scale = (min(max(raw, self.min_loss_scale), self.max_loss_scale)
                 if self.dynamic else raw)
        dev = resolve_device(device)
        full = lambda v, dt: torch.full((), v, dtype=dt, device=dev)
        return LossScalerState(
            full(scale, torch.float32), full(int(d["unskipped"]), torch.int32),
            full(int(d.get("hysteresis_left", self.hysteresis)),
                 torch.int32))
