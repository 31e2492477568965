"""FusedSGD — SGD with momentum, dampening and Nesterov in the reference's
math (counterpart of ``apex_tpu/optimizers/fused_sgd.py``)::

    d = g + weight_decay * p                       (wd before momentum)
    buf = momentum * buf + (1 - dampening) * d     (first step: buf = d)
    step = d + momentum * buf   if nesterov else buf
    p -= lr * step

``wd_after_momentum=True`` adds the decay to the momentum-combined step
instead. JAX runs it as an XLA op chain (no Pallas kernel), so the port's
is plain torch ops on every device.
"""

from __future__ import annotations

from typing import Iterable

import torch

from apex_tpu_torch.optimizers._common import (DeviceStepOptimizer,
                                               Schedule, guarded)


class FusedSGD(DeviceStepOptimizer):
    """SGD over an iterable of tensors (the JAX constructor's arguments);
    per param ``state["momentum_buffer"]`` (fp32) when momentum != 0."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 momentum: float = 0.0, dampening: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 wd_after_momentum: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        super().__init__(params, dict(
            lr=lr, momentum=momentum, dampening=dampening,
            weight_decay=weight_decay, nesterov=nesterov,
            wd_after_momentum=wd_after_momentum, step=0))

    def _leaf(self, group, p, count, old_count, lr, skip) -> None:
        momentum, wd = group["momentum"], group["weight_decay"]
        after = group["wd_after_momentum"]
        g, p32 = p.grad.float(), p.float()
        d = g if after else g + wd * p32
        if momentum != 0.0:
            state = self._state(p, momentum_buffer=None)
            buf = state["momentum_buffer"]
            # the first step starts the buffer at d (torch / apex)
            new_buf = torch.where(old_count == 0, d,
                                  momentum * buf
                                  + (1.0 - group["dampening"]) * d)
            step = d + momentum * new_buf if group["nesterov"] else new_buf
            buf.copy_(guarded(skip, new_buf, buf))
        else:
            step = d
        if after:
            step = step + wd * p32
        self._apply(p, (-lr * step).to(p.dtype), skip)
