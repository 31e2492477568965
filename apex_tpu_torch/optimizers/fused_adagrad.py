"""FusedAdagrad (counterpart of ``apex_tpu/optimizers/fused_adagrad.py``).

MODE_0 (L2, default)::

    g += weight_decay * p
    h += g*g
    p -= lr * g / (sqrt(h) + eps)

MODE_1 (``adagrad_w_mode``, decoupled)::

    h += g*g
    p -= lr * (g / (sqrt(h) + eps) + weight_decay * p)

Plain torch ops on every device, as JAX's XLA op chain.
"""

from __future__ import annotations

from typing import Iterable

import torch

from apex_tpu_torch.optimizers._common import (DeviceStepOptimizer,
                                               Schedule, guarded)


class FusedAdagrad(DeviceStepOptimizer):
    """Adagrad over an iterable of tensors; per param ``state["sum"]``
    (fp32), the accumulated squared gradients."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 adagrad_w_mode: bool = False):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      weight_decay=weight_decay,
                                      adagrad_w_mode=adagrad_w_mode, step=0))

    def _leaf(self, group, p, count, old_count, lr, skip) -> None:
        wd, w_mode = group["weight_decay"], group["adagrad_w_mode"]
        h = self._state(p, sum=None)["sum"]
        g, p32 = p.grad.float(), p.float()
        if not w_mode and wd != 0.0:
            g = g + wd * p32
        h_new = h + g * g
        upd = g / (torch.sqrt(h_new) + group["eps"])
        if w_mode and wd != 0.0:
            upd = upd + wd * p32
        h.copy_(guarded(skip, h_new, h))
        self._apply(p, (-lr * upd).to(p.dtype), skip)
