"""FusedAdam — Adam/AdamW with the reference's exact update math
(counterpart of ``apex_tpu/optimizers/fused_adam.py``), as a
``torch.optim.Optimizer``.

ADAM_MODE_0 (``adam_w_mode=True``, decoupled decay)::

    m = b1*m + (1-b1)*g
    v = b2*v + (1-b2)*g*g
    u = (m / c1) / (sqrt(v / c2) + eps) + weight_decay * p
    p = p + (-lr * u).to(p.dtype)

ADAM_MODE_1 (``adam_w_mode=False``, L2): ``g += weight_decay * p`` before
the moments, no decay term in ``u``. ``c1 = 1 - b1**t``, ``c2 = 1 - b2**t``
(1 without ``bias_correction``), computed once per step in fp32. Moments
are fp32 whatever the param dtype; the update is rounded to the param
dtype and then added, as ``bench.py`` applies ``p + u``. The moments are
updated in place.

``fused_tail`` picks how the tail runs, as in JAX: ``"auto"`` (the
default) and ``"on"`` run it per leaf through
:func:`apex_tpu_torch.ops.fused_update.fused_adam_tail` — one CUDA kernel
per leaf (B #15) for a parameter on the card, its plain version on the
CPU — and then apply ``p += (-lr·u).to(p.dtype)``; ``"off"`` keeps the op
chain above on every device (``adam_tail_reference(in_place=True)``: the
moments updated with ``mul_``/``add_``, no new m or v).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.fused_update import (adam_tail_reference,
                                             fused_adam_tail, resolve_fused)
from apex_tpu_torch.optimizers._common import Schedule, value_at


class FusedAdam(torch.optim.Optimizer):
    """Adam/AdamW over an iterable of tensors (the JAX constructor's
    arguments). Per group, ``group["step"]`` is the int step count; per
    param, ``state["exp_avg"]`` and ``state["exp_avg_sq"]`` are fp32."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 capturable: bool = True, fused_tail: str = "auto"):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        self.use_fused = resolve_fused(fused_tail, what="fused_tail")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, adam_w_mode=adam_w_mode,
                        weight_decay=weight_decay, step=0)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            group["step"] += 1
            t = group["step"]
            b1, b2 = group["betas"]
            lr = value_at(group["lr"], t)
            eps, wd = group["eps"], group["weight_decay"]
            if group["bias_correction"]:
                # fp32, as JAX computes 1 - b1**t from an fp32 count
                c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
                c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
            else:
                c1 = c2 = 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.float32)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                kw = dict(betas=(b1, b2), eps=eps, weight_decay=wd,
                          adam_w_mode=group["adam_w_mode"])
                if self.use_fused:
                    # the whole tail as one kernel per leaf (JAX's leaf)
                    upd, _, _ = fused_adam_tail(p.grad.contiguous(), m, v, p,
                                                c1, c2, **kw)
                else:
                    upd, _, _ = adam_tail_reference(p.grad, m, v, p, c1, c2,
                                                    in_place=True, **kw)
                p.add_((-lr * upd).to(p.dtype))
        return loss
