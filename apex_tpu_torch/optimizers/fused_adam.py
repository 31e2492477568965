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

``step(found_inf=flag)`` (amp's overflow guard, a 0-d device tensor) and
any step after it keep the count on the device, as JAX's always
capturable ``FusedAdam``: ``group["step"]`` becomes a 0-d int32 tensor,
c1 and c2 are computed from it on the card (``1 - β**t`` in fp32) and
handed to the kernel as a device pointer, a callable ``lr`` gets the
device count, and where the flag is set the kernel leaves m and v and
writes u = 0, so p is bitwise unchanged and the count does not advance.
No value is read back to the host.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.fused_update import (adam_tail_reference,
                                             fused_adam_tail, resolve_fused)
from apex_tpu_torch.optimizers._common import (Schedule, advance_count,
                                               device_count, skip_flag,
                                               value_at)


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
    def step(self, closure=None, *, found_inf=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            if found_inf is not None or torch.is_tensor(group["step"]):
                self._device_step(group, found_inf)
                continue
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
                m, v = self._moments(p)
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

    def _moments(self, p):
        """The param's fp32 moments, made zero on first use."""
        state = self.state[p]
        if not state:
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        return state["exp_avg"], state["exp_avg_sq"]

    def _device_step(self, group, found_inf) -> None:
        """One update of ``group`` with the count on the device and, when
        ``found_inf`` is given, the kernel's skip flag (class docstring)."""
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        dev = params[0].device
        count = device_count(group, dev) + 1
        b1, b2 = group["betas"]
        if group["bias_correction"]:
            # filled on the device: no copy from the host
            betas = torch.full((2,), b1, dtype=torch.float32, device=dev)
            betas[1:].fill_(b2)
            corr = 1.0 - torch.pow(betas, count.float())
        else:
            corr = torch.ones(2, dtype=torch.float32, device=dev)
        lr = value_at(group["lr"], count)
        flag = (None if found_inf is None
                else found_inf.to(device=dev, dtype=torch.float32)
                .reshape(1).contiguous())
        kw = dict(betas=(b1, b2), eps=group["eps"],
                  weight_decay=group["weight_decay"],
                  adam_w_mode=group["adam_w_mode"], corr=corr,
                  found_inf=flag)
        for p in params:
            m, v = self._moments(p)
            if self.use_fused:
                upd, _, _ = fused_adam_tail(p.grad.contiguous(), m, v, p,
                                            1.0, 1.0, **kw)
            else:
                upd, _, _ = adam_tail_reference(p.grad, m, v, p, 1.0, 1.0,
                                                in_place=True, **kw)
            p.add_((-lr * upd).to(p.dtype))
        advance_count(group, count, skip_flag(found_inf))
