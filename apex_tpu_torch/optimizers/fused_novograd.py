"""FusedNovoGrad — layer-wise normalized gradient descent with momentum
(counterpart of ``apex_tpu/optimizers/fused_novograd.py``). The second
moment is one scalar **per tensor**::

    norm = ||g||_2^2        (norm_type=2; norm_type=0 -> max|g|^2)
    v    = norm                       on the first step (init_zero=False)
         = b2*v + (1-b2)*norm         afterwards
    d    = g / (sqrt(v) + eps)        (+ weight_decay * p if reg_inside_moment)
    m    = b1*m + beta3*d             (beta3 = 1-b1 when grad_averaging)
    p   -= lr * (m + weight_decay * p)   (decay outside the moment, default)

Plain torch ops on every device, as JAX's XLA op chain.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from apex_tpu_torch.optimizers._common import (DeviceStepOptimizer,
                                               Schedule, guarded)


class FusedNovoGrad(DeviceStepOptimizer):
    """NovoGrad over an iterable of tensors; per param
    ``state["exp_avg"]`` (fp32, the param's shape: JAX's ``mu``) and
    ``state["exp_avg_sq"]`` (a 0-d fp32: JAX's ``nu``)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.95, 0.98),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False, reg_inside_moment: bool = False,
                 grad_averaging: bool = True, norm_type: int = 2,
                 init_zero: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        if norm_type not in (0, 2):
            raise ValueError("norm_type must be 2 (L2) or 0 (inf)")
        super().__init__(params, dict(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, reg_inside_moment=reg_inside_moment,
            grad_averaging=grad_averaging, norm_type=norm_type,
            init_zero=init_zero, step=0))

    def _leaf(self, group, p, count, old_count, lr, skip) -> None:
        b1, b2 = group["betas"]
        wd, inside = group["weight_decay"], group["reg_inside_moment"]
        beta3 = (1.0 - b1) if group["grad_averaging"] else 1.0
        state = self._state(p, exp_avg=None, exp_avg_sq=())
        m, v = state["exp_avg"], state["exp_avg_sq"]
        g, p32 = p.grad.float(), p.float()
        if group["norm_type"] == 2:
            norm = torch.sum(g * g)
        else:
            norm = torch.max(torch.abs(g)) ** 2
        v_new = b2 * v + (1.0 - b2) * norm
        if not group["init_zero"]:
            v_new = torch.where(old_count == 0, norm, v_new)
        d = g / (torch.sqrt(v_new) + group["eps"])
        if wd != 0.0 and inside:
            d = d + wd * p32
        m_new = b1 * m + beta3 * d
        step = m_new
        if wd != 0.0 and not inside:
            step = step + wd * p32
        m.copy_(guarded(skip, m_new, m))
        v.copy_(guarded(skip, v_new, v))
        self._apply(p, (-lr * step).to(p.dtype), skip)
