"""FusedLAMB — layer-wise adaptive moments with global grad-norm clipping
(counterpart of ``apex_tpu/optimizers/fused_lamb.py``).

stage 1 (per element)::

    clip = max_grad_norm > 0 and ||g||_global > max_grad_norm
           ? ||g||_global / max_grad_norm : 1
    g' = g / clip
    m = b1*m + beta3*g'            (beta3 = 1-b1 when grad_averaging else 1)
    v = b2*v + (1-b2)*g'*g'
    update = (m/c1) / (sqrt(v/c2) + eps) + weight_decay * p

stage 2 (per tensor)::

    ratio = (||p|| > 0 and ||update|| > 0) ? ||p|| / ||update|| : 1
            (1 when weight_decay == 0, unless use_nvlamb)
    p -= lr * ratio * update

JAX runs it as an XLA op chain; it does not reach the LAMB tail kernel
(only the distributed LAMB of ``contrib`` does), so the port's is plain
torch ops on every device too. c1 and c2 come from the device count.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from apex_tpu_torch.optimizers._common import (DeviceStepOptimizer,
                                               Schedule, global_norm,
                                               guarded)


class FusedLAMB(DeviceStepOptimizer):
    """LAMB over an iterable of tensors; per param ``state["exp_avg"]`` and
    ``state["exp_avg_sq"]`` (fp32). The clipping norm is over the
    gradients of every group, as JAX's over the whole tree."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 amsgrad: bool = False, adam_w_mode: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        if not adam_w_mode:
            raise RuntimeError(
                "FusedLAMB only supports the decoupled (adamw) decay mode, "
                "as in the reference kernel.")
        super().__init__(params, dict(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb, step=0))
        self._clip = None

    def _begin_step(self) -> None:
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        self._clip = None
        mgn = self.defaults["max_grad_norm"]
        if grads and mgn > 0:
            gnorm = global_norm(grads)
            # a tensor divisor: JAX divides (torch multiplies by the
            # reciprocal of a Python number)
            self._clip = torch.where(
                gnorm > mgn, gnorm / torch.full_like(gnorm, mgn),
                torch.ones_like(gnorm))

    def _leaf(self, group, p, count, old_count, lr, skip) -> None:
        b1, b2 = group["betas"]
        wd = group["weight_decay"]
        beta3 = (1.0 - b1) if group["grad_averaging"] else 1.0
        state = self._state(p, exp_avg=None, exp_avg_sq=None)
        m, v = state["exp_avg"], state["exp_avg_sq"]
        t = count.float()
        if group["bias_correction"]:
            c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        else:
            c1 = c2 = torch.ones_like(t)
        g = p.grad.float()
        if self._clip is not None:
            g = g / self._clip
        p32 = p.float()
        m_new = b1 * m + beta3 * g
        v_new = b2 * v + (1.0 - b2) * g * g
        upd = (m_new / c1) / (torch.sqrt(v_new / c2) + group["eps"])
        if wd != 0.0:
            upd = upd + wd * p32
        if wd == 0.0 and not group["use_nvlamb"]:
            ratio = 1.0
        else:
            w_norm = torch.sqrt(torch.sum(p32 * p32))
            u_norm = torch.sqrt(torch.sum(upd * upd))
            ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, torch.ones_like(w_norm))
        m.copy_(guarded(skip, m_new, m))
        v.copy_(guarded(skip, v_new, v))
        self._apply(p, (-lr * ratio * upd).to(p.dtype), skip)


class FusedMixedPrecisionLamb(FusedLAMB):
    """Mixed-precision LAMB (JAX's ``FusedMixedPrecisionLamb``): LAMB with
    fp32 state. The fp32 masters, the model cast and the unscale are the
    amp layer's (``amp.initialize`` / ``model_params`` /
    ``apply_grads_with_optimizer``), so this is :class:`FusedLAMB`;
    ``step`` and ``reduced_precision_dtype`` are taken for the signature,
    as in JAX."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 step: int = 0, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 amsgrad: bool = False, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 reduced_precision_dtype=None):
        del step, reduced_precision_dtype
        super().__init__(params, lr=lr, bias_correction=bias_correction,
                         betas=betas, eps=eps, weight_decay=weight_decay,
                         amsgrad=amsgrad, grad_averaging=grad_averaging,
                         max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)
