"""LARC — Layer-wise Adaptive Rate Clipping / scaling (counterpart of
``apex_tpu/parallel/larc.py``): each param's gradient is rescaled by an
adaptive local rate before the inner optimizer's step::

    local_lr = trust_coefficient * ||p|| / (||g|| + weight_decay * ||p|| + eps)
    clip mode:  g' = (g + wd*p) * min(local_lr / lr, 1)
    scale mode: g' = (g + wd*p) * local_lr
    params with ||p|| == 0 or ||g|| == 0 pass through (factor 1)

As in JAX, construct the inner optimizer with ``weight_decay=0``: LARC
folds the decay into the gradient. Single-device math, plain torch ops.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.optimizers._common import (Schedule, advance_count,
                                               skip_flag, tree_map,
                                               value_at)


class larc_transform:  # noqa: N801 - JAX's name for the transform
    """The gradient-rescaling stage alone (JAX's ``larc_transform``):
    ``init(params)`` gives the state (a 0-d int32 count on the params'
    device), ``update(grads, state, params)`` gives ``(grads', state')``.
    ``lr`` (a float or a function of the count) is required in clip mode,
    where it divides the local rate."""

    def __init__(self, trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 lr: Optional[Schedule] = None):
        if clip and lr is None:
            raise ValueError(
                "clip mode requires the lr used by the inner optimizer")
        self.trust_coefficient, self.clip = trust_coefficient, clip
        self.eps, self.weight_decay, self.lr = eps, weight_decay, lr

    def init(self, params: Any) -> torch.Tensor:
        from apex_tpu_torch.optimizers._common import tree_leaves

        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return torch.zeros((), dtype=torch.int32, device=dev)

    def update(self, grads: Any, state: torch.Tensor, params: Any):
        count = state + 1
        step_lr = None
        if self.lr is not None:
            step_lr = value_at(self.lr, count)
            if not torch.is_tensor(step_lr):
                step_lr = torch.full((), step_lr, dtype=torch.float32,
                                     device=count.device)
        trust, wd, eps = self.trust_coefficient, self.weight_decay, self.eps

        def leaf(g, p):
            g32, p32 = g.float(), p.float()
            p_norm = torch.sqrt(torch.sum(p32 * p32))
            g_norm = torch.sqrt(torch.sum(g32 * g32))
            adaptive = trust * p_norm / (g_norm + wd * p_norm + eps)
            if self.clip:
                adaptive = torch.clamp(adaptive / step_lr, max=1.0)
            adaptive = torch.where((p_norm > 0) & (g_norm > 0), adaptive,
                                   torch.ones_like(adaptive))
            return ((g32 + wd * p32) * adaptive).to(g.dtype)

        return tree_map(leaf, grads, params), count


class LARC:
    """Wrap a port optimizer with LARC (JAX's ``LARC(inner, ...)``): each
    ``step`` rescales every param's ``.grad`` by :class:`larc_transform`
    and then runs ``inner.step``. ``step(found_inf=flag)`` hands amp's
    flag on and keeps LARC's own count where it is set."""

    def __init__(self, inner: torch.optim.Optimizer,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 lr: Optional[Schedule] = None):
        self.optim = inner
        self.transform = larc_transform(trust_coefficient, clip, eps,
                                        weight_decay, lr)
        self.count = None

    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def state(self):
        return self.optim.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optim.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None, *, found_inf=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.optim.param_groups for p in g["params"]
                  if p.grad is not None]
        if params:
            if self.count is None:
                self.count = self.transform.init(params)
            new, count = self.transform.update([p.grad for p in params],
                                               self.count, params)
            for p, g in zip(params, new):
                p.grad = g
            box = {"step": self.count}
            advance_count(box, count, skip_flag(found_inf))
            self.count = box["step"]
        if found_inf is None:
            self.optim.step()
        else:
            self.optim.step(found_inf=found_inf)
        return loss
