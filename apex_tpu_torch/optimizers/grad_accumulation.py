"""fp32 main-grad accumulation across microbatches (counterpart of
``apex_tpu/optimizers/grad_accumulation.py``): each microbatch's gradients,
in the model's dtype, are cast and added into fp32 accumulators, so a half
-precision model never sums half-precision gradients."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from apex_tpu_torch.optimizers._common import (tree_leaves, tree_map,
                                               tree_unflatten)


def init_main_grads(params: Any) -> Any:
    """fp32 zero accumulators shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def accumulate_into_main_grads(main_grads: Any, grads: Any) -> Any:
    """``main + fp32(grad)`` leaf by leaf (new tensors, as JAX)."""
    return tree_map(lambda m, g: m + g.float(), main_grads, grads)


def accumulate_gradients(loss_fn: Callable[..., torch.Tensor], params: Any,
                         microbatches: Any, mean: bool = True
                         ) -> Tuple[torch.Tensor, Any]:
    """Run ``loss_fn(params, microbatch)`` over the microbatches (leaves
    with a leading microbatch axis), the gradients w.r.t. ``params`` (leaves
    that require grad) added into fp32 accumulators. Returns ``(loss,
    main_grads)``: the fp32 loss summed over microbatches (JAX's order:
    seeded from microbatch 0, the rest added in turn) and the fp32
    gradient tree; with ``mean`` both times 1/n."""
    leaves = tree_leaves(params)
    n_micro = tree_leaves(microbatches)[0].shape[0]

    def grad_fn(i):
        mb = tree_map(lambda x: x[i], microbatches)
        loss = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)

    loss0, grads0 = grad_fn(0)
    loss = loss0.float()
    main = tree_map(lambda g: g.float(), grads0)
    for i in range(1, n_micro):
        li, gi = grad_fn(i)
        main = accumulate_into_main_grads(main, gi)
        loss = loss + li.float()
    if mean:
        inv = 1.0 / n_micro
        loss = loss * inv
        main = tree_map(lambda g: g * inv, main)
    return loss, main
