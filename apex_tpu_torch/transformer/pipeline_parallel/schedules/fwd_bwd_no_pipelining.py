"""No-pipelining schedule: a gradient-accumulation microbatch loop
(counterpart of ``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_no_pipelining.py``).

Reference: ``fwd_bwd_no_pipelining.py:31-95`` runs all-but-last
microbatches inside ``model.no_sync()`` and accumulates gradients. JAX
scans ``jax.value_and_grad`` over the microbatches; here each microbatch
runs forward and backward (``torch.autograd.grad``, so its graph is freed
before the next) and the gradients are summed on the device. The data
parallel reduction happens once, wherever the caller's DP wrapper puts
it.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Tuple

import torch

from apex_tpu_torch.monitor.trace import span
from apex_tpu_torch.optimizers._common import tree_unflatten
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    derive_microbatch_keys,
    microbatch,
    split_microbatches,
    trainable_leaves,
)

Pytree = Any

_ARITY_HINT = (
    "dropout_key given but forward_step_func does not accept a third "
    "per-microbatch key argument (params, microbatch, key)")


def _check_arity(forward_step_func) -> None:
    """Fail before running when a step function cannot take the key."""
    try:
        sig = inspect.signature(forward_step_func)
    except (TypeError, ValueError):
        return  # uninspectable (a C callable): let it through
    try:
        sig.bind(object(), object(), object())
    except TypeError:
        raise ValueError(_ARITY_HINT) from None


def _call(forward_step_func, p, m, key):
    """The step function on one microbatch. A ``(*args, **kwargs)``
    wrapper over a 2-argument function binds the 3-argument signature and
    dies in the call: on a TypeError the 2-argument call is probed, and
    only if it succeeds is the arity hint raised (a correct 3-argument
    function whose body raised keeps its own error)."""
    if key is None:
        return forward_step_func(p, m)
    try:
        return forward_step_func(p, m, key)
    except TypeError as e:
        try:
            forward_step_func(p, m)
        except Exception:
            raise e from None
        raise ValueError(f"{_ARITY_HINT} (original error: {e})") from e


def forward_backward_no_pipelining(
    forward_step_func: Callable[..., torch.Tensor],
    batch: Pytree,
    params: Pytree,
    *,
    num_microbatches: int,
    loss_scale=None,
    dropout_key=None,
) -> Tuple[torch.Tensor, Pytree]:
    """Returns ``(mean_unscaled_loss, grads)``: the mean of the
    microbatches' losses (detached, on the device) and the gradients of
    ``loss * loss_scale / num_microbatches`` summed over microbatches (ref
    common.py:226-256), a tree shaped like ``params``, whose leaves are
    made trainable here.

    ``forward_step_func(params, microbatch) -> scalar loss``; with
    ``dropout_key`` (a threefry key) it is called
    ``forward_step_func(params, microbatch, key)`` with the microbatch's
    key ``fold_in(dropout_key, m)``. Each microbatch runs under a
    ``fwd_bwd`` span."""
    mb = split_microbatches(batch, num_microbatches)
    scale = 1.0 if loss_scale is None else loss_scale
    if dropout_key is not None:
        _check_arity(forward_step_func)
    keys_mb = derive_microbatch_keys(dropout_key, num_microbatches)
    leaves = trainable_leaves(params)
    loss_sum, grads = None, None
    for m in range(num_microbatches):
        key = None if keys_mb is None else keys_mb[m]
        with span("fwd_bwd"):
            loss = _call(forward_step_func, params, microbatch(mb, m), key)
            g = torch.autograd.grad(loss * scale / num_microbatches, leaves,
                                    allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(leaves, g)]
        loss = loss.detach()
        if grads is None:
            loss_sum, grads = loss, g
        else:
            loss_sum = loss_sum + loss
            grads = [a + b for a, b in zip(grads, g)]
    return loss_sum / num_microbatches, tree_unflatten(params, grads)
