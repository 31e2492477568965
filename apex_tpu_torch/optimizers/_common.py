"""Shared pieces of the port's optimizers (counterpart of
``apex_tpu/optimizers/_common.py``): the learning-rate schedule type, the
tree helpers over nested dicts / lists of tensors, ``global_norm`` and
``apply_updates``, and the device-side step count and overflow guard that
keep an optimizer step free of host reads (JAX's count is a device int32;
amp's skip decision stays on the device).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch

# a constant learning rate, or a function of the 1-based step count (an
# int, or a 0-d int32 tensor where the count lives on the device)
Schedule = Union[float, Callable[[Any], Any]]


def value_at(lr: Schedule, count):
    """The learning rate at step ``count`` (1 for the first update): a
    float for a host count, or what ``lr(count)`` gives for a device count
    (no host read), as JAX's ``value_at``."""
    if torch.is_tensor(count):
        return lr(count) if callable(lr) else float(lr)
    return float(lr(count)) if callable(lr) else float(lr)


# ---------------------------------------------------------------------------
# trees: nested dicts (sorted keys, the JAX tree order), lists and tuples


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple in JAX's order (dict keys
    sorted); ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the zipped leaves of trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves`' order (dict keys sorted)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf, in fp32 (JAX's ``global_norm``: the sum of
    each leaf's sum of squares, leaf by leaf, then the square root)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = None
    for g in leaves:
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(params, updates):
    """params + updates leaf by leaf, the sum in fp32 and rounded to each
    param's dtype (masters stay fp32), as JAX's ``apply_updates``."""
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


# ---------------------------------------------------------------------------
# the device step count and the overflow guard


def device_count(group: dict, device: torch.device) -> torch.Tensor:
    """``group["step"]`` as a 0-d int32 tensor on ``device`` (made from a
    host int once, with a fill: no copy from the host)."""
    step = group["step"]
    if not torch.is_tensor(step):
        step = torch.full((), int(step), dtype=torch.int32, device=device)
        group["step"] = step
    return step


def advance_count(group: dict, count: torch.Tensor,
                  skip: Optional[torch.Tensor]) -> None:
    """Store the new count: ``count`` (the old one + 1), or the old one
    where ``skip`` is set (``count - skip``), on the device."""
    group["step"] = count if skip is None else count - skip.to(torch.int32)


def skip_flag(found_inf) -> Optional[torch.Tensor]:
    """amp's ``found_inf`` (a 0-d fp32 0/1 or bool tensor, or None) as a
    0-d bool tensor, or None."""
    return None if found_inf is None else found_inf != 0


def guarded(skip: Optional[torch.Tensor], new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """``old`` where ``skip`` is set, else ``new`` (JAX's where-guard)."""
    return new if skip is None else torch.where(skip, old, new)


class DeviceStepOptimizer(torch.optim.Optimizer):
    """Base of the port's plain-op optimizers (SGD, Adagrad, NovoGrad,
    LAMB): JAX's update math in JAX's op order, fp32 state, the update
    rounded to each param's dtype and added in fp32 (``apply_updates``).
    ``group["step"]`` is JAX's count, a 0-d int32 tensor on the params'
    device. ``step(found_inf=flag)`` (amp's overflow flag, 0-d on the
    device) keeps every param, every state tensor and the count as they
    were where the flag is set, with ``torch.where``: no host read."""

    def _leaf(self, group, p, count, old_count, lr, skip) -> None:
        raise NotImplementedError

    def _begin_step(self) -> None:
        """Work over every gradient before the per-leaf updates."""

    @staticmethod
    def _apply(p: torch.Tensor, upd: torch.Tensor, skip) -> None:
        """p <- p + upd (upd already in p's dtype), the sum in fp32, or p
        itself where ``skip`` is set."""
        new = (p.float() + upd.float()).to(p.dtype)
        p.copy_(guarded(skip, new, p))

    def _state(self, p: torch.Tensor, **zeros) -> dict:
        """The param's state, its entries made on first use: ``name=shape``
        (None: the param's shape) fp32 zeros on the param's device."""
        state = self.state[p]
        for name, shape in zeros.items():
            if name not in state:
                state[name] = torch.zeros(
                    p.shape if shape is None else shape,
                    dtype=torch.float32, device=p.device)
        return state

    @torch.no_grad()
    def step(self, closure=None, *, found_inf=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        skip = skip_flag(found_inf)
        self._begin_step()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            old = device_count(group, params[0].device)
            count = old + 1
            lr = value_at(group["lr"], count)
            for p in params:
                self._leaf(group, p, count, old, lr, skip)
            advance_count(group, count, skip)
        return loss
