"""ASP — mask bookkeeping and the pruned optimizer step (counterpart of
``apex_tpu/contrib/sparsity/asp.py``).

Masks are a tree parallel to the params (nested dicts of tensors, the
port's param trees: GPT's stacked layers and per-head-interleaved QKV
kept, so masks computed on a converted tree equal JAX's), ``None`` where
a leaf is not pruned. JAX wraps the optax transform so that its update is
masked: a step adds ``where(mask, u, 0)``, so it never writes a pruned
slot. The port's optimizers update their params in place, so
:meth:`ASP.init_optimizer_for_pruning` wraps one so that each step puts
the pruned slots back to what they held before it: the same ``p + 0``
there, bit for bit, whatever the optimizer (the moments see the whole
gradient, as optax's state does).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from apex_tpu_torch.contrib.sparsity.sparse_masklib import create_mask

Tree = Any


def _path_map(fn, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a nested dict of tensors,
    paths as ``amp.frontend``'s (``a/b/c``); ``None`` leaves of a rest
    tree come through as ``None``."""
    if isinstance(tree, dict):
        return {k: _path_map(fn, v, *(r[k] for r in rest),
                             prefix=f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree, *rest)


def _default_whitelist(path: str, x) -> bool:
    """JAX's whitelist: float tensors with ndim >= 2 and a last dim
    divisible by 4 (the weight matrices of linear and conv layers, and
    whatever else has that shape)."""
    return (torch.is_tensor(x) and x.dim() >= 2 and x.is_floating_point()
            and x.shape[-1] % 4 == 0)


class ASP:
    """JAX's functional ASP surface: ``compute_sparse_masks``,
    ``apply_masks``, ``init_optimizer_for_pruning`` and
    ``restore_pruned_weights``."""

    def __init__(self, mask_calculator: str = "m4n2_1d",
                 whitelist: Callable[[str, Any], bool] = _default_whitelist,
                 allow_permutation: bool = False,
                 permutation_escape_attempts: int = 10):
        self.pattern = mask_calculator
        self.whitelist = whitelist
        self.allow_permutation = allow_permutation
        self.permutation_escape_attempts = permutation_escape_attempts
        if allow_permutation and mask_calculator != "m4n2_1d":
            raise ValueError(
                f"channel-permutation search assumes 2:4 groups (m4n2_1d); "
                f"got mask_calculator={mask_calculator!r}")

    def compute_sparse_masks(self, params: Tree) -> Tree:
        """The mask tree: a bool keep-mask (on the leaf's device) for each
        whitelisted leaf, ``None`` elsewhere. With ``allow_permutation``
        each whitelisted leaf's input channels are permuted by the greedy
        search (``permutation.permute_and_mask``, on the host) before
        pruning and the mask mapped back."""

        def leaf(path, x):
            if not self.whitelist(path, x):
                return None
            if self.allow_permutation:
                from apex_tpu_torch.contrib.sparsity.permutation import (
                    permute_and_mask,
                )

                mask, _, _, _ = permute_and_mask(
                    x, self.permutation_escape_attempts)
                return torch.from_numpy(mask).to(x.device)
            return create_mask(x, self.pattern)

        return _path_map(leaf, params)

    @staticmethod
    def apply_masks(params: Tree, masks: Tree, in_place: bool = False
                    ) -> Tree:
        """The params with pruned weights zeroed: new tensors, or with
        ``in_place`` the params' own (returned)."""

        def leaf(_, p, m):
            if m is None:
                return p
            if in_place:
                return p.masked_fill_(~m, 0)
            return torch.where(m, p, torch.zeros((), dtype=p.dtype,
                                                 device=p.device))

        return _path_map(leaf, params, masks)

    def init_optimizer_for_pruning(self, optimizer: torch.optim.Optimizer,
                                   masks: Tree, params: Tree
                                   ) -> "MaskedOptimizer":
        """Wrap a port optimizer over (some of) ``params``' leaves so that
        its step leaves every pruned slot as it was (JAX masks optax's
        update); ``masks`` as :meth:`compute_sparse_masks` gave them for
        ``params``."""
        pairs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        _path_map(lambda _, p, m: pairs.append((p, m)) if m is not None
                  else None, params, masks)
        return MaskedOptimizer(optimizer, pairs)

    @staticmethod
    def restore_pruned_weights(params: Tree, dense_params: Tree,
                               in_place: bool = False) -> Tree:
        """The dense copy back (JAX returns ``dense_params``'s leaves);
        with ``in_place`` copied into the params' own tensors."""
        if in_place:
            return _path_map(lambda _, p, d: p.copy_(d), params, dense_params)
        return _path_map(lambda _, p, d: d, params, dense_params)


class MaskedOptimizer:
    """A port optimizer whose ``step`` keeps the pruned slots of its
    masked params: before the step each masked leaf is copied, after it
    the pruned slots are put back (``torch.where``, on the leaf's device,
    no host read). Everything else is the optimizer's own."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 pairs: List[Tuple[torch.Tensor, torch.Tensor]]):
        owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
        self.optimizer = optimizer
        self.pairs = [(p, m) for p, m in pairs if id(p) in owned]

    @torch.no_grad()
    def step(self, *args, **kwargs):
        before = [p.clone() for p, _ in self.pairs]
        out = self.optimizer.step(*args, **kwargs)
        for (p, m), old in zip(self.pairs, before):
            p.copy_(torch.where(m, p, old))
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

