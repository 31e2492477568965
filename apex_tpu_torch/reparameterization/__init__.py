"""Weight normalization over the port's param trees (counterpart of
``apex_tpu/reparameterization``): :func:`apply_weight_norm` splits each
selected weight into ``{"wn_g": g, "wn_v": v}`` with g = ||v|| (fp32
norm over every dim but ``dim``, kept with a 1 there, cast to v's type);
:func:`remove_weight_norm` recomposes w = g · v / (||v|| + 1e-12) in
fp32, cast to v's type — call it inside the forward so the norm follows
v each step (the reference's pre-hook). Paths are ``amp.frontend``'s
(``a/b/c``)."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

Tree = Any
_EPS = 1e-12


def _norm_except(v: torch.Tensor, dim: int) -> torch.Tensor:
    d = dim % v.dim()
    axes = tuple(a for a in range(v.dim()) if a != d)
    return torch.sqrt(torch.sum(torch.square(v.float()), dim=axes,
                                keepdim=True))


def _map(fn, tree, prefix: str = ""):
    if isinstance(tree, dict) and not _is_wn(tree):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _is_wn(x) -> bool:
    return isinstance(x, dict) and set(x) == {"wn_g", "wn_v"}


def apply_weight_norm(params: Tree, name_filter: Optional[Callable] = None,
                      dim: int = 0) -> Tree:
    """``{"wn_g", "wn_v"}`` in place of each leaf ``name_filter(path)``
    selects (default: every float tensor with ndim >= 2); ``wn_v`` is the
    weight itself."""

    def leaf(path, x):
        sel = (name_filter(path) if name_filter is not None
               else torch.is_tensor(x) and x.dim() >= 2
               and x.is_floating_point())
        if not sel:
            return x
        return {"wn_g": _norm_except(x, dim).to(x.dtype), "wn_v": x}

    return _map(leaf, params)


def remove_weight_norm(params: Tree, dim: int = 0) -> Tree:
    """w = g · v / (||v|| + 1e-12) for each ``{"wn_g", "wn_v"}`` (the
    inverse of :func:`apply_weight_norm`); differentiable in g and v."""

    def leaf(_, x):
        if not _is_wn(x):
            return x
        v = x["wn_v"]
        return (x["wn_g"].float() * v.float()
                / (_norm_except(v, dim) + _EPS)).to(v.dtype)

    return _map(leaf, params)
