"""Tree helpers of the legacy fp16 flow (counterpart of
``apex_tpu/fp16_utils/fp16util.py``): a "model" is a tree of tensors
(dicts, lists, tuples); norm params are found by amp's path predicate;
master and model params are two trees related by a cast."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from apex_tpu_torch.amp.frontend import (_is_float, _map_with_path,
                                         default_norm_predicate)
from apex_tpu_torch.optimizers._common import tree_leaves, tree_map


def convert_network(params: Any, dtype: torch.dtype,
                    is_norm_param: Callable[[str], bool] =
                    default_norm_predicate) -> Any:
    """Float leaves cast to ``dtype``, norm params to fp32 (JAX's
    ``convert_network``); other leaves as they are."""

    def leaf(path, x):
        if not _is_float(x):
            return x
        return x.to(torch.float32 if is_norm_param(path) else dtype)

    return _map_with_path(leaf, params)


def network_to_half(params: Any, half_dtype: torch.dtype = torch.bfloat16
                    ) -> Any:
    """:func:`convert_network` to ``half_dtype`` (JAX's default bf16; pass
    ``torch.float16`` for Apex's)."""
    return convert_network(params, half_dtype)


def _flat(tree: Any) -> torch.Tensor:
    leaves = [x.reshape(-1) for x in tree_leaves(tree)]
    return torch.cat(leaves) if leaves else torch.zeros(0)


def prep_param_lists(params: Any, flat_master: bool = False):
    """``(model_params, master_params)``: fp32 copies of the float leaves
    (detached, new tensors); ``flat_master`` concatenates them into one
    fp32 vector."""
    masters = tree_map(lambda x: (x.detach().to(torch.float32, copy=True)
                                  if _is_float(x) else x), params)
    return params, (_flat(masters) if flat_master else masters)


def model_grads_to_master_grads(model_grads: Any,
                                flat_master: bool = False) -> Any:
    """Half gradients to fp32 (one vector with ``flat_master``)."""
    g32 = tree_map(lambda g: g.to(torch.float32), model_grads)
    return _flat(g32) if flat_master else g32


def master_params_to_model_params(master_params: Any, model_like: Any
                                  ) -> Any:
    """The fp32 masters cast to the dtypes of ``model_like``'s leaves."""
    return tree_map(lambda m, p: m.detach().to(p.dtype), master_params,
                    model_like)


def clip_grad_norm(grads: Any, max_norm: float, norm_type: float = 2.0
                   ) -> Tuple[Any, torch.Tensor]:
    """``(clipped_grads, total_norm)``: each leaf times ``min(1, max_norm
    / (total + 1e-6))`` in fp32, back in its type (torch's rule, as JAX's
    ``clip_grad_norm``); the norm a 0-d fp32 device tensor (no host
    read)."""
    leaves = tree_leaves(grads)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().to(torch.float32)
                             for g in leaves]).max()
    elif norm_type == 2.0:
        total = sum(g.to(torch.float32).square().sum() for g in leaves)
        total = total.sqrt()
    else:
        total = sum((g.to(torch.float32).abs() ** norm_type).sum()
                    for g in leaves) ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * coef).to(g.dtype),
                    grads), total


def to_python_float(t) -> float:
    return float(t)
