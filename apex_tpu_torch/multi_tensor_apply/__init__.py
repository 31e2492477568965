"""multi_tensor_apply (counterpart of ``apex_tpu/multi_tensor_apply``): the
call shape of the reference's ``multi_tensor_applier`` over trees of
tensors. ``op`` runs per leaf; the "noop flag" becomes a returned fp32
0/1 over every input leaf (the overflow contract of
``multi_tensor_scale``), computed on the device."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.optimizers._common import tree_leaves, tree_map


class MultiTensorApply:
    """``applier = MultiTensorApply(2048*32); applier(op, noop_flag,
    lists)``; the chunk size is taken and not used, as in JAX."""

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op: Callable, noop_flag_or_none: Optional[Any],
                 tensor_lists, *args):
        """``op(*leaves, *args)`` over the zipped trees of
        ``tensor_lists`` -> ``(results, found_inf)``, found_inf a 0-d fp32
        0/1: 1 where any input leaf holds an inf or a NaN."""
        outs = tree_map(lambda *ls: op(*ls, *args), *tensor_lists)
        leaves = [x for t in tensor_lists for x in tree_leaves(t)]
        if leaves:
            finite = torch.stack([torch.isfinite(x).all()
                                  for x in leaves]).all()
        else:
            finite = torch.ones((), dtype=torch.bool)
        return outs, (~finite).to(torch.float32)


multi_tensor_applier = MultiTensorApply()

__all__ = ["MultiTensorApply", "multi_tensor_applier"]
