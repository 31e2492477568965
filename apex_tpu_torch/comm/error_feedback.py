"""Error-feedback residual state for the compressed collectives
(counterpart of ``apex_tpu/comm/error_feedback.py``).

The residual is a tree shaped like the gradients (nested dicts, lists,
tuples, or one tensor), one fp32 leaf a gradient leaf, carried from step
to step like the loss-scaler state. :func:`state_dict` is JAX's flat
form — the leaves as numpy arrays keyed by their index in the tree order
(dict keys sorted) and the tree's structure as the string JAX's
``str(treedef)`` prints — so a residual saved by either package loads
into the other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from apex_tpu_torch.convert import tensor_from_numpy
from apex_tpu_torch.optimizers._common import (tree_leaves, tree_map,
                                               tree_unflatten)


def init_error_feedback(grads_template: Any) -> Any:
    """Zero residuals, one fp32 leaf per leaf of ``grads_template`` (the
    gradients or any tree shaped like them), on each leaf's device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        inner = ", ".join(_structure(t) for t in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def treedef_str(tree: Any) -> str:
    """The string JAX prints for the tree's ``PyTreeDef``."""
    return f"PyTreeDef({_structure(tree)})"


def state_dict(residual: Any) -> Dict[str, Any]:
    """``{"treedef": <JAX's string>, "leaves": {"0": array, ...}}``."""
    return {
        "treedef": treedef_str(residual),
        "leaves": {str(i): x.detach().cpu().numpy()
                   for i, x in enumerate(tree_leaves(residual))},
    }


def load_state_dict(residual_template: Any, d: Dict[str, Any]) -> Any:
    """Restore ``d`` (this package's or JAX's :func:`state_dict`) onto the
    live structure, each leaf on its template leaf's device and dtype;
    the stored structure, leaf count and shapes are checked."""
    leaves = tree_leaves(residual_template)
    live = treedef_str(residual_template)
    if d.get("treedef") is not None and d["treedef"] != live:
        raise ValueError(
            "error-feedback state does not match the live gradient "
            f"structure:\n  saved: {d['treedef']}\n  live:  {live}")
    if len(d["leaves"]) != len(leaves):
        raise ValueError(
            f"error-feedback state has {len(d['leaves'])} leaves, live "
            f"structure has {len(leaves)}")
    new = []
    for i, want in enumerate(leaves):
        got = np.asarray(d["leaves"][str(i)])
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"error-feedback leaf shape mismatch: saved {got.shape}, "
                f"live {tuple(want.shape)}")
        new.append(tensor_from_numpy(got, want.device, want.dtype))
    return tree_unflatten(residual_template, new)
