"""Parameter trees from numpy: the JAX package's param pytree, taken out as
numpy arrays (``jax.tree.map(np.asarray, params)``), becomes the port's
dict of torch tensors with the same keys, shapes and layout (stacked
layers, per-head interleaved QKV), so weights carry across one to one.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from apex_tpu_torch._device import DeviceLike, resolve_device


def tensor_from_numpy(a, device: torch.device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array -> tensor on ``device``. A bfloat16 array (numpy dtype
    named ``bfloat16``, which ``torch.from_numpy`` refuses) is moved as its
    raw 16-bit patterns and viewed back as ``torch.bfloat16``: exact."""
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a JAX array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (default ``cuda``; raises without one unless ``device="cpu"``).
    ``dtype`` casts every floating leaf when given."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev, dtype)

    return conv(tree)
