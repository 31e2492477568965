"""N:M structured sparsity masks (counterpart of
``apex_tpu/contrib/sparsity/sparse_masklib.py``).

``create_mask`` keeps, in every group of ``m`` consecutive elements along
the last dim, the ``n`` largest magnitudes. JAX ranks each group by two
``jnp.argsort``s, which are stable, so of equal magnitudes (zeros, and
the repeated values a bf16 tensor is full of) the later ones are kept;
the port ranks with ``stable=True`` and keeps the same ones. The
magnitudes are taken in the tensor's own type, as JAX takes them. Plain
tensor code on any device: a top-2 of four needs no kernel.
"""

from __future__ import annotations

import re

import torch


def _parse_pattern(pattern: str):
    m = re.fullmatch(r"m(\d+)n(\d+)_(1|2)d", pattern)
    if not m:
        raise ValueError(
            f"unknown sparsity pattern {pattern!r} (expected e.g. 'm4n2_1d')")
    return int(m.group(1)), int(m.group(2)), m.group(3)


def create_mask(tensor: torch.Tensor, pattern: str = "m4n2_1d"
                ) -> torch.Tensor:
    """Boolean keep-mask of ``tensor``'s shape and device: in every group
    of ``m`` consecutive elements along the last dim, the ``n`` largest
    magnitudes (ties to the later element). ``_2d`` applies the same rule,
    as JAX's does."""
    m, n, _dims = _parse_pattern(pattern)
    shape = tensor.shape
    if shape[-1] % m != 0:
        raise ValueError(f"last dim {shape[-1]} not divisible by group {m}")
    g = tensor.abs().reshape(*shape[:-1], shape[-1] // m, m)
    order = torch.argsort(g, dim=-1, stable=True)          # ascending
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks >= (m - n)).reshape(shape)
