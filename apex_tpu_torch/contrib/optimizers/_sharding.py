"""Per-leaf shard plumbing for dp-sharded optimizer state (counterpart of
``apex_tpu/contrib/optimizers/_sharding.py``).

The ZeRO dataflow, one leaf at a time, over the mesh's ``dp`` process
group:

* **reduce-scatter** the flattened gradient leaf (``comm.collectives``'
  wrapper, so ``comm.accounting`` records it): each rank receives the
  dp-summed fp32 shard it owns, ``shard_size(n, W, multiple)`` elements;
* the optimizer's fp32 math runs on that shard only (the Adam tail of
  ``ops.fused_update``: one kernel per shard leaf on the card);
* **all-gather** the updated shard back into the full parameter.

Layout is JAX's: a leaf is flattened, zero-padded to ``k·W`` and rank i
owns elements ``[i·k, (i+1)·k)``. ``k`` is rounded up to ``multiple`` (a
codec's block size), so no fp32 scale block straddles two ranks.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from apex_tpu_torch.comm.collectives import all_gather, all_reduce, \
    reduce_scatter
from apex_tpu_torch.ops.fused_update import (adam_tail_reference,
                                             fused_adam_tail)
from apex_tpu_torch.optimizers._common import tree_leaves
from apex_tpu_torch.parallel.mesh import resolve_axis

Pytree = Any


def shard_multiple(compression) -> int:
    """Shard-size alignment for a (possibly ``None``)
    ``CompressionConfig``: its block size when it compresses, else 1."""
    if compression is not None and compression.enabled:
        return compression.block_size
    return 1


def shard_multiple_lcm(*compressions) -> int:
    """lcm of several codecs' alignments (FSDP's gradient and weight-gather
    wires share one shard layout)."""
    m = 1
    for c in compressions:
        m = math.lcm(m, shard_multiple(c))
    return m


def shard_size(n: int, world: int, multiple: int = 1) -> int:
    """``ceil(n / world)`` rounded up to ``multiple``."""
    k = (n + world - 1) // world
    return -(-k // multiple) * multiple


def local_sq(tree: Pytree) -> torch.Tensor:
    """Σ x² over every leaf, leaf by leaf in tree order from an fp32 0 (a
    0-d fp32 tensor on the leaves' device): the local half of a sharded
    global norm."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device if leaves else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    return total


def global_norm_shards(tree: Pytree, axis_name: str) -> torch.Tensor:
    """Global L2 norm of dp-sharded leaves: the local Σx² and one
    all-reduce over ``axis_name``."""
    group, world, _ = resolve_axis(axis_name)
    return torch.sqrt(all_reduce(local_sq(tree), group, world,
                                 tag="global_norm_shards"))


def adam_shard_update(g, m, v, p32, c1, c2, *, lr, betas, eps,
                      weight_decay: float = 0.0, adam_w_mode: bool = True,
                      use_fused: bool = False, corr=None):
    """The per-(shard-)leaf Adam tail shared by ``DistributedFusedAdam``
    (ZeRO-1) and ``fsdp.FSDPAdam``: the same operations, so the two give
    the same bits from the same shard gradients. ``use_fused`` runs
    :func:`~apex_tpu_torch.ops.fused_update.fused_adam_tail` (the kernel
    on a CUDA shard, which updates ``m`` and ``v`` in place), else JAX's
    op chain into new moments. ``corr`` (c1, c2 as a 2-element fp32
    tensor on the shard's device) replaces the host ``c1``/``c2``.
    Returns ``(p32 - lr·u, m', v')``."""
    kw = dict(betas=betas, eps=eps, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, corr=corr)
    if use_fused:
        u, m_new, v_new = fused_adam_tail(g, m, v, p32, c1, c2, **kw)
    else:
        u, m_new, v_new = adam_tail_reference(g, m, v, p32, c1, c2, **kw)
    return p32 - lr * u, m_new, v_new


def _padded_flat(x: torch.Tensor, world: int, multiple: int):
    flat = x.reshape(-1)
    k = shard_size(flat.numel(), world, multiple)
    pad = k * world - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, k


def scatter_leaf(x: torch.Tensor, axis_name: str,
                 multiple: int = 1) -> torch.Tensor:
    """Flatten, pad to ``k·W`` and reduce-scatter: ``(shape)`` → this
    rank's summed ``(k,)`` shard."""
    group, world, _ = resolve_axis(axis_name)
    flat, _ = _padded_flat(x, world, multiple)
    return reduce_scatter(flat, group, world, tag="scatter_leaf")


def slice_leaf(x: torch.Tensor, axis_name: str,
               multiple: int = 1) -> torch.Tensor:
    """This rank's ``(k,)`` shard of a replicated leaf, no collective (a
    tensor of its own)."""
    _, world, rank = resolve_axis(axis_name)
    flat, k = _padded_flat(x, world, multiple)
    return flat[rank * k:(rank + 1) * k].clone()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A shard as bytes for the all-gather (bitwise; ``gloo`` has no fp8
    type)."""
    return t.contiguous().view(torch.uint8)


def gather_leaf(shard: torch.Tensor, shape, dtype: torch.dtype,
                axis_name: str,
                transport_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """All-gather, unpad, reshape and cast: ``(k,)`` → ``shape`` in
    ``dtype``. ``transport_dtype`` narrows the wire (JAX's double
    rounding): the shard clipped in fp32 to the transport type's largest
    value, rounded to the model ``dtype``, then to ``transport_dtype``; the
    bytes travel as a ``uint8`` view."""
    group, world, _ = resolve_axis(axis_name)
    if transport_dtype is not None:
        lim = float(torch.finfo(transport_dtype).max)
        shard = torch.clamp(shard.float(), -lim, lim)
        shard = shard.to(dtype).to(transport_dtype)
    wire_type = shard.dtype
    full = all_gather(_wire(shard), group, world,
                      tag="gather_leaf").view(wire_type)
    n = math.prod(shape)
    return full[:n].reshape(tuple(shape)).to(dtype)
