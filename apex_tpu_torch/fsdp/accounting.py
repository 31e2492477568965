"""FSDP byte accounting — HBM and wire models of the ZeRO ladder
(counterpart of ``apex_tpu/fsdp/accounting.py``; the numbers are JAX's).

Arithmetic on shapes only, under the ring model ``comm.accounting``
prices issued collectives with. :func:`hbm_params_bytes` models a chip's
parameter + gradient + optimizer-state bytes for each strategy:

``ddp``
    Everything replicated: model-dtype params and grads, fp32 Adam
    moments, and an fp32 master when the model dtype is narrower.
``zero1``
    ``DistributedFusedAdam``: params and grads replicated, fp32 master
    and moments sharded 1/dp.
``fsdp``
    Everything sharded: fp32 master and moment shards are the parameter
    store, grads arrive as fp32 shards; the transient gather working set
    (bounded by the largest leaf) is reported apart.

Activations are out of scope (no ZeRO stage changes them).
:func:`hbm_model_bytes` / :func:`hbm_serve_bytes` are the inference
siblings: params and KV cache, per serving residency strategy.

A tree here holds :class:`~apex_tpu_torch.fsdp.LeafMeta` leaves (shape and
JAX's dtype name) or tensors (``device="meta"`` tensors cost nothing).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from apex_tpu_torch.comm.collectives import (all_gather_wire_bytes,
                                             psum_scatter_wire_bytes)
from apex_tpu_torch.contrib.optimizers._sharding import shard_size
from apex_tpu_torch.optimizers._common import tree_leaves

Pytree = Any

STRATEGIES = ("ddp", "zero1", "fsdp")
# inference residency strategies; "single" is the unsharded baseline
SERVE_STRATEGIES = ("single", "tp", "pp", "fsdp")


def _leaf_meta(tree: Pytree):
    """``(elements, model itemsize)`` per leaf of a params or meta tree."""
    from apex_tpu_torch.fsdp.core import LeafMeta, dtype_of

    out = []
    for x in tree_leaves(tree):
        if isinstance(x, LeafMeta):
            out.append((x.size, dtype_of(x.dtype).itemsize))
        else:
            out.append((math.prod(x.shape), x.element_size()))
    return out


def _shard_elems(n: int, world: int, multiple: int) -> int:
    return shard_size(n, world, multiple)


def hbm_params_bytes(params_or_meta: Pytree, *, strategy: str, world: int,
                     shard_multiple: int = 1) -> Dict[str, float]:
    """Modeled per-chip param + grad + optimizer-state bytes of one
    strategy: ``{"params_bytes", "grads_bytes", "opt_state_bytes",
    "gather_workspace_bytes", "total"}`` (``total`` leaves out the
    transient gather workspace)."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    params = grads = opt = workspace = 0.0
    for n, isz in _leaf_meta(params_or_meta):
        k = _shard_elems(n, world, shard_multiple)
        if strategy == "ddp":
            params += n * isz
            grads += n * isz
            opt += n * 8  # fp32 mu + nu
            if isz < 4:
                opt += n * 4  # the amp fp32 master
        elif strategy == "zero1":
            params += n * isz
            grads += n * isz
            opt += k * 12  # fp32 master + mu + nu shards
        else:  # fsdp
            grads += k * 4  # fp32 shard grads off the reduce-scatter
            opt += k * 12  # fp32 master + mu + nu shards (the store)
            workspace = max(workspace, 2.0 * n * isz)
    return {
        "params_bytes": params,
        "grads_bytes": grads,
        "opt_state_bytes": opt,
        "gather_workspace_bytes": workspace,
        "total": params + grads + opt,
    }


def hbm_model_bytes(params_or_meta: Pytree) -> float:
    """Unsharded model-dtype parameter bytes."""
    return float(sum(n * isz for n, isz in _leaf_meta(params_or_meta)))


def hbm_serve_bytes(params_or_meta: Pytree, *, strategy: str, world: int,
                    kv_bytes: float = 0.0, num_layers: Optional[int] = None,
                    shard_multiple: int = 1) -> Dict[str, float]:
    """Modeled per-chip bytes of one serving residency strategy: params
    and this chip's KV pool (``kv_bytes``), no grads or optimizer state.
    A dict with a ``"layers"`` key (the GPT tree) has its stacked layer
    leaves modeled apart from the embed / head leaves, which ``pp`` and
    ``fsdp`` keep replicated; ``num_layers`` sizes fsdp's per-layer
    gather workspace. Returns ``{"params_bytes", "kv_bytes",
    "gather_workspace_bytes", "total"}``."""
    if strategy not in SERVE_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {SERVE_STRATEGIES}, got {strategy!r}")
    if isinstance(params_or_meta, dict) and "layers" in params_or_meta:
        layer_leaves = _leaf_meta(params_or_meta["layers"])
        other_leaves = _leaf_meta({k: v for k, v in params_or_meta.items()
                                   if k != "layers"})
    else:
        layer_leaves = _leaf_meta(params_or_meta)
        other_leaves = []
    layers_total = sum(n * isz for n, isz in layer_leaves)
    other_total = sum(n * isz for n, isz in other_leaves)
    workspace = 0.0
    if strategy == "single":
        params = layers_total + other_total
    elif strategy == "tp":
        params = (layers_total + other_total) / world
    elif strategy == "pp":
        params = layers_total / world + other_total
    else:  # fsdp
        params = other_total
        for n, isz in layer_leaves:
            params += _shard_elems(n, world, shard_multiple) * isz
            per_layer = n * isz / (num_layers or 1)
            workspace = max(workspace, 2.0 * per_layer)
    return {
        "params_bytes": params,
        "kv_bytes": float(kv_bytes),
        "gather_workspace_bytes": workspace,
        "total": params + float(kv_bytes),
    }


def hbm_reduction(params_or_meta: Pytree, *, world: int,
                  baseline: str = "ddp", shard_multiple: int = 1) -> float:
    """``baseline total / fsdp total``."""
    base = hbm_params_bytes(params_or_meta, strategy=baseline, world=world,
                            shard_multiple=shard_multiple)["total"]
    ours = hbm_params_bytes(params_or_meta, strategy="fsdp", world=world,
                            shard_multiple=shard_multiple)["total"]
    return base / ours if ours else float("inf")


def param_gather_wire_bytes(meta: Pytree, world: int, weight_gather=None,
                            shard_multiple: int = 1) -> float:
    """Modeled wire bytes a device of one full parameter gather: per leaf
    the tiled all-gather of the model-dtype shards, or with a codec the
    packed codes and fp32 scales, each ``result · (W-1)/W``."""
    total = 0.0
    for n, isz in _leaf_meta(meta):
        if world <= 1:
            continue
        k = _shard_elems(n, world, shard_multiple)
        if weight_gather is not None and weight_gather.compresses(n):
            total += (weight_gather.payload_bytes(k * world)
                      * (world - 1) / world)
        else:
            total += all_gather_wire_bytes(k * world, isz, world)
    return total


def fsdp_step_wire_bytes(meta: Pytree, world: int,
                         compression: Optional[Any] = None,
                         weight_gather: Optional[Any] = None,
                         shard_multiple: int = 1,
                         remat_gathers: int = 1) -> float:
    """One step's wire: ``remat_gathers`` parameter gathers and the fp32
    (or compressed) gradient reduce-scatter."""
    total = param_gather_wire_bytes(
        meta, world, weight_gather, shard_multiple) * max(1, remat_gathers)
    for n, _ in _leaf_meta(meta):
        total += psum_scatter_wire_bytes(n, 4, world, compression,
                                         shard_multiple)
    return total

