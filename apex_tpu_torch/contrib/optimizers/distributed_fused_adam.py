"""ZeRO-style Adam with dp-sharded optimizer state (counterpart of
``apex_tpu/contrib/optimizers/distributed_fused_adam.py``; reference
``apex/contrib/optimizers/distributed_fused_adam.py``).

JAX's functional surface: ``state = opt.init(params)`` (fp32 master and
moment shards, ``(k,)`` a leaf), ``params, state = opt.step(grads, state,
params)``. A step is, leaf by leaf over the ``dp`` axis of the current
mesh: the gradient's reduce-scatter (fp32, or the quantized
``comm.collectives.compressed_psum_scatter`` with error feedback), the
average (and AMP unscale, global-norm clip), the Adam tail on the shard
(``_sharding.adam_shard_update``: one ``fused_adam_tail`` kernel a shard
on the card), and the all-gather of the updated shard back into the
parameter (optionally as e5m2 bytes). c1 and c2 are computed on the
device from the device step count, so a step makes no host read.

The checkpoint surface (``state_dict``, ``load_state_dict``,
``elastic_spec``, ``elastic_comm_spec``) sits on JAX's resilience
package: ROADMAP A8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.comm.collectives import (CompressionConfig, all_reduce,
                                             all_gather_wire_bytes,
                                             compressed_psum_scatter,
                                             fold_seed,
                                             psum_scatter_wire_bytes)
from apex_tpu_torch.comm.error_feedback import init_error_feedback
from apex_tpu_torch.contrib.optimizers._sharding import (
    adam_shard_update,
    gather_leaf,
    global_norm_shards,
    local_sq,
    scatter_leaf,
    shard_multiple,
    shard_size,
    slice_leaf,
)
from apex_tpu_torch.ops.fused_update import resolve_fused
from apex_tpu_torch.optimizers._common import (tree_leaves, tree_map,
                                               tree_unflatten)
from apex_tpu_torch.parallel.mesh import DP_AXIS, resolve_axis

Pytree = Any

# JAX's private names for the helpers that moved to ``_sharding``
_shard_multiple = shard_multiple
_local_sq = local_sq
_global_norm_shards = global_norm_shards

CHECKPOINT_REFUSAL = (
    "{what}: the sharded checkpoint surface sits on the resilience "
    "package (checkpoint manifests, elastic resharding), which the port "
    "has not ported yet: ROADMAP A8")


def refuse_checkpoint(what: str):
    raise NotImplementedError(CHECKPOINT_REFUSAL.format(what=what))


def _reduce_grad_leaf(g, axis_name, compression, residual, seed):
    """One leaf's gradient reduce-scatter, the quantized wire when
    configured: ``(fp32 summed shard, new residual or None)``, under the
    ``comm`` span."""
    from apex_tpu_torch.monitor.trace import span

    with span("comm"):
        if compression is not None and compression.enabled:
            return compressed_psum_scatter(
                g.reshape(-1).float(), axis_name, compression,
                residual=residual, seed=seed,
                shard_multiple=compression.block_size)
        return scatter_leaf(g.float(), axis_name), residual


def _reduce_grads(grads, comm_state, axis_name, compression, seed,
                  scale=None):
    """Every leaf's reduce-scatter in tree order: leaf i's seed
    ``fold_seed(seed, i)``; the EF residual carried unscaled (``r·scale``
    in, ``/scale`` out, so a scale change between steps cannot mis-scale
    it). Returns ``(shard tree, new comm state or None)``."""
    leaves = tree_leaves(grads)
    res = (tree_leaves(comm_state) if comm_state is not None
           else [None] * len(leaves))
    if len(res) != len(leaves):
        raise ValueError(
            f"comm_state has {len(res)} leaves, grads have {len(leaves)}")
    shards, new_res = [], []
    for i, (g, r) in enumerate(zip(leaves, res)):
        leaf_seed = None if seed is None else fold_seed(seed, i)
        r_in = r if (r is None or scale is None) else r * scale
        s, r2 = _reduce_grad_leaf(g, axis_name, compression, r_in,
                                  leaf_seed)
        if r2 is not None and scale is not None:
            r2 = r2 / scale
        shards.append(s)
        new_res.append(r2)
    g_shards = tree_unflatten(grads, shards)
    if comm_state is None:
        return g_shards, None
    return g_shards, tree_unflatten(comm_state, new_res)


def _update_norms(master, old_master, axis_name: str) -> torch.Tensor:
    """``(‖master‖, ‖master - old_master‖)`` over dp: the two local Σx²
    in one stacked all-reduce."""
    delta = tree_map(lambda a, b: a - b, master, old_master)
    group, size, _ = resolve_axis(axis_name)
    return torch.sqrt(all_reduce(
        torch.stack([_local_sq(master), _local_sq(delta)]), group, size,
        tag="update_norms"))


def _record_zero_metrics(metrics, gnorm, master, old_master, grads,
                         world: int, compression, e5m2_allgather: bool,
                         axis_name: str):
    """The Adam / LAMB metrics tail: the shard norms and the modeled wire
    bytes."""
    both = _update_norms(master, old_master, axis_name)
    return metrics.record(
        grad_norm=gnorm,
        param_norm=both[0],
        update_norm=both[1],
        comm_wire_bytes=_zero_wire_bytes(
            grads, world, compression, e5m2_allgather=e5m2_allgather))


def _zero_wire_bytes(grads, world: int,
                     compression: Optional[CompressionConfig],
                     e5m2_allgather: bool = False) -> float:
    """Modeled wire bytes of one ZeRO step: the gradient reduce-scatter
    and the parameter all-gather of every leaf (ring model)."""
    mult = _shard_multiple(compression)
    gather_item = 1 if e5m2_allgather else 4
    total = 0.0
    for g in tree_leaves(grads):
        n = g.numel()
        total += psum_scatter_wire_bytes(n, 4, world, compression, mult)
        k = shard_size(n, world, mult)
        total += all_gather_wire_bytes(k * world, gather_item, world)
    return total


def _bias_corrections(count: torch.Tensor, betas, enabled: bool = True):
    """``(1 - β1ᵗ, 1 - β2ᵗ)`` as a 2-element fp32 tensor on the count's
    device, from the device count (no copy from the host)."""
    if not enabled:
        return torch.ones(2, dtype=torch.float32, device=count.device)
    b1, b2 = betas
    b = torch.full((2,), b1, dtype=torch.float32, device=count.device)
    b[1:].fill_(b2)
    return 1.0 - torch.pow(b, count.float())


def _check_ef(compression, comm_state) -> None:
    if (compression is not None and compression.error_feedback
            and comm_state is None):
        raise ValueError(
            "compression policy 'int8_ef' carries state: pass "
            "comm_state=opt.init_comm_state(params) and thread the "
            "returned state")


def _scaled_shards(g_shards, world: int, scale, divide: bool = True):
    """The reduce-scatter's sums averaged over dp (``divide``) and the AMP
    scale divided out."""
    if divide:
        g_shards = tree_map(lambda g: g / world, g_shards)
    if scale is not None:
        g_shards = tree_map(lambda g: g / scale, g_shards)
    return g_shards


def _clip(g_shards, gnorm, max_grad_norm):
    """``g · min(1, max_grad_norm / (‖g‖ + 1e-6))``, divided on the
    device."""
    clip = torch.clamp(torch.full_like(gnorm, max_grad_norm)
                       / (gnorm + 1e-6), max=1.0)
    return tree_map(lambda g: g * clip, g_shards)


def _init_shards(params, axis_name, mult):
    master = tree_map(lambda p: slice_leaf(p.detach().float(), axis_name,
                                           multiple=mult), params)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return (torch.zeros((), dtype=torch.int32, device=dev), master,
            tree_map(torch.zeros_like, master),
            tree_map(torch.zeros_like, master))


def _gather_params(master, params, axis_name, e5m2_allgather):
    from apex_tpu_torch.monitor.trace import span

    transport = torch.float8_e5m2 if e5m2_allgather else None
    with span("comm"):
        return tree_map(
            lambda m, p: gather_leaf(m, p.shape, p.dtype, axis_name,
                                     transport_dtype=transport),
            master, params)


class DistAdamState(NamedTuple):
    count: torch.Tensor   # 0-d int32 on the leaves' device
    master: Pytree        # fp32 param shards, (k,) a leaf
    mu: Pytree            # fp32 moment shards
    nu: Pytree


@dataclasses.dataclass(frozen=True)
class DistributedFusedAdam:
    """JAX's constructor surface (the reference's, without its stream and
    bucket knobs). On the current mesh (``parallel.build_mesh``)::

        opt = DistributedFusedAdam(lr=1e-3, max_grad_norm=1.0)
        state = opt.init(params)              # sharded fp32 master + moments
        params, state = opt.step(grads, state, params)

    ``compression``: the gradient reduce-scatter's wire (``int8``, or
    ``int8_ef`` / ``int4_ef`` with ``comm_state``); ``e5m2_allgather``:
    the parameter all-gather as float8_e5m2 bytes; ``fused_update``
    ``"auto"`` / ``"on"``: the tail kernel a shard leaf on the card (its
    plain version on the CPU), ``"off"``: JAX's op chain."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    max_grad_norm: Optional[float] = None
    axis_name: str = DP_AXIS
    e5m2_allgather: bool = False
    compression: Optional[CompressionConfig] = None
    fused_update: str = "auto"

    def __post_init__(self):
        resolve_fused(self.fused_update)

    def init(self, params: Pytree) -> DistAdamState:
        """This rank's fp32 master shards and zero moments from the
        replicated ``params``."""
        return DistAdamState(*_init_shards(
            params, self.axis_name, _shard_multiple(self.compression)))

    def init_comm_state(self, params: Pytree) -> Optional[Pytree]:
        """The error-feedback residuals (full-size fp32, one a leaf) under
        an ``*_ef`` policy, else ``None``."""
        if self.compression is not None and self.compression.error_feedback:
            return init_error_feedback(params)
        return None

    # -- checkpointing: ROADMAP A8 ------------------------------------------
    def state_dict(self, state, params=None, dp=None):
        refuse_checkpoint("DistributedFusedAdam.state_dict")

    def load_state_dict(self, template, d, allow_reshard=False):
        refuse_checkpoint("DistributedFusedAdam.load_state_dict")

    def elastic_spec(self, params, dp):
        refuse_checkpoint("DistributedFusedAdam.elastic_spec")

    def elastic_comm_spec(self, params, dp):
        refuse_checkpoint("DistributedFusedAdam.elastic_comm_spec")

    @torch.no_grad()
    def step(self, grads: Pytree, state: DistAdamState, params: Pytree,
             scale: Optional[torch.Tensor] = None,
             comm_state: Optional[Pytree] = None, seed=None,
             metrics: Optional[Any] = None) -> Tuple[Pytree, ...]:
        """reduce-scatter → (unscale, clip) → Adam on the shards →
        all-gather. ``grads``: this rank's gradients (not yet reduced);
        ``params``: the tree the gathered parameters take their shapes and
        dtypes from. Returns ``(params, state)``, then the new
        ``comm_state`` when one was passed, then ``metrics`` (``grad_norm``,
        ``param_norm``, ``update_norm``, ``comm_wire_bytes``) when
        passed."""
        _check_ef(self.compression, comm_state)
        g_shards, new_comm = _reduce_grads(grads, comm_state, self.axis_name,
                                           self.compression, seed,
                                           scale=scale)
        _, world, _ = resolve_axis(self.axis_name)
        g_shards = _scaled_shards(g_shards, world, scale)
        gnorm = (_global_norm_shards(g_shards, self.axis_name)
                 if self.max_grad_norm is not None or metrics is not None
                 else None)
        if self.max_grad_norm is not None:
            g_shards = _clip(g_shards, gnorm, self.max_grad_norm)
        count = state.count + 1
        corr = _bias_corrections(count, self.betas)
        use_fused = resolve_fused(self.fused_update)
        out = [adam_shard_update(
            g, m, v, p, 1.0, 1.0, lr=self.lr, betas=self.betas,
            eps=self.eps, weight_decay=self.weight_decay,
            adam_w_mode=self.adam_w_mode, use_fused=use_fused, corr=corr)
            for g, m, v, p in zip(tree_leaves(g_shards),
                                  tree_leaves(state.mu),
                                  tree_leaves(state.nu),
                                  tree_leaves(state.master))]
        master = tree_unflatten(state.master, [o[0] for o in out])
        mu = tree_unflatten(state.mu, [o[1] for o in out])
        nu = tree_unflatten(state.nu, [o[2] for o in out])
        new_params = _gather_params(master, params, self.axis_name,
                                    self.e5m2_allgather)
        result: Tuple[Pytree, ...] = (new_params,
                                      DistAdamState(count, master, mu, nu))
        if comm_state is not None:
            result += (new_comm,)
        if metrics is not None:
            result += (_record_zero_metrics(
                metrics, gnorm, master, state.master, grads, world,
                self.compression, self.e5m2_allgather, self.axis_name),)
        return result
