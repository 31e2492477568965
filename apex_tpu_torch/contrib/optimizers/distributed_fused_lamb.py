"""ZeRO-style LAMB with dp-sharded state and global-norm clipping
(counterpart of ``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``;
reference ``apex/contrib/optimizers/distributed_fused_lamb.py``, the MLPerf
BERT optimizer).

DistributedFusedAdam's dataflow plus LAMB's trust ratio, which needs each
parameter's ‖p‖ and ‖u‖ over all of its shards. With the fused tail the
``fused_lamb_tail`` kernel gives each shard's local Σp² and Σu²; else
they are sums of the shard. JAX all-reduces each leaf's two sums on
their own (two psums a leaf). Here every leaf's pair is stacked into one
``(leaves, 2)`` tensor after all the tails (no tail reads a norm) and
all-reduced once: each element is the same sum over the ranks, and a
step makes one collective for the norms instead of two a leaf (a
one-rank NCCL all-reduce costs 61-162 µs of host on the card). The
update mirrors ``optimizers.FusedLAMB``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.comm.collectives import CompressionConfig, all_reduce
from apex_tpu_torch.comm.error_feedback import init_error_feedback
from apex_tpu_torch.contrib.optimizers._sharding import (
    global_norm_shards as _global_norm_shards,
    shard_multiple as _shard_multiple,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    _bias_corrections,
    _check_ef,
    _clip,
    _gather_params,
    _init_shards,
    _record_zero_metrics,
    _reduce_grads,
    _scaled_shards,
    refuse_checkpoint,
)
from apex_tpu_torch.ops.fused_update import (fused_lamb_tail,
                                             lamb_tail_reference,
                                             resolve_fused)
from apex_tpu_torch.optimizers._common import tree_leaves, tree_unflatten
from apex_tpu_torch.parallel.mesh import DP_AXIS, resolve_axis

Pytree = Any


class DistLambState(NamedTuple):
    count: torch.Tensor
    master: Pytree
    mu: Pytree
    nu: Pytree


@dataclasses.dataclass(frozen=True)
class DistributedFusedLAMB:
    """JAX's constructor surface (the reference's essentials); the calling
    convention is :class:`DistributedFusedAdam`'s. ``grad_averaging``
    divides the reduce-scatter's sums by the dp size."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-6
    weight_decay: float = 0.01
    bias_correction: bool = True
    grad_averaging: bool = True
    max_grad_norm: Optional[float] = 1.0
    use_nvlamb: bool = False
    axis_name: str = DP_AXIS
    e5m2_allgather: bool = False
    compression: Optional[CompressionConfig] = None
    fused_update: str = "auto"

    def __post_init__(self):
        resolve_fused(self.fused_update)

    def init(self, params: Pytree) -> DistLambState:
        return DistLambState(*_init_shards(
            params, self.axis_name, _shard_multiple(self.compression)))

    def init_comm_state(self, params: Pytree) -> Optional[Pytree]:
        """The error-feedback residuals under an ``*_ef`` policy, else
        ``None``."""
        if self.compression is not None and self.compression.error_feedback:
            return init_error_feedback(params)
        return None

    # -- checkpointing: ROADMAP A8 ------------------------------------------
    def state_dict(self, state):
        refuse_checkpoint("DistributedFusedLAMB.state_dict")

    def load_state_dict(self, template, d):
        refuse_checkpoint("DistributedFusedLAMB.load_state_dict")

    @torch.no_grad()
    def step(self, grads: Pytree, state: DistLambState, params: Pytree,
             scale: Optional[torch.Tensor] = None,
             comm_state: Optional[Pytree] = None, seed=None,
             metrics: Optional[Any] = None) -> Tuple[Pytree, ...]:
        """See :meth:`DistributedFusedAdam.step`: the same calling
        convention and returns."""
        _check_ef(self.compression, comm_state)
        g_shards, new_comm = _reduce_grads(grads, comm_state, self.axis_name,
                                           self.compression, seed,
                                           scale=scale)
        group, world, _ = resolve_axis(self.axis_name)
        g_shards = _scaled_shards(g_shards, world, scale,
                                  divide=self.grad_averaging)
        gnorm = None
        if self.max_grad_norm is not None or metrics is not None:
            gnorm = _global_norm_shards(g_shards, self.axis_name)
        if self.max_grad_norm is not None:
            g_shards = _clip(g_shards, gnorm, self.max_grad_norm)
        count = state.count + 1
        corr = _bias_corrections(count, self.betas, self.bias_correction)
        tail = (fused_lamb_tail if resolve_fused(self.fused_update)
                else lamb_tail_reference)
        kw = dict(betas=self.betas, eps=self.eps,
                  weight_decay=self.weight_decay, corr=corr)
        outs = [tail(g, m, v, p, 1.0, 1.0, **kw)
                for g, m, v, p in zip(tree_leaves(g_shards),
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu),
                                      tree_leaves(state.master))]
        # every leaf's (Σp², Σu²) over dp in one all-reduce
        sums = torch.stack([torch.stack([o[3], o[4]]) for o in outs])
        norms = torch.sqrt(all_reduce(sums, group, world,
                                      tag="lamb_trust_norms"))
        trust_on = self.use_nvlamb or bool(self.weight_decay)
        master = []
        for i, (o, p32) in enumerate(zip(outs, tree_leaves(state.master))):
            u = o[0]
            if trust_on:
                w_norm, u_norm = norms[i, 0], norms[i, 1]
                trust = torch.where((w_norm > 0) & (u_norm > 0),
                                    w_norm / u_norm, 1.0)
                master.append(p32 - (self.lr * trust) * u)
            else:
                master.append(p32 - self.lr * u)
        master = tree_unflatten(state.master, master)
        mu = tree_unflatten(state.mu, [o[1] for o in outs])
        nu = tree_unflatten(state.nu, [o[2] for o in outs])
        new_params = _gather_params(master, params, self.axis_name,
                                    self.e5m2_allgather)
        result: Tuple[Pytree, ...] = (new_params,
                                      DistLambState(count, master, mu, nu))
        if comm_state is not None:
            result += (new_comm,)
        if metrics is not None:
            result += (_record_zero_metrics(
                metrics, gnorm, master, state.master, grads, world,
                self.compression, self.e5m2_allgather, self.axis_name),)
        return result
