"""FSDP optimizer — Adam on the local shard only (counterpart of
``apex_tpu/fsdp/optim.py``).

Under FSDP the gradient reduce-scatter is the gather's backward and the
next forward gathers again, so the optimizer is ZeRO-1's middle alone:
the shared Adam tail (``_sharding.adam_shard_update``, the same
operations as ``DistributedFusedAdam``: ``fused_adam_tail`` a shard on the
card) over fp32 master and moment shards. The master shard is the
parameter store.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.contrib.optimizers._sharding import (
    adam_shard_update,
    global_norm_shards,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    _bias_corrections,
    _clip,
    _scaled_shards,
    _update_norms,
    refuse_checkpoint,
)
from apex_tpu_torch.fsdp.core import FSDP
from apex_tpu_torch.ops.fused_update import resolve_fused
from apex_tpu_torch.optimizers._common import (tree_leaves, tree_map,
                                               tree_unflatten)
from apex_tpu_torch.parallel.mesh import resolve_axis

Pytree = Any


class FSDPAdamState(NamedTuple):
    count: torch.Tensor   # 0-d int32 on the shards' device
    master: Pytree        # fp32 param shards: the parameter store
    mu: Pytree            # fp32 moment shards
    nu: Pytree


@dataclasses.dataclass(frozen=True)
class FSDPAdam:
    """AdamW over FSDP shards (:class:`~apex_tpu_torch.fsdp.FSDP` shows the
    loop). ``step`` takes the shard gradients of the gather's backward,
    summed over dp, and averages them here, as ``DistributedFusedAdam``
    does."""

    fsdp: FSDP = dataclasses.field(default_factory=FSDP)
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    max_grad_norm: Optional[float] = None
    fused_update: str = "auto"

    def __post_init__(self):
        resolve_fused(self.fused_update)

    @property
    def axis_name(self) -> str:
        return self.fsdp.axis_name

    # -- state -------------------------------------------------------------
    def init(self, params: Pytree) -> FSDPAdamState:
        """fp32 master shards and zero moments from replicated ``params``."""
        return self.init_shards(self.fsdp.shard_params(params))

    def init_shards(self, master: Pytree) -> FSDPAdamState:
        """State over an already-sharded fp32 master tree (any shard
        shape: the tail is elementwise)."""
        leaves = tree_leaves(master)
        dev = leaves[0].device if leaves else None
        return FSDPAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            master=master, mu=tree_map(torch.zeros_like, master),
            nu=tree_map(torch.zeros_like, master))

    # -- checkpointing: ROADMAP A8 ------------------------------------------
    def state_dict(self, state, params=None, dp=None):
        refuse_checkpoint("FSDPAdam.state_dict")

    def load_state_dict(self, template, d, allow_reshard=False):
        refuse_checkpoint("FSDPAdam.load_state_dict")

    def elastic_spec(self, params, dp):
        refuse_checkpoint("FSDPAdam.elastic_spec")

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def step(self, g_shards: Pytree, state: FSDPAdamState,
             scale: Optional[torch.Tensor] = None,
             metrics: Optional[Any] = None, meta: Optional[Pytree] = None):
        """One update of the local shards: ``state``, or ``(state,
        metrics)`` when ``metrics`` is passed (``grad_norm``,
        ``param_norm``, ``update_norm``; with ``meta`` also the modeled
        ``param_gather_bytes``, ``comm_wire_bytes`` and
        ``hbm_params_bytes``). The new master shards do not require
        grad."""
        _, world, _ = resolve_axis(self.axis_name)
        g_shards = _scaled_shards(tree_map(lambda g: g.float(), g_shards),
                                  world, scale)
        gnorm = (global_norm_shards(g_shards, self.axis_name)
                 if self.max_grad_norm is not None or metrics is not None
                 else None)
        if self.max_grad_norm is not None:
            g_shards = _clip(g_shards, gnorm, self.max_grad_norm)
        count = state.count + 1
        corr = _bias_corrections(count, self.betas)
        use_fused = resolve_fused(self.fused_update)
        out = [adam_shard_update(
            g, m, v, p.detach(), 1.0, 1.0, lr=self.lr, betas=self.betas,
            eps=self.eps, weight_decay=self.weight_decay,
            adam_w_mode=self.adam_w_mode, use_fused=use_fused, corr=corr)
            for g, m, v, p in zip(tree_leaves(g_shards),
                                  tree_leaves(state.mu),
                                  tree_leaves(state.nu),
                                  tree_leaves(state.master))]
        master = tree_unflatten(state.master, [o[0] for o in out])
        mu = tree_unflatten(state.mu, [o[1] for o in out])
        nu = tree_unflatten(state.nu, [o[2] for o in out])
        new_state = FSDPAdamState(count, master, mu, nu)
        if metrics is None:
            return new_state
        both = _update_norms(master, state.master, self.axis_name)
        entries = dict(grad_norm=gnorm, param_norm=both[0],
                       update_norm=both[1])
        if meta is not None:
            from apex_tpu_torch.fsdp.accounting import hbm_params_bytes

            gather = self.fsdp.gather_wire_bytes(meta, world)
            entries["param_gather_bytes"] = gather
            entries["comm_wire_bytes"] = (
                gather + self.fsdp.reduce_wire_bytes(meta, world))
            entries["hbm_params_bytes"] = hbm_params_bytes(
                meta, strategy="fsdp", world=world,
                shard_multiple=self.fsdp.shard_multiple)["total"]
        return new_state, metrics.record(**entries)
