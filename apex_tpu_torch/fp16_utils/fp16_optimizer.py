"""The legacy ``FP16_Optimizer`` wrapper (counterpart of
``apex_tpu/fp16_utils/fp16_optimizer.py``): fp32 master weights and a
static or dynamic loss scaler around a port optimizer. The caller scales
the loss, differentiates it in the model's half type, and :meth:`step`
unscales into fp32 master grads, clips, updates the scale and steps the
optimizer on the masters, which keeps them, its state and its count where
a step overflowed. The skip is a device flag handed to the optimizer
(``optimizer.step(found_inf=...)``): no value is read back to the host in
a step."""

from __future__ import annotations

import copy
from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.amp.frontend import _as_tree, _is_float
from apex_tpu_torch.amp.scaler import LossScalerState
from apex_tpu_torch.fp16_utils.fp16util import (clip_grad_norm,
                                                master_params_to_model_params)
from apex_tpu_torch.fp16_utils.loss_scaler import (DynamicLossScaler,
                                                   LossScaler)
from apex_tpu_torch.optimizers._common import tree_leaves, tree_map


class FP16OptimizerState(NamedTuple):
    master_params: Any           # fp32 tree
    inner_state: Any             # the optimizer, which holds its state
    scaler: LossScalerState


class FP16_Optimizer:
    """JAX's constructor: ``FP16_Optimizer(optimizer, static_loss_scale=
    1.0, dynamic_loss_scale=False, dynamic_loss_args=None)``. ``optimizer``
    is a port optimizer (``FusedAdam``, ``FusedSGD``, ...) built over the
    model's float leaves in tree order, as Apex's wrapper takes one built
    over the model's parameters; :meth:`init` puts the fp32 masters in
    their place."""

    def __init__(self, optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None):
        self.optimizer = optimizer
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)

    def _adopt(self, masters: Any) -> None:
        """The optimizer's params, group by group in order, become the
        float leaves of ``masters``."""
        leaves = [x for x in tree_leaves(masters) if _is_float(x)]
        n = sum(len(g["params"]) for g in self.optimizer.param_groups)
        if n != len(leaves):
            raise ValueError(
                f"FP16_Optimizer: the optimizer holds {n} params, the model "
                f"{len(leaves)} float leaves; build it over the model's "
                f"float leaves in tree order")
        it = iter(leaves)
        for group in self.optimizer.param_groups:
            group["params"] = [next(it) for _ in group["params"]]
        self.optimizer.state.clear()

    def init(self, model_params: Any) -> FP16OptimizerState:
        """fp32 masters of ``model_params`` (new tensors) in the
        optimizer's place, and the scaler's state on their device."""
        masters = tree_map(lambda x: (x.detach().to(torch.float32, copy=True)
                                      if _is_float(x) else x), model_params)
        self._adopt(masters)
        leaves = [x for x in tree_leaves(masters) if torch.is_tensor(x)]
        device = leaves[0].device if leaves else None
        return FP16OptimizerState(masters, self.optimizer,
                                  self.loss_scaler.init_state(device))

    def scale_loss(self, loss: torch.Tensor,
                   state: FP16OptimizerState) -> torch.Tensor:
        """``loss`` in fp32 times the scale: differentiate this."""
        return self.loss_scaler.scale_loss(loss, state.scaler)

    def step(self, model_grads: Any, state: FP16OptimizerState,
             max_grad_norm: Optional[float] = None
             ) -> Tuple[Any, FP16OptimizerState, torch.Tensor]:
        """Unscale (fp32), optionally clip to ``max_grad_norm``, update the
        scale and step the optimizer on the masters, in place, guarded by
        the overflow flag. ``model_grads`` is a tree like the model or the
        flat list ``torch.autograd.grad`` gives over its float leaves.
        Returns ``(master_params, new_state, skipped)``: the fp32 masters
        (:meth:`model_params` casts them back) and a 0-d bool tensor."""
        grads = _as_tree(model_grads, state.master_params)
        grads32, found_inf = self.loss_scaler.unscale(grads, state.scaler)
        if max_grad_norm is not None:
            grads32, _ = clip_grad_norm(grads32, max_grad_norm)
        new_scaler, skipped = self.loss_scaler.update_scale(state.scaler,
                                                            found_inf)
        for p, g in zip(tree_leaves(state.master_params),
                        tree_leaves(grads32)):
            if _is_float(p):
                p.grad = g
        state.inner_state.step(found_inf=skipped.to(torch.float32))
        return (state.master_params,
                FP16OptimizerState(state.master_params, state.inner_state,
                                   new_scaler), skipped)

    def model_params(self, state: FP16OptimizerState,
                     model_like: Any) -> Any:
        """The masters in the dtypes of ``model_like``'s leaves."""
        return master_params_to_model_params(state.master_params, model_like)

    # -- checkpointing ------------------------------------------------------
    def state_dict(self, state: FP16OptimizerState) -> dict:
        """The scaler's state, copies of the masters and of the
        optimizer's state dict (later steps do not change it)."""
        return {
            "loss_scaler": self.loss_scaler.state_dict(state.scaler),
            "master_params": tree_map(
                lambda x: x.detach().clone() if torch.is_tensor(x) else x,
                state.master_params),
            "inner_state": copy.deepcopy(state.inner_state.state_dict()),
        }

    def load_state_dict(self, d: dict, device=None) -> FP16OptimizerState:
        """A state from :meth:`state_dict`: copies of its masters in the
        optimizer's place, its state loaded, the scaler's state on the
        masters' device (or ``device``)."""
        masters = tree_map(
            lambda x: x.detach().clone() if torch.is_tensor(x) else x,
            d["master_params"])
        self._adopt(masters)
        self.optimizer.load_state_dict(copy.deepcopy(d["inner_state"]))
        if device is None:
            leaves = [x for x in tree_leaves(masters) if torch.is_tensor(x)]
            device = leaves[0].device if leaves else None
        return FP16OptimizerState(
            masters, self.optimizer,
            self.loss_scaler.load_state_dict(d["loss_scaler"],
                                             device=device))
