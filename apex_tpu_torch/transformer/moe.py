"""Mixture-of-Experts layer with expert parallelism (counterpart of
``apex_tpu/transformer/moe.py``).

The GShard / Switch capacity-factor formulation, with JAX's static shapes:
every expert takes a fixed capacity ``C`` of token slots; a token routed
past its expert's capacity is dropped from the expert path (its output is
the zero vector, so the residual passes it through). The routing runs on
the device with no host read: a stable descending sort stands for
``lax.top_k`` (ties to the lower expert index), the priority of every
token's slot-0 choice over any slot-1 choice is a cumulative sum, and
dispatch and combine are one-hot ``(T, E, C)`` tensors (each token's slot
an expert compared with an arange) contracted with the token rows by
``torch.matmul`` (JAX's ``jnp.einsum``).

Experts are sharded over ``ep_axis`` (default the ``dp`` mesh axis): each
rank holds ``E / ep`` experts and exchanges the dispatched slots with one
tiled all-to-all each way (``sequence_parallel.all_to_all_dims``, whose
backward is the inverse exchange); at ``ep = 1`` no exchange is issued.
The expert FFN carries the Megatron column / row split on its ffn dim
over tp (``copy_to`` on entry, ``reduce_from`` on exit).

The router stays fp32 whatever the model dtype; the expert products run
in the input's dtype and ``combine`` is cast to it before the combine
product, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, axis_info
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_sequence_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import P

Pytree = Any
EXPERT_LEAVES = ("fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Static MoE hyper-parameters (JAX's fields and defaults)."""

    num_experts: int
    hidden: int
    ffn_hidden: int
    top_k: int = 2
    # capacity per expert = int(top_k * tokens / num_experts * factor) + 1
    capacity_factor: float = 1.25
    lb_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.top_k > self.num_experts:
            raise ValueError(
                f"top_k ({self.top_k}) cannot exceed num_experts "
                f"({self.num_experts})")

    def capacity(self, tokens_per_rank: int) -> int:
        per = self.top_k * tokens_per_rank / self.num_experts
        cap = int(per * self.capacity_factor) + 1
        # rounded up to 8 when above 8, as JAX's
        return max(8, -(-cap // 8) * 8) if cap > 8 else max(1, cap)


def init_moe_params_numpy(cfg: MoEConfig, ep: int = 1, tp: int = 1,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """The global-shape parameter tree as float32 numpy arrays from
    ``np.random.default_rng(seed)``: the router normal(0.02), the expert
    kernels normal(0.02) with a leading global expert dim ``[E]``, zero
    biases (JAX's shapes and scales). :func:`moe_param_specs` shards the
    experts over ``ep`` and the ffn dim over ``tp``."""
    if cfg.num_experts % ep:
        raise ValueError(
            f"num_experts ({cfg.num_experts}) not divisible by ep ({ep})")
    if cfg.ffn_hidden % tp:
        raise ValueError(
            f"ffn_hidden ({cfg.ffn_hidden}) not divisible by tp ({tp})")
    rng = np.random.default_rng(seed)
    e, h, f = cfg.num_experts, cfg.hidden, cfg.ffn_hidden

    def normal(shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            0.02)

    return {"router": normal((h, e)),
            "fc1_kernel": normal((e, h, f)),
            "fc1_bias": np.zeros((e, f), np.float32),
            "fc2_kernel": normal((e, f, h)),
            "fc2_bias": np.zeros((e, h), np.float32)}


def init_moe_params(cfg: MoEConfig, ep: int = 1, tp: int = 1, seed: int = 0,
                    device=None) -> Dict[str, torch.Tensor]:
    """:func:`init_moe_params_numpy` as tensors on ``device`` (default
    ``cuda``): the expert leaves in ``cfg.dtype``, the router fp32."""
    from apex_tpu_torch.convert import params_from_numpy

    tree = init_moe_params_numpy(cfg, ep, tp, seed)
    params = params_from_numpy(tree, device, dtype=cfg.dtype)
    params["router"] = params_from_numpy(tree["router"], device)
    return params


def moe_param_specs(ep_axis: Optional[str] = DP_AXIS) -> Dict[str, Any]:
    """Partition specs of :func:`init_moe_params`: experts over
    ``ep_axis``, the expert ffn dim over tp (column / row split)."""
    return {"router": P(),
            "fc1_kernel": P(ep_axis, None, TP_AXIS),
            "fc1_bias": P(ep_axis, TP_AXIS),
            "fc2_kernel": P(ep_axis, TP_AXIS, None),
            "fc2_bias": P(ep_axis, None)}


# ---------------------------------------------------------------------------
# routing


def top_k_lower_index(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest values in descending
    order, ties to the lower index (a stable descending sort; ``torch.topk``
    makes no promise on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes, by comparison with an
    arange (``F.one_hot`` checks the index range with a host read)."""
    classes = torch.arange(n, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == classes).to(torch.float32)


def _route(logits32: torch.Tensor, top_k: int, capacity: int):
    """Token-choice top-k routing with per-expert capacity (JAX's
    ``_route``). ``logits32`` (T, E) fp32 -> ``(dispatch, combine, aux)``:
    the 0 / 1 (T, E, C) assignment, its gate-weighted fp32 version and the
    load statistics."""
    t, e = logits32.shape
    probs = torch.softmax(logits32, dim=-1)
    gate, idx = top_k_lower_index(probs, top_k)                   # (T, k)
    # GShard: the selected gates renormalised over the k choices
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = _one_hot(idx, e)                                     # (T, k, E)
    # every token's slot-0 choice outranks any slot-1 choice: a running
    # count along (k, T) with the slot-0 choices first, as a last-dim scan
    # of the (E, k·T) selection
    sel = onehot.permute(2, 1, 0).reshape(e, top_k * t)
    pos = (torch.cumsum(sel, dim=-1) - sel).reshape(e, top_k, t).permute(
        2, 1, 0)                                                  # (T, k, E)
    keep = onehot * (pos < capacity)
    # a token takes an expert in one of its choices at most: its slot in
    # and gate for each expert (-1 and 0 where it holds none; each sum
    # over k has one nonzero term at most, so it is exact), and the
    # one-hot slots by comparison with an arange
    held = keep.sum(1)                                            # (T, E)
    slot = torch.where(held > 0, (pos * keep).sum(1), -1.0)
    dispatch = _one_hot(slot.to(torch.int64), capacity)           # (T, E, C)
    combine = dispatch * (keep * gate[..., None]).sum(1)[..., None]

    # Switch aux loss: E · Σ_e (fraction routed to e by top-1, before
    # capacity) · (mean probability of e)
    frac = onehot[:, 0, :].mean(0)
    lb_loss = e * (frac * probs.mean(0)).sum()
    z = torch.logsumexp(logits32, dim=-1)
    z_loss = (z * z).mean()
    kept = keep.sum() / torch.clamp(onehot.sum(), min=1.0)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "fraction_kept": kept}
    return dispatch, combine, aux


# ---------------------------------------------------------------------------
# expert compute


def _expert_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x`` (E_local, N, h), the same on every tp rank -> (E_local, N, h):
    fc1 column-parallel, tanh GELU, fc2 row-parallel, in ``x``'s dtype."""
    x = copy_to_tensor_model_parallel_region(x)
    y = torch.bmm(x, p["fc1_kernel"].to(x.dtype)) + p["fc1_bias"][:, None, :]
    y = F.gelu(y, approximate="tanh")
    y = torch.bmm(y, p["fc2_kernel"].to(x.dtype))
    y = reduce_from_tensor_model_parallel_region(y)
    return y + p["fc2_bias"][:, None, :]


def _local_experts(params: Dict[str, torch.Tensor], ep_axis: str,
                   e_local: int) -> Dict[str, torch.Tensor]:
    """This rank's expert shard of params that arrived whole (the local
    tree of ``moe_param_specs`` already is the shard)."""
    if params["fc1_kernel"].shape[0] == e_local:
        return params
    start = axis_info(ep_axis)[2] * e_local
    return {k: params[k].narrow(0, start, e_local) for k in EXPERT_LEAVES}


# ---------------------------------------------------------------------------
# the layer


def moe_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
            ep_axis: Optional[str] = DP_AXIS,
            seq_shard_axis: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE FFN over ``x`` (..., h), this rank's tokens; experts over
    ``ep_axis`` (None: one rank's layer, no exchange). Returns ``(out,
    aux)``; ``aux["loss"]`` is the weighted router loss
    ``lb_loss_weight · lb_loss + z_loss_weight · z_loss``.

    ``seq_shard_axis``: the tokens are this rank's sequence shard over
    that axis (Megatron-SP regions over tp). Each rank routes its own
    tokens at the per-shard capacity, the kept slots (not the sequence)
    are all-gathered along the capacity dim for the tp-split expert FFN,
    and each rank combines its own slot block; the output stays a
    sequence shard. The gather's backward keeps this rank's slice (the
    expert FFN's entry mapping sums the ranks' partial cotangents)."""
    lead = x.shape[:-1]
    h = x.shape[-1]
    xf = x.reshape(-1, h)
    t = xf.shape[0]
    e = cfg.num_experts
    cap = cfg.capacity(t)

    logits = torch.matmul(xf.float(), params["router"])
    dispatch, combine, aux = _route(logits, cfg.top_k, cap)

    # (T, h) -> (E, C, h): zero rows where a slot is unfilled
    exp_in = torch.matmul(dispatch.to(x.dtype).reshape(t, e * cap).t(),
                          xf).reshape(e, cap, h)

    if seq_shard_axis is not None:
        exp_in = gather_from_sequence_parallel_region(
            exp_in, seq_shard_axis, seq_axis=1,
            tensor_parallel_output_grad=False)

    ep = 1 if ep_axis is None else axis_info(ep_axis)[1]
    if ep > 1:
        from apex_tpu_torch.transformer.sequence_parallel import (
            all_to_all_dims,
        )

        e_local = e // ep
        # the global experts split over the ranks, every rank's slots for
        # the local experts concatenated along the token dim
        exp_in = all_to_all_dims(exp_in, ep_axis, 0, 1, tag="moe")
        exp_out = _expert_ffn(_local_experts(params, ep_axis, e_local),
                              exp_in)
        exp_out = all_to_all_dims(exp_out, ep_axis, 1, 0, tag="moe")
    else:
        exp_out = _expert_ffn(params, exp_in)

    if seq_shard_axis is not None:
        # this rank's slot block of the gathered capacity dim
        exp_out = scatter_to_sequence_parallel_region(
            exp_out, seq_shard_axis, seq_axis=1)

    cap_out = exp_out.shape[1]
    out = torch.matmul(combine.to(x.dtype).reshape(t, e * cap_out),
                       exp_out.reshape(e * cap_out, h))
    aux = dict(aux)
    aux["loss"] = (cfg.lb_loss_weight * aux["lb_loss"]
                   + cfg.z_loss_weight * aux["z_loss"])
    return out.reshape(*lead, h), aux
