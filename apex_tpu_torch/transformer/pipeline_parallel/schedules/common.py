"""Shared plumbing for the forward-backward schedule drivers (counterpart
of ``apex_tpu/transformer/pipeline_parallel/schedules/common.py``).

The driver contract is JAX's, value based: the model is a
:class:`PipelineSpec` of three functions. The embedding
(``pre_process``) and the loss head (``post_process``) run outside the
ring, which keeps the pipelined region shape-uniform. ``build_model``
stacks per-stage parameter trees along a leading ``[pp]`` axis (``[vp,
pp]`` for the interleaved schedule).

Where JAX runs one SPMD program inside ``shard_map``, every rank of the
port is its own process: a driver takes this rank's local parameter tree
(its stage's params with the stage axis removed, ``[vp, ...]`` chunks when
interleaved; ``convert.pipeline_params_from_numpy`` cuts it from JAX's
global tree) and the global batch, which it splits into microbatches and
cuts to this rank's slice by ``data_spec`` (:func:`local_slice`).
Gradients come back as JAX's driver returns them, restricted to this
rank's shards: each leaf summed over dp and sp (the axes the data is
split on), ``embed`` and ``head`` over pp as well (only stage 0 touches
the embedding and only the last stage's loss reaches the head; JAX's
``shard_map`` sums a replicated input's cotangent over every axis), none
over tp (a tp-replicated leaf already holds its whole gradient on every
tp rank, through the tp mappings). Host-known rank predicates select
with ``torch.where``, never a product by 0 or 1, so every rank of a pp
group builds the same ring and issues the same hops in the same order,
forward and backward. Only the last stage runs the loss head; the other
stages start their backward from their ring outputs with zero
cotangents.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from apex_tpu_torch.optimizers._common import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from apex_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DP_AXIS,
    PP_AXIS,
    SP_AXIS,
    axis_info,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import all_reduce
from apex_tpu_torch.transformer.tensor_parallel.random import fold_in
from apex_tpu_torch.transformer.tensor_parallel.utils import P

Pytree = Any


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """The pipelined model contract (the ``model_provider_func`` analogue,
    ref common.py:25-148).

    embed_fn(embed_params, inputs_mb) -> hidden
        The ``pre_process`` half for ONE microbatch. Runs on every stage
        (its output is consumed at stage 0 only).
    stage_fn(stage_params, hidden) -> hidden
        One pipeline stage (``num_layers / (pp * vp)`` layers),
        shape-preserving. May use tp / sp collectives inside.
    loss_fn(head_params, hidden, targets_mb) -> scalar
        The ``post_process`` half: final norm + head + loss for ONE
        microbatch, averaged over its tokens.
    stage_aux
        When True, ``stage_fn`` returns ``(hidden, aux_scalar)``: the
        schedules average the aux over real (non-fill/drain) ticks,
        microbatches and stages and ADD it to the returned loss.
    takes_dropout_key
        When True, ``embed_fn`` / ``stage_fn`` take a trailing
        per-microbatch threefry key (training dropout); a driver's
        ``dropout_key`` needs a spec built with this flag and vice versa.
    """

    embed_fn: Callable[[Pytree, Pytree], Pytree]
    stage_fn: Callable[[Pytree, Pytree], Pytree]
    loss_fn: Callable[[Pytree, Pytree, Pytree], torch.Tensor]
    stage_aux: bool = False
    takes_dropout_key: bool = False


def check_dropout_spec(spec, dropout_key) -> None:
    """Validate the spec / dropout_key pairing in both directions before
    running (a mismatch would otherwise fail with an arity TypeError deep
    inside a stage)."""
    if dropout_key is not None and not spec.takes_dropout_key:
        raise ValueError(
            "dropout_key given but the PipelineSpec was built without "
            "takes_dropout_key (e.g. gpt_pipeline_spec(cfg, dropout=True))")
    if dropout_key is None and spec.takes_dropout_key:
        raise ValueError(
            "the PipelineSpec was built with takes_dropout_key but no "
            "dropout_key was passed; pass one (training) or build the "
            "spec without dropout (eval)")


def derive_microbatch_keys(dropout_key, num_microbatches: int):
    """One threefry key per microbatch, ``fold_in(dropout_key, m)`` on the
    host (JAX's derivation), or None."""
    if dropout_key is None:
        return None
    return [fold_in(dropout_key, m) for m in range(num_microbatches)]


def microbatch(tree: Pytree, m: int) -> Pytree:
    """Microbatch ``m`` of a tree of ``[M, ...]`` leaves."""
    return tree_map(lambda a: a[m], tree)


def embed_microbatches(embed_fn, embed_params, inputs_mb, keys_mb=None
                       ) -> List[Pytree]:
    """``embed_fn`` on each microbatch of ``inputs_mb`` (a tree of ``[M,
    ...]`` leaves; JAX vmaps it), the per-microbatch keys threaded when
    dropout is on: a list of M outputs."""
    M = tree_leaves(inputs_mb)[0].shape[0]
    if keys_mb is not None:
        return [embed_fn(embed_params, microbatch(inputs_mb, m), keys_mb[m])
                for m in range(M)]
    return [embed_fn(embed_params, microbatch(inputs_mb, m))
            for m in range(M)]


def build_model(
    stage_init_fn: Callable[[Any, int], Pytree],
    rng,
    num_stages: int,
    virtual_pipeline_size: Optional[int] = None,
) -> Pytree:
    """Initialize and stack per-stage params (ref common.py:25-147).

    ``stage_init_fn(fold_in(rng, c), c)`` returns chunk ``c``'s tree of
    tensors (``rng`` a threefry key). Non-interleaved: leaves gain a
    leading ``[pp]`` axis. Interleaved: a leading ``[vp, pp]`` pair,
    chunk ``v`` on stage ``s`` holding layer block ``v * pp + s`` (the
    Megatron interleaved assignment)."""
    vp = virtual_pipeline_size or 1
    chunks = [stage_init_fn(fold_in(rng, c), c)
              for c in range(vp * num_stages)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *chunks)
    if virtual_pipeline_size is None:
        return stacked
    return tree_map(lambda x: x.reshape((vp, num_stages) + x.shape[1:]),
                    stacked)


def stage_params_spec(params: Pytree, interleaved: bool = False) -> Pytree:
    """Default specs for stacked stage params: the stage axis over
    ``pp``, the rest whole."""
    lead = P(None, PP_AXIS) if interleaved else P(PP_AXIS)
    return tree_map(lambda _: lead, params)


def split_microbatches(batch: Pytree, num_microbatches: int) -> Pytree:
    """[B, ...] -> [M, B/M, ...] on every leaf (ref
    pipeline_parallel/utils.py:105-139 ``get_kth_microbatch``)."""

    def one(x):
        b = x.shape[0]
        if b % num_microbatches != 0:
            raise ValueError(
                f"batch dim {b} not divisible by num_microbatches "
                f"{num_microbatches}"
            )
        return x.reshape((num_microbatches, b // num_microbatches)
                         + tuple(x.shape[1:]))

    return tree_map(one, batch)


def local_slice(tree: Pytree, spec) -> Pytree:
    """This rank's slice of every leaf: each dim ``spec`` names cut by this
    rank's index on that axis of the current mesh (``shard_map``'s
    ``in_specs`` for data)."""

    def cut(t):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            _, world, index = axis_info(axis)
            size = t.shape[dim] // world
            t = t.narrow(dim, index * size, size)
        return t

    return tree_map(cut, tree)


def replicate_loss(local_loss, mesh=None,
                   masked_axis: Optional[str] = PP_AXIS):
    """A loss that is nonzero only on the last pipeline stage (the same
    across tp / sp, different across dp) made the same on every rank, as
    JAX's: summed over ``masked_axis``, averaged over every other axis (the
    dp mean of ``average_losses_across_data_parallel_group``). Values
    only: the drivers differentiate their local objective."""
    loss = local_loss
    with _installed(mesh):
        for a in AXIS_ORDER:
            _, n, _ = axis_info(a)
            loss = all_reduce(loss, a)
            if a != masked_axis:
                loss = loss / n
    return loss


def _installed(mesh):
    """``with mesh:`` when one is given, else the current mesh."""
    return mesh if mesh is not None else contextlib.nullcontext()


def trainable_leaves(params: Pytree) -> List[torch.Tensor]:
    """The leaves of ``params`` in tree order, made trainable (a driver
    differentiates with respect to them)."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    return leaves


def where_rank(flag: bool, a: Pytree, b: Pytree) -> Pytree:
    """``a`` where the host-known rank predicate holds, else ``b``, leaf
    by leaf through ``torch.where``, so the graph is the same on every
    rank (JAX's select over ``axis_index``). The predicate is filled on
    the device: a host tensor copied there would synchronize the host."""

    def one(x, y):
        return torch.where(
            torch.full((), flag, dtype=torch.bool, device=x.device), x, y)

    return tree_map(one, a, b)


def data_parallel_share() -> int:
    """The ranks the data is split over: dp × sp."""
    return axis_info(DP_AXIS)[1] * axis_info(SP_AXIS)[1]


def reduce_grads(params: Pytree, grads: Sequence[torch.Tensor],
                 specs: Optional[Pytree] = None) -> Pytree:
    """The tree of this rank's gradients as JAX's driver returns them (the
    module docstring): every leaf summed over dp and sp, ``embed`` and
    ``head`` over pp too. ``specs`` (JAX's ``params_specs``, shaped like
    ``params``): a leaf whose spec names dp is sharded over it (an expert
    of ``transformer.moe``: its local gradient already holds every dp
    rank's tokens, through the all-to-all's backward) and is not summed
    over dp."""
    tree = tree_unflatten(params, list(grads))

    def over(axes):
        def one(g, spec=()):
            for a in axes:
                if a != DP_AXIS or DP_AXIS not in tuple(spec):
                    g = all_reduce(g, a)
            return g
        return one

    out = {}
    for k, v in tree.items():
        fn = over((DP_AXIS, SP_AXIS)
                  + ((PP_AXIS,) if k in ("embed", "head") else ()))
        out[k] = (tree_map(fn, v) if specs is None
                  else tree_map(fn, v, specs[k]))
    return out
