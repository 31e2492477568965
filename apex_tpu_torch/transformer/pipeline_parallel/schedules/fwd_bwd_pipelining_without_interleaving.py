"""The 1F1B pipeline schedule over a ring of stages (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_without_interleaving.py``).

Reference: ``fwd_bwd_pipelining_without_interleaving.py:155-345`` —
warmup forwards, steady-state one-forward-one-backward, cooldown
backwards, activations and cotangents moved by batched isend / irecv.

JAX's schedule is one SPMD program: a scan over ``M + pp - 1`` ticks in
which every stage applies its layer block and the ring shifts the
activations one stage forward; the scan's transpose is the backward
pipeline. The port gives each rank the same tick loop: at tick ``t``
stage 0 takes microbatch ``clip(t, 0, M-1)`` and every other stage the
hop's output, the stage runs (under a non-reentrant checkpoint with
``remat``, which saves one boundary tensor a tick and recomputes the
interior in backward), and its output hops one stage forward
(``p2p_communication.send_forward_recv_forward``, outside the
checkpoint, so a recompute issues no hop). The last stage's ticks ``pp-1
…`` are its outputs; ``torch.autograd.grad`` of the loss then runs the
ticks in reverse and each hop's backward is the reverse ring (the other
stages run no loss head: their backward starts from their outputs with
zero cotangents and runs the same hops). Fill and
drain ticks compute on zero-filled inputs (finite through any standard
transformer block) and are selected out with ``torch.where``. The stage
and the hop of each tick run under the ``pp_stage`` / ``pp_ring_shift``
spans.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from apex_tpu_torch.monitor.trace import span
from apex_tpu_torch.optimizers._common import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from apex_tpu_torch.parallel.mesh import DP_AXIS, PP_AXIS, axis_info
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineSpec,
    _installed,
    check_dropout_spec,
    data_parallel_share,
    derive_microbatch_keys,
    embed_microbatches,
    local_slice,
    microbatch,
    reduce_grads,
    replicate_loss,
    split_microbatches,
    trainable_leaves,
    where_rank,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint_saving,
    fold_in,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import P

Pytree = Any


def _ring_shift(x: Pytree, axis_name: str) -> Pytree:
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication,
    )

    return p2p_communication.send_forward_recv_forward(x, axis_name)


def stage_function(stage_fn: Callable, remat: bool) -> Callable:
    """``stage_fn``, recomputed in backward when ``remat`` and autograd
    records (a non-reentrant checkpoint that keeps amp's autocast mode
    across the recompute)."""
    if remat and torch.is_grad_enabled():
        return checkpoint_saving(stage_fn)
    return stage_fn


def _stage_input(take_new: bool, x0, h, pp: int):
    """The tick's input: the new microbatch where ``take_new``, else the
    carry. Over one rank the carry is the previous tick's output (the hop
    is the identity) and the choice is made on the host."""
    if pp == 1:
        return x0 if take_new else h
    if h is None:
        h = tree_map(torch.zeros_like, x0)
    return where_rank(take_new, x0, h)


def _add_aux(aux_sum, aux, valid: bool, pp: int):
    """Accumulate a tick's aux where the tick is real (selected with
    ``torch.where`` over more than one rank)."""
    if pp > 1:
        aux = where_rank(valid, aux, torch.zeros_like(aux))
    elif not valid:
        return aux_sum
    return aux if aux_sum is None else aux_sum + aux


def _chunks(chunk_params: Pytree, vp: int):
    """The ``[vp, ...]`` chunk stack as vp trees, each leaf unbound once
    (so its gradient is stacked once in backward)."""
    parts = [a.unbind(0) for a in tree_leaves(chunk_params)]
    if any(len(p) != vp for p in parts):
        raise ValueError(f"the chunk stack's leading dim is not "
                         f"virtual_pipeline_size ({vp})")
    return [tree_unflatten(chunk_params, [p[r] for p in parts])
            for r in range(vp)]


def pipeline_ring(
    stage_fn: Callable[..., Pytree],
    stage_params: Pytree,
    h_mb,
    *,
    num_microbatches: int,
    virtual_pipeline_size: Optional[int] = None,
    axis_name: str = PP_AXIS,
    remat: bool = True,
    returns_aux: bool = False,
    extra_mb=None,
):
    """Run ``num_microbatches`` activations through the pp-stage ring.

    ``stage_params`` is this stage's params; ``h_mb`` the M stage-0
    inputs (a list, on every rank, consumed at stage 0). Returns the M
    outputs, valid on the LAST stage (finite garbage elsewhere: select
    before use). With ``returns_aux`` the stage yields ``(h, aux_scalar)``
    and the result is ``(outputs, aux_mean)``, the aux averaged over this
    stage's real ticks. ``extra_mb`` (M per-microbatch side operands,
    valid on every rank: encoder memory, dropout keys) makes the call
    ``stage_fn(params, h, extra)`` with the entry of the microbatch this
    stage holds at the tick.

    With ``virtual_pipeline_size`` (the interleaved schedule, module
    docstring of ``fwd_bwd_pipelining_with_interleaving``) ``stage_params``
    is this stage's ``[vp, ...]`` chunk stack, ``M % pp == 0``, the outputs
    are those of the last chunk, and ``extra_mb`` holds the microbatches'
    dropout keys, each folded with the chunk index (chunks on one stage
    share its pp rank). Tick ``t`` works on microbatch ``m = u`` (u = t -
    rank, clipped), or with vp chunks on the interleaved map's (group,
    chunk, microbatch)."""
    _, pp, rank = axis_info(axis_name)
    M, vp = num_microbatches, virtual_pipeline_size or 1
    if virtual_pipeline_size is None:
        chunks = [stage_params]
    else:
        if M % pp != 0:
            raise ValueError(
                f"interleaved schedule requires num_microbatches ({M}) "
                f"divisible by pipeline size ({pp})")
        chunks = _chunks(stage_params, vp)
    work = M * vp
    ticks = work + pp - 1
    fn = stage_function(stage_fn, remat)
    h, aux_sum, ys = None, None, []
    for t in range(ticks):
        u = min(max(t - rank, 0), work - 1)
        g, w = divmod(u, pp * vp)
        r, i = divmod(w, pp)
        m = min(g * pp + i, M - 1)
        args = (chunks[r], _stage_input(rank == 0 and r == 0, h_mb[m], h,
                                        pp))
        if extra_mb is not None:
            extra = extra_mb[m]
            if virtual_pipeline_size is not None:
                extra = fold_in(extra, r)
            args += (extra,)
        with span("pp_stage"):
            out = fn(*args)
        if returns_aux:
            out, aux = out
            aux_sum = _add_aux(aux_sum, aux, 0 <= t - rank <= work - 1, pp)
        ys.append(out)
        if t < ticks - 1:
            # the last tick's hop would carry nothing anyone reads
            if pp > 1:
                with span("pp_ring_shift"):
                    h = _ring_shift(out, axis_name)
            else:
                h = out
    # microbatch m = g*pp+i finishes chunk vp-1 on the last stage at tick
    # g*pp*vp + (vp-1)*pp + i + (pp-1)
    outs = [ys[(m // pp) * pp * vp + (vp - 1) * pp + m % pp + pp - 1]
            for m in range(M)]
    if returns_aux:
        return outs, aux_sum / work
    return outs


def finish(params, ys, loss_of, aux, scale, leaves, specs=None):
    """Differentiate this rank's share of JAX's replicated loss (the
    last stage's mean over dp × sp ranks; the aux over pp × dp × sp) and
    return ``(loss, grads)`` as the drivers do. Only the last stage runs
    the loss head (``loss_of(ys)``: the microbatches' losses); every
    other stage starts its backward from its outputs ``ys`` with zero
    cotangents, which runs the same hops in reverse at no head cost (JAX
    masks the head's result on those stages instead)."""
    share = data_parallel_share()
    _, pp, rank = axis_info(PP_AXIS)
    if rank == pp - 1:
        mean = torch.stack(loss_of(ys)).mean()
        local = mean.float()  # one dtype across the pp ranks' all-reduce
        outputs, seeds = [mean * (scale / share)], [None]
    else:
        local = torch.zeros((), device=leaves[0].device)
        outs = [y for y in tree_leaves(ys) if y.requires_grad]
        outputs, seeds = outs, [torch.zeros_like(y) for y in outs]
    if aux is not None:
        outputs.append(aux * (scale / (share * pp)))
        seeds.append(None)
    grads = torch.autograd.grad(outputs, leaves, seeds, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    loss = replicate_loss(local.detach())
    if aux is not None:
        loss = loss + replicate_loss(aux.detach(), masked_axis=None)
    return loss, reduce_grads(params, grads, specs)


def drive_pipeline(spec: PipelineSpec, params: Pytree, batch, *,
                   num_microbatches: int, virtual_pipeline_size, mesh,
                   data_spec, loss_scale, remat: bool, dropout_key,
                   params_specs=None):
    """The body of the 1F1B and interleaved drivers: split and cut the
    batch, embed each microbatch, run the ring, differentiate."""
    check_dropout_spec(spec, dropout_key)
    scale = 1.0 if loss_scale is None else loss_scale
    with _installed(mesh):
        inputs, targets = batch
        inputs_mb = local_slice(split_microbatches(inputs, num_microbatches),
                                data_spec)
        targets_mb = local_slice(
            split_microbatches(targets, num_microbatches), data_spec)
        keys_mb = derive_microbatch_keys(dropout_key, num_microbatches)
        leaves = trainable_leaves(params)
        h_mb = embed_microbatches(spec.embed_fn, params["embed"], inputs_mb,
                                  keys_mb)
        ys = pipeline_ring(spec.stage_fn, params["stages"], h_mb,
                           num_microbatches=num_microbatches,
                           virtual_pipeline_size=virtual_pipeline_size,
                           remat=remat, returns_aux=spec.stage_aux,
                           extra_mb=keys_mb)
        aux = None
        if spec.stage_aux:
            ys, aux = ys

        def loss_of(ys):
            return [spec.loss_fn(params["head"], y,
                                 microbatch(targets_mb, m))
                    for m, y in enumerate(ys)]
        return finish(params, ys, loss_of, aux, scale, leaves, params_specs)


def forward_backward_pipelining_without_interleaving(
    spec: PipelineSpec,
    params: Pytree,
    batch: Tuple[Pytree, Pytree],
    *,
    num_microbatches: int,
    mesh=None,
    data_spec=P(None, DP_AXIS),
    loss_scale=None,
    remat: bool = True,
    dropout_key=None,
    params_specs=None,
) -> Tuple[torch.Tensor, Pytree]:
    """The driver (ref :155). ``batch = (inputs, targets)``, trees with a
    leading global-batch dim, split into ``[M, B/M, ...]`` microbatches
    and cut to this rank's slice by ``data_spec`` (default: the
    per-microbatch batch dim over dp). ``params = {"embed", "stages",
    "head"}`` is this rank's local tree (``stages``: this stage's params,
    the stage axis removed). Returns ``(mean_unscaled_loss, grads)``:
    the loss the same on every rank, the gradients of ``loss *
    loss_scale`` as the module docstring of ``schedules.common`` says.
    ``mesh`` defaults to the current one. ``params_specs`` (JAX's, e.g.
    ``gpt_pipeline_specs_tree(cfg)``) names the leaves sharded over dp,
    whose gradients are not summed over it (the experts of a MoE model);
    None: every leaf replicated over dp.

    ``dropout_key`` (a threefry key; the spec built with
    ``takes_dropout_key``) derives one key per microbatch, delivered to
    the embed and stage functions; the model folds the stage rank (GPT's
    ``_layer_stack``). An ``EncDecPipelineSpec`` runs the
    encoder-decoder driver, as JAX's does."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_enc_dec import (  # noqa: E501
        EncDecPipelineSpec,
        forward_backward_pipelining_enc_dec,
    )

    if isinstance(spec, EncDecPipelineSpec):
        return forward_backward_pipelining_enc_dec(
            spec, params, batch, num_microbatches=num_microbatches,
            mesh=mesh, data_spec=data_spec, loss_scale=loss_scale,
            remat=remat, dropout_key=dropout_key)
    return drive_pipeline(
        spec, params, batch, num_microbatches=num_microbatches,
        virtual_pipeline_size=None, mesh=mesh, data_spec=data_spec,
        loss_scale=loss_scale, remat=remat, dropout_key=dropout_key,
        params_specs=params_specs)
