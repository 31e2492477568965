"""Encoder-decoder (T5-style) pipeline schedule (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/fwd_bwd_enc_dec.py``).

Reference: ``apex/transformer/pipeline_parallel/schedules/common.py:72-96``
(``ModelType.encoder_and_decoder``: ranks before
``pipeline_model_parallel_split_rank`` hold encoder blocks, the rest
decoder blocks) and the two-tensor p2p plumbing of the 1F1B schedule.

JAX's design, kept: two pipelined phases over the SAME pp ring instead of
a static split. Every stage holds one encoder chunk and one decoder
chunk. Ring #1 runs the encoder; the last stage's per-microbatch encoder
outputs are made the same on every stage by one masked all-reduce
(:func:`broadcast_from_last_stage`; its backward all-reduces the decoder
stages' memory cotangents and hands them to the last stage); ring #2 runs
the decoder, stage ``r`` at tick ``t`` cross-attending to the memory of
microbatch ``t - r``. ``parallel_state`` keeps the split-rank accessors
as bookkeeping. The interleaved schedule refuses encoder-decoder specs,
as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from apex_tpu_torch.monitor.trace import span
from apex_tpu_torch.optimizers._common import tree_map
from apex_tpu_torch.parallel.mesh import DP_AXIS, PP_AXIS, axis_info
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    _installed,
    check_dropout_spec,
    derive_microbatch_keys,
    embed_microbatches,
    local_slice,
    microbatch,
    split_microbatches,
    trainable_leaves,
    where_rank,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: E501
    finish,
    pipeline_ring,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import P

Pytree = Any


@dataclasses.dataclass(frozen=True)
class EncDecPipelineSpec:
    """The encoder-decoder pipelined model contract
    (``ModelType.encoder_and_decoder``'s ``model_provider_func`` analogue,
    ref common.py:80-103).

    enc_embed_fn(embed_params, enc_inputs_mb) -> enc_hidden
    enc_stage_fn(enc_stage_params, h) -> h
        One encoder stage (``num_enc_layers / pp`` layers).
    dec_embed_fn(embed_params, dec_inputs_mb) -> dec_hidden
    dec_stage_fn(dec_stage_params, h, memory) -> h
        One decoder stage: self-attention, cross-attention over
        ``memory`` (the encoder output of the SAME microbatch), MLP.
    loss_fn(head_params, h, targets_mb) -> scalar
    takes_dropout_key
        The embed and stage functions take a trailing per-microbatch key
        (``enc_stage_fn(p, h, key)``, ``dec_stage_fn(p, h, memory,
        key)``); per-side and per-stage folds are the model's.
    """

    enc_embed_fn: Callable[[Pytree, Pytree], Pytree]
    enc_stage_fn: Callable[[Pytree, Pytree], Pytree]
    dec_embed_fn: Callable[[Pytree, Pytree], Pytree]
    dec_stage_fn: Callable[[Pytree, Pytree, Pytree], Pytree]
    loss_fn: Callable[[Pytree, Pytree, Pytree], torch.Tensor]
    takes_dropout_key: bool = False


def broadcast_from_last_stage(x: Pytree, axis_name: str = PP_AXIS) -> Pytree:
    """The last pipeline stage's values on every stage: the other stages'
    (finite) fill / drain garbage selected out, then one all-reduce a
    leaf. Backward: the stages' cotangents all-reduced, kept on the last
    stage (JAX's transpose of the masked ``psum``)."""
    _, pp, rank = axis_info(axis_name)
    if pp == 1:
        return x

    def one(a):
        masked = where_rank(rank == pp - 1, a, torch.zeros_like(a))
        return copy_to_tensor_model_parallel_region(
            reduce_from_tensor_model_parallel_region(masked, axis_name),
            axis_name)

    return tree_map(one, x)


def decoder_ring(dec_fn: Callable, stage_params: Pytree, h_mb, mem_mb, *,
                 num_microbatches: int, axis_name: str = PP_AXIS,
                 remat: bool = True, keys_mb=None):
    """``pipeline_ring`` with a per-tick cross-attention memory operand:
    ``mem_mb`` holds the M encoder outputs, valid on every rank
    (:func:`broadcast_from_last_stage` first); ``keys_mb`` rides the same
    side channel, arriving as ``dec_fn(params, h, memory, key)``."""
    fn, extra = dec_fn, mem_mb
    if keys_mb is not None:
        extra = list(zip(mem_mb, keys_mb))

        def fn(p, h, mem_key):
            return dec_fn(p, h, *mem_key)

    return pipeline_ring(fn, stage_params, h_mb,
                         num_microbatches=num_microbatches,
                         axis_name=axis_name, remat=remat, extra_mb=extra)


def forward_backward_pipelining_enc_dec(
    spec: EncDecPipelineSpec,
    params: Pytree,
    batch: Tuple[Pytree, Pytree, Pytree],
    *,
    num_microbatches: int,
    mesh=None,
    data_spec=P(None, DP_AXIS),
    loss_scale=None,
    remat: bool = True,
    dropout_key=None,
) -> Tuple[torch.Tensor, Pytree]:
    """The encoder-decoder driver. ``batch = (enc_inputs, dec_inputs,
    targets)`` with a leading global-batch dim; ``params = {"embed",
    "enc_stages", "dec_stages", "head"}``, this rank's local tree (one
    encoder and one decoder chunk). Returns ``(mean_unscaled_loss,
    grads)`` as the 1F1B driver does. ``dropout_key`` delivers one key a
    microbatch to both rings' stage functions and both embeddings."""
    check_dropout_spec(spec, dropout_key)
    scale = 1.0 if loss_scale is None else loss_scale
    M = num_microbatches
    with _installed(mesh):
        enc_mb, dec_mb, tgt_mb = (
            local_slice(split_microbatches(a, M), data_spec) for a in batch)
        keys_mb = derive_microbatch_keys(dropout_key, M)
        leaves = trainable_leaves(params)
        with span("pp_encode"):
            h_enc = embed_microbatches(spec.enc_embed_fn, params["embed"],
                                       enc_mb, keys_mb)
            enc_out = pipeline_ring(spec.enc_stage_fn, params["enc_stages"],
                                    h_enc, num_microbatches=M, remat=remat,
                                    extra_mb=keys_mb)
        with span("pp_memory_broadcast"):
            mem_mb = broadcast_from_last_stage(
                torch.stack(enc_out)).unbind(0)
        with span("pp_decode"):
            h_dec = embed_microbatches(spec.dec_embed_fn, params["embed"],
                                       dec_mb, keys_mb)
            ys = decoder_ring(spec.dec_stage_fn, params["dec_stages"], h_dec,
                              mem_mb, num_microbatches=M, remat=remat,
                              keys_mb=keys_mb)

        def loss_of(ys):
            return [spec.loss_fn(params["head"], y, microbatch(tgt_mb, m))
                    for m, y in enumerate(ys)]
        return finish(params, ys, loss_of, None, scale, leaves)
