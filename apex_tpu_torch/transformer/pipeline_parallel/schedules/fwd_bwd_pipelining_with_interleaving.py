"""Interleaved (virtual-pipeline) schedule: the circular ring
(counterpart of ``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_with_interleaving.py``).

Reference: ``fwd_bwd_pipelining_with_interleaving.py:25-300`` — each
stage holds ``vp`` model chunks; chunk ``v`` on stage ``s`` owns layer
block ``v * pp + s``; microbatches visit stages 0..pp-1 for chunk 0, wrap
back to stage 0 for chunk 1, and so on, which shrinks the bubble by ≈ vp.

JAX's design, kept: the ring's wrap-around (stage pp-1 → stage 0) feeds
the next chunk. Microbatches go in groups of ``pp`` (``M % pp == 0``, the
reference's assertion); within a group the pp microbatches in flight
circle the ring ``vp`` times, and groups follow each other with no
bubble but the global fill / drain of pp-1 ticks. Tick → work item (u =
t - rank, clipped): group ``g = u // (pp·vp)``, chunk ``r = (u mod
pp·vp) // pp``, microbatch ``m = g·pp + u mod pp``. Every index is known
on the host, so a tick picks its chunk's params from the ``[vp, ...]``
stack unbound once. The tick loop and the driver's body are the 1F1B
schedule's (``pipeline_ring`` and ``drive_pipeline`` given the virtual
size): with vp = 1 the map above is 1F1B's.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from apex_tpu_torch.parallel.mesh import DP_AXIS, PP_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineSpec,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: E501
    drive_pipeline,
    pipeline_ring,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import P

Pytree = Any


def pipeline_ring_interleaved(
    stage_fn: Callable[..., Pytree],
    chunk_params: Pytree,
    h_mb,
    *,
    num_microbatches: int,
    virtual_pipeline_size: int,
    axis_name: str = PP_AXIS,
    remat: bool = True,
    returns_aux: bool = False,
    keys_mb=None,
):
    """The circular ring: ``pipeline_ring`` over this stage's ``[vp,
    ...]`` chunk stack. Returns the M final-chunk outputs, valid on the
    last stage; with ``returns_aux``, ``(outputs, aux_mean)`` (the aux
    averaged over this stage's real (microbatch, chunk) ticks).
    ``keys_mb`` (M threefry keys) calls ``stage_fn(params, h,
    fold_in(key_m, r))``: chunks on one stage share its pp rank, so the
    chunk index is folded."""
    return pipeline_ring(stage_fn, chunk_params, h_mb,
                         num_microbatches=num_microbatches,
                         virtual_pipeline_size=virtual_pipeline_size,
                         axis_name=axis_name, remat=remat,
                         returns_aux=returns_aux, extra_mb=keys_mb)


def forward_backward_pipelining_with_interleaving(
    spec: PipelineSpec,
    params: Pytree,
    batch: Tuple[Pytree, Pytree],
    *,
    num_microbatches: int,
    virtual_pipeline_size: int,
    mesh=None,
    data_spec=P(None, DP_AXIS),
    loss_scale=None,
    remat: bool = True,
    dropout_key=None,
    params_specs=None,
) -> Tuple[torch.Tensor, Pytree]:
    """The driver (ref :25): the non-interleaved driver's contract, with
    ``params["stages"]`` this stage's ``[vp, ...]`` chunk stack (JAX's
    ``[vp, pp, ...]`` at this rank's pp index) and the chunk index folded
    into each tick's dropout key (``params_specs`` as there).
    Encoder-decoder specs are refused, as the reference does."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_enc_dec import (  # noqa: E501
        EncDecPipelineSpec,
    )

    if isinstance(spec, EncDecPipelineSpec):
        raise ValueError(
            "the interleaved schedule supports encoder-or-decoder models "
            "only; use forward_backward_pipelining_without_interleaving for "
            "encoder-decoder specs"
        )
    return drive_pipeline(
        spec, params, batch, num_microbatches=num_microbatches,
        virtual_pipeline_size=virtual_pipeline_size, mesh=mesh,
        data_spec=data_spec, loss_scale=loss_scale, remat=remat,
        dropout_key=dropout_key, params_specs=params_specs)
