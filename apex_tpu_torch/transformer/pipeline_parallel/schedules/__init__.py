"""Schedule selection (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/__init__.py``; ref
``schedules/__init__.py:16-39``)."""

from __future__ import annotations

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (  # noqa: F401
    PipelineSpec,
    build_model,
    split_microbatches,
    stage_params_spec,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_enc_dec import (  # noqa: F401
    EncDecPipelineSpec,
    broadcast_from_last_stage,
    decoder_ring,
    forward_backward_pipelining_enc_dec,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_no_pipelining import (  # noqa: F401
    forward_backward_no_pipelining,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_with_interleaving import (  # noqa: F401
    forward_backward_pipelining_with_interleaving,
    pipeline_ring_interleaved,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: F401
    forward_backward_pipelining_without_interleaving,
    pipeline_ring,
)


def get_forward_backward_func(
    virtual_pipeline_model_parallel_size=None,
    pipeline_model_parallel_size=None,
):
    """Pick the driver as the reference does (``schedules/__init__.py:16``)
    from the arguments or, where one is None, ``parallel_state``: pp > 1
    with a virtual size → interleaved; pp > 1 → 1F1B; else the
    gradient-accumulation loop."""
    from apex_tpu_torch.transformer import parallel_state

    if pipeline_model_parallel_size is None:
        pipeline_model_parallel_size = (
            parallel_state.get_pipeline_model_parallel_world_size())
    if virtual_pipeline_model_parallel_size is None:
        virtual_pipeline_model_parallel_size = (
            parallel_state.get_virtual_pipeline_model_parallel_world_size())
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining
