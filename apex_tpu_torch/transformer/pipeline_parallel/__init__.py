"""Pipeline-model-parallel runtime (counterpart of
``apex_tpu/transformer/pipeline_parallel``; ref
``apex/transformer/pipeline_parallel/``)."""

from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication  # noqa: F401
from apex_tpu_torch.transformer.pipeline_parallel import utils  # noqa: F401
from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (  # noqa: F401
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    PipelineSpec,
    build_model,
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (  # noqa: F401
    average_losses_across_data_parallel_group,
    calc_params_l2_norm,
    clip_grad_norm,
    get_current_global_batch_size,
    get_ltor_masks_and_position_ids,
    get_micro_batch_size,
    get_num_microbatches,
    setup_microbatch_calculator,
    update_num_microbatches,
)
