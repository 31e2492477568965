"""The single-device parts of ``apex_tpu/parallel`` ported so far: LARC and
``SyncBatchNorm``'s one-device path (``sync_batchnorm``: a named mesh
axis raises). The mesh, DDP and the cross-device statistics are
multi-device (ROADMAP A7)."""

# the optimizers package imports LARC back: load it first
import apex_tpu_torch.optimizers  # noqa: F401
from apex_tpu_torch.parallel.larc import LARC, larc_transform  # noqa: F401
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    DP_AXIS,
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
)
