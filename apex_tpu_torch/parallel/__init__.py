"""The single-device parts of ``apex_tpu/parallel`` ported so far: LARC.
The mesh, DDP and sync-batchnorm pieces are multi-device (ROADMAP A7)."""

# the optimizers package imports LARC back: load it first
import apex_tpu_torch.optimizers  # noqa: F401
from apex_tpu_torch.parallel.larc import LARC, larc_transform  # noqa: F401
