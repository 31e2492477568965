"""Data parallelism (counterpart of ``apex_tpu/parallel``): the mesh over
``torch.distributed`` (``mesh``), process bootstrap and the spawn helper
(``multiproc``), DDP and ``Reducer`` (``distributed``), SyncBatchNorm
across devices (``sync_batchnorm``), LARC, and ``ParallelismPlan``
(``plan``: the mesh shape, the data strategy — DDP, ZeRO-1's
``contrib.optimizers``, ``fsdp`` — and the wire policies as one object).
Tensor, sequence and pipeline parallelism are ROADMAP A7c-d."""

# the optimizers package imports LARC back: load it first
import apex_tpu_torch.optimizers  # noqa: F401
from apex_tpu_torch.parallel.larc import LARC, larc_transform  # noqa: F401
from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    DP_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    Mesh,
    build_hybrid_mesh,
    build_mesh,
    get_mesh,
    model_parallel_axes,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
)


def __getattr__(name):
    if name in ("DistributedDataParallel", "Reducer"):
        from apex_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    if name == "ParallelismPlan":
        from apex_tpu_torch.parallel.plan import ParallelismPlan

        return ParallelismPlan
    raise AttributeError(
        f"module 'apex_tpu_torch.parallel' has no attribute {name!r}")
