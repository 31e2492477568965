"""apex_tpu_torch.fsdp — ZeRO-3 parameter sharding (counterpart of
``apex_tpu/fsdp``).

The third rung of the ZeRO ladder: ``parallel.DistributedDataParallel``
replicates everything, ``contrib.optimizers``' ``DistributedFusedAdam`` /
``LAMB`` shard the optimizer state, and :class:`FSDP` + :class:`FSDPAdam`
shard the parameters too: the forward gathers a leaf on demand (the model
dtype, or int8 / int4 codes on the wire), its backward reduce-scatters the
gradient straight into shard layout, and the optimizer steps only the
local shard through the Adam tail kernel. Configure it through
``parallel.ParallelismPlan`` (preset ``"fsdp"``).
"""

from apex_tpu_torch.fsdp.accounting import (  # noqa: F401
    fsdp_step_wire_bytes,
    hbm_params_bytes,
    hbm_reduction,
    param_gather_wire_bytes,
)
from apex_tpu_torch.fsdp.core import FSDP, LeafMeta  # noqa: F401
from apex_tpu_torch.fsdp.optim import FSDPAdam, FSDPAdamState  # noqa: F401

__all__ = [
    "FSDP",
    "FSDPAdam",
    "FSDPAdamState",
    "LeafMeta",
    "fsdp_step_wire_bytes",
    "hbm_params_bytes",
    "hbm_reduction",
    "param_gather_wire_bytes",
]
