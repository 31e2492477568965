"""ZeRO-style distributed optimizers (counterpart of
``apex_tpu/contrib/optimizers``; reference ``apex/contrib/optimizers``):
``DistributedFusedAdam`` and ``DistributedFusedLAMB`` keep fp32 master
and moment shards, 1/dp of each leaf, over the mesh's ``dp`` axis
(``_sharding``: reduce-scatter, the Adam / LAMB tail on the shard,
all-gather)."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (  # noqa: F401
    DistAdamState,
    DistributedFusedAdam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (  # noqa: F401
    DistLambState,
    DistributedFusedLAMB,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB"]
