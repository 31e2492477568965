"""Group BatchNorm (counterpart of ``apex_tpu/contrib/groupbn``).

The reference's ``BatchNorm2d_NHWC`` exchanges its statistics across a
``bn_group`` of GPUs through CUDA IPC. JAX's (and the port's) is a
:class:`~apex_tpu_torch.parallel.sync_batchnorm.SyncBatchNorm` over
contiguous groups of the dp axis (``create_syncbn_process_group``): NHWC
is the module's layout, BN + ReLU one module (``fuse_relu``).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from apex_tpu_torch.parallel.mesh import DP_AXIS
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    create_syncbn_process_group,
)


def BatchNorm2d_NHWC(num_features: int, fuse_relu: bool = False,
                     bn_group: int = 1, world_size: Optional[int] = None,
                     axis_name: str = DP_AXIS, **kw) -> SyncBatchNorm:
    """The reference's constructor: ``bn_group`` ranks share statistics
    (``bn_group=1``: this device's batch, no collective). ``world_size``
    defaults to the process group's, as JAX's to its device count."""
    if bn_group <= 1:
        return SyncBatchNorm(num_features, axis_name=None,
                             fuse_relu=fuse_relu, **kw)
    if world_size is None:
        if not dist.is_initialized():
            raise RuntimeError(
                "BatchNorm2d_NHWC(bn_group > 1) needs torch.distributed "
                "initialized (parallel.multiproc) or world_size=")
        world_size = dist.get_world_size()
    groups = create_syncbn_process_group(bn_group, world_size)
    return SyncBatchNorm(num_features, axis_name=axis_name,
                         axis_index_groups=groups, fuse_relu=fuse_relu, **kw)


__all__ = ["BatchNorm2d_NHWC", "create_syncbn_process_group"]
