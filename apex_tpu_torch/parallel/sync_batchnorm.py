"""SyncBatchNorm's one-device path (counterpart of
``apex_tpu/parallel/sync_batchnorm.py``).

JAX's module computes its own statistics, and so does this one: fp32 sum
and sum of squares over every axis but the channel one, mean = sum /
count, var = sum_sq / count - mean² clamped at 0 (JAX clamps what its
E[x²] − E[x]² cancellation can push below 0), the running var updated
with the unbiased m / (m − 1) of the batch's variance. PyTorch's
``F.batch_norm`` forms another variance and is not used. Channels are
last (NHWC), as JAX's layout; ``channel_last=False`` takes channel-first
input (what :func:`convert_syncbn_model` makes of a ``nn.BatchNorm*``).

The cross-device statistics (a named mesh axis, the process groups of
:func:`create_syncbn_process_group`) are ROADMAP A7: ``axis_name`` other
than ``None`` raises, JAX's default ``"dp"`` included (JAX runs that
default only inside a mesh).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from apex_tpu_torch._device import DeviceLike, resolve_device

DP_AXIS = "dp"   # JAX's data-parallel mesh axis name (apex_tpu.parallel.mesh)


def _refuse_axis(axis_name) -> None:
    if axis_name is not None:
        raise ValueError(
            f"SyncBatchNorm over the mesh axis {axis_name!r}: cross-device "
            f"statistics are multi-device work (ROADMAP A7); pass "
            f"axis_name=None for this device's batch")


def create_syncbn_process_group(group_size: int, world_size: int):
    """JAX's grouping: ``world_size`` ranks in contiguous groups of
    ``group_size`` (``None`` for one group); the groups' collectives are
    ROADMAP A7."""
    if group_size == 0 or group_size >= world_size:
        return None
    if world_size % group_size != 0:
        raise ValueError(
            f"group_size {group_size} must divide world size {world_size}")
    return [list(range(i, i + group_size))
            for i in range(0, world_size, group_size)]


def sync_batch_stats(x: torch.Tensor, reduce_axes: Sequence[int],
                     axis_name: Optional[str] = None,
                     axis_index_groups=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, var, count) per channel in fp32 over ``reduce_axes`` (JAX's
    ``sync_batch_stats`` on one device: the packed sums, the clamped
    variance); a named axis raises (ROADMAP A7)."""
    _refuse_axis(axis_name)
    x32 = x.float()
    dims = tuple(reduce_axes)
    total = x32.sum(dims)
    total_sq = (x32 * x32).sum(dims)
    count = 1
    for a in dims:
        count *= x.shape[a]
    # a tensor divisor: torch divides by a Python number through its
    # reciprocal on the card, XLA by the number itself
    n = torch.full_like(total, float(count))
    mean = total / n
    var = torch.clamp(total_sq / n - mean * mean, min=0.0)
    return mean, var, n


class SyncBatchNorm(nn.Module):
    """JAX's ``SyncBatchNorm`` on one device, with flax's names: params
    ``scale`` and ``bias`` (``param_dtype``), running statistics ``mean``
    and ``var`` as fp32 buffers (flax's ``batch_stats``). Call
    ``module(x, use_running_average=False)``; training updates the
    running statistics in place (JAX returns them)."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = DP_AXIS,
                 axis_index_groups=None,
                 param_dtype: torch.dtype = torch.float32,
                 fuse_relu: bool = False, channel_last: bool = True,
                 device: DeviceLike = None):
        super().__init__()
        _refuse_axis(axis_name)
        dev = resolve_device(device)
        self.features, self.momentum, self.eps = features, momentum, eps
        self.affine, self.track_running_stats = affine, track_running_stats
        self.axis_name, self.axis_index_groups = axis_name, axis_index_groups
        self.fuse_relu, self.channel_last = fuse_relu, channel_last
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))
        if affine:
            self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype,
                                                 device=dev))
            self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                                 device=dev))

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        ch = x.dim() - 1 if self.channel_last else 1
        reduce_axes = tuple(a for a in range(x.dim()) if a != ch)
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        if use_running_average and self.track_running_stats:
            mean, var = self.mean, self.var
        else:
            mean, var, m = sync_batch_stats(x, reduce_axes)
            if self.track_running_stats:
                with torch.no_grad():
                    unbiased = var * m / torch.clamp(m - 1.0, min=1.0)
                    self.mean.copy_((1 - self.momentum) * self.mean
                                    + self.momentum * mean)
                    self.var.copy_((1 - self.momentum) * self.var
                                   + self.momentum * unbiased)
        y = ((x.float() - mean.reshape(shape))
             * torch.rsqrt(var + self.eps).reshape(shape))
        if self.affine:
            y = y * self.scale.reshape(shape) + self.bias.reshape(shape)
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def convert_syncbn_model(module: nn.Module, axis_name: Optional[str] = DP_AXIS
                         ) -> nn.Module:
    """Apex's ``convert_syncbn_model``: every ``nn.BatchNorm*`` submodule,
    recursively, replaced by a :class:`SyncBatchNorm` of its features,
    momentum, eps and affine flags over its channel-first input, its
    weight, bias and running statistics carried across (the module itself
    when it is one). ``axis_name`` other than ``None`` raises (ROADMAP
    A7)."""
    _refuse_axis(axis_name)
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        p = next(module.parameters(), None)
        out = SyncBatchNorm(
            module.num_features,
            momentum=0.1 if module.momentum is None else module.momentum,
            eps=module.eps, affine=module.affine,
            track_running_stats=module.track_running_stats, axis_name=None,
            param_dtype=torch.float32 if p is None else p.dtype,
            channel_last=False,
            device=(p.device if p is not None else
                    module.running_mean.device
                    if module.running_mean is not None else "cpu"))
        with torch.no_grad():
            if module.affine:
                out.scale.copy_(module.weight)
                out.bias.copy_(module.bias)
            if module.track_running_stats:
                out.mean.copy_(module.running_mean)
                out.var.copy_(module.running_var)
        return out
    for name, child in list(module.named_children()):
        setattr(module, name, convert_syncbn_model(child, axis_name))
    return module
