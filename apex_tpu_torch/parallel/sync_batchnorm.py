"""Synchronized BatchNorm (counterpart of
``apex_tpu/parallel/sync_batchnorm.py``).

JAX's module computes its own statistics, and so does this one: fp32 sum
and sum of squares over every axis but the channel one, packed with the
count as ``[sum, sum_sq, count]``; across devices one all-reduce of the
pack over the mesh axis (JAX: one ``lax.psum``); mean = sum / count, var
= sum_sq / count - mean² clamped at 0, the running var updated with the
unbiased m / (m − 1) of the batch's variance. PyTorch's ``F.batch_norm``
forms another variance and is not used. Channels are last (NHWC), as
JAX's layout; ``channel_last=False`` takes channel-first input (what
:func:`convert_syncbn_model` makes of a ``nn.BatchNorm*``).

The all-reduce carries an autograd rule (its backward all-reduces the
gradient, the transpose of JAX's psum), so the backward's ``mean_dy`` /
``mean_dy_xmu`` sums cross the devices as in the reference. BN groups
(:func:`create_syncbn_process_group`) are JAX's: every rank all-gathers
the packs of the whole axis and sums its own contiguous group in rank
order, so every member of a group adds in one order (no subgroup is
made). ``axis_name=None`` is this device's batch; a named axis needs the
current mesh (``parallel.mesh.build_mesh``), as JAX's needs its mesh
program.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.comm import collectives as cc
from apex_tpu_torch.parallel.mesh import DP_AXIS, resolve_axis


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group, differentiable: the backward sums the
    gradient over the group (the transpose of ``lax.psum``)."""

    @staticmethod
    def forward(ctx, t, group, world, tag):
        ctx.group, ctx.world, ctx.tag = group, world, tag
        return cc.all_reduce(t.clone(), group, world, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return (cc.all_reduce(g.clone(), ctx.group, ctx.world,
                              tag=ctx.tag + ".grad"), None, None, None)


class _AllGather(torch.autograd.Function):
    """Every rank's tensor stacked in rank order, differentiable: the
    backward sums each rank's slot of the gradient over the group back to
    that rank (a reduce-scatter, the transpose of ``lax.all_gather``)."""

    @staticmethod
    def forward(ctx, t, group, world, tag):
        ctx.group, ctx.world, ctx.tag = group, world, tag
        out = cc.all_gather(t.unsqueeze(0), group, world, tag=tag)
        return out

    @staticmethod
    def backward(ctx, g):
        return (cc.reduce_scatter(g, ctx.group, ctx.world,
                                  tag=ctx.tag + ".grad")[0],
                None, None, None)


def create_syncbn_process_group(group_size: int, world_size: int):
    """JAX's grouping: ``world_size`` ranks in contiguous groups of
    ``group_size`` (``None`` for one group), the ``axis_index_groups``
    argument of :func:`sync_batch_stats`."""
    if group_size == 0 or group_size >= world_size:
        return None
    if world_size % group_size != 0:
        raise ValueError(
            f"group_size {group_size} must divide world size {world_size}")
    return [list(range(i, i + group_size))
            for i in range(0, world_size, group_size)]


def _reduce_pack(packed: torch.Tensor, axis_name, axis_index_groups):
    group, world, index = resolve_axis(axis_name)
    if axis_index_groups is None:
        return _AllReduceSum.apply(packed, group, world, "sync_batch_stats")
    gsize = len(axis_index_groups[0])
    if any(list(g) != list(range(i * gsize, (i + 1) * gsize))
           for i, g in enumerate(axis_index_groups)) or \
            gsize * len(axis_index_groups) != world:
        raise ValueError(
            "axis_index_groups must be contiguous, uniform, and aligned "
            "(group i covers ranks [i*gsize, (i+1)*gsize)) — the groups "
            "create_syncbn_process_group produces")
    gathered = _AllGather.apply(packed, group, world, "sync_batch_stats")
    first = (index // gsize) * gsize
    total = gathered[first]
    for r in range(first + 1, first + gsize):
        total = total + gathered[r]
    return total


def sync_batch_stats(x: torch.Tensor, reduce_axes: Sequence[int],
                     axis_name=None, axis_index_groups=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, var, total count) per channel in fp32 over ``reduce_axes``
    and, with ``axis_name`` (a mesh axis name or a process group), over
    the axis (or each rank's group of ``axis_index_groups``): one
    all-reduce (or all-gather) of the packed ``[sum, sum_sq, count]``,
    differentiable."""
    x32 = x.float()
    dims = tuple(reduce_axes)
    total = x32.sum(dims)
    count = 1
    for a in dims:
        count *= x.shape[a]
    packed = torch.stack([total, (x32 * x32).sum(dims),
                          torch.full_like(total, float(count))])
    if axis_name is not None:
        packed = _reduce_pack(packed, axis_name, axis_index_groups)
    total, total_sq, n = packed.unbind(0)
    # a tensor divisor: torch divides by a Python number through its
    # reciprocal on the card, XLA by the number itself
    mean = total / n
    var = torch.clamp(total_sq / n - mean * mean, min=0.0)
    return mean, var, n


class SyncBatchNorm(nn.Module):
    """JAX's ``SyncBatchNorm`` with flax's names: params ``scale`` and
    ``bias`` (``param_dtype``), running statistics ``mean`` and ``var`` as
    fp32 buffers (flax's ``batch_stats``). Call ``module(x,
    use_running_average=False)``; training updates the running statistics
    in place (JAX returns them). ``axis_name`` (JAX's default ``"dp"``)
    and ``axis_index_groups`` take the statistics across devices, on the
    current mesh; ``None`` is this device's batch."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = DP_AXIS,
                 axis_index_groups=None,
                 param_dtype: torch.dtype = torch.float32,
                 fuse_relu: bool = False, channel_last: bool = True,
                 device: DeviceLike = None):
        super().__init__()
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
            mean, var, m = sync_batch_stats(x, reduce_axes, self.axis_name,
                                            self.axis_index_groups)
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


def convert_syncbn_model(module: nn.Module, axis_name=DP_AXIS,
                         axis_index_groups=None) -> nn.Module:
    """Apex's ``convert_syncbn_model``: every batch norm of ``module``,
    recursively (the module itself when it is one), becomes a
    :class:`SyncBatchNorm` over ``axis_name`` (and ``axis_index_groups``).
    A ``nn.BatchNorm*`` becomes one of its features, momentum, eps and
    affine flags over its channel-first input, its weight, bias and
    running statistics copied across; a :class:`SyncBatchNorm` is set to
    the axis in place (a model may also hold its norms in plain lists, as
    ``models.resnet``'s blocks do)."""
    if isinstance(module, SyncBatchNorm):
        # in place: a model may hold its norms in plain lists too
        module.axis_name = axis_name
        module.axis_index_groups = axis_index_groups
        return module
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        p = next(module.parameters(), None)
        out = SyncBatchNorm(
            module.num_features,
            momentum=0.1 if module.momentum is None else module.momentum,
            eps=module.eps, affine=module.affine,
            track_running_stats=module.track_running_stats,
            axis_name=axis_name, axis_index_groups=axis_index_groups,
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
        setattr(module, name,
                convert_syncbn_model(child, axis_name, axis_index_groups))
    return module
