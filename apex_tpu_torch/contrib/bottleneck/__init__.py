"""ResNet bottleneck and its spatially split 3x3 conv (counterpart of
``apex_tpu/contrib/bottleneck``).

``Bottleneck`` is ``models.resnet.BottleneckBlock``. :func:`spatial_conv3x3`
is the reference ``SpatialBottleneck``'s middle conv on an NHWC tensor
whose H is split across the ``sp`` axis: each rank sends its top row to
the previous rank and its bottom row to the next
(``dist.batch_isend_irecv``; JAX: two ``lax.ppermute``), the boundary
ranks take zero rows, and the conv runs VALID in H over the haloed shard
(W zero-padded), giving exactly the rows the rank owns. The halo's
backward sends the halo rows' gradients back the other way, added into
the rows they came from.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch.comm import accounting
from apex_tpu_torch.models.resnet import BottleneckBlock as Bottleneck  # noqa: F401
from apex_tpu_torch.parallel.mesh import SP_AXIS, resolve_axis


def _swap(group, n: int, idx: int, to_prev, to_next, like):
    """Send ``to_prev`` to rank idx-1 and ``to_next`` to idx+1 along the
    group; returns (row from idx-1, row from idx+1), zeros at the ends."""
    from_prev, from_next = torch.zeros_like(like), torch.zeros_like(like)
    ops = []
    if idx > 0:
        peer = dist.get_global_rank(group, idx - 1)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if idx < n - 1:
        peer = dist.get_global_rank(group, idx + 1)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        row = like.numel() * like.element_size()
        for _ in range(len(ops) // 2):
            accounting.note("collective-permute", row, n, "halo_exchange")
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, idx):
        ctx.group, ctx.n, ctx.idx = group, n, idx
        ctx.shape = x.shape
        top, bot = x[:, :1], x[:, -1:]
        return _swap(group, n, idx, top, bot, top)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # the row from idx-1 was its bottom row: its gradient goes back
        # there; the row from idx+1 was its top row
        g_top, g_bot = _swap(ctx.group, ctx.n, ctx.idx, g_prev, g_next,
                             g_prev)
        dx = g_prev.new_zeros(ctx.shape)
        dx[:, :1] += g_top
        dx[:, -1:] += g_bot
        return dx, None, None, None


def _halo_exchange(x: torch.Tensor, axis_name=SP_AXIS):
    """(row from the previous rank, row from the next rank) of an NHWC
    ``x`` split along H over ``axis_name``: zeros at the boundary ranks."""
    group, n, idx = resolve_axis(axis_name)
    return _Halo.apply(x, group, n, idx)


def spatial_conv3x3(x: torch.Tensor, kernel: torch.Tensor,
                    axis_name=SP_AXIS) -> torch.Tensor:
    """3x3 ``SAME`` conv of an H-split NHWC ``x`` (B, H_local, W, Cin)
    with an HWIO ``kernel`` (3, 3, Cin, Cout): the rows this rank owns,
    (B, H_local, W, Cout)."""
    from_prev, from_next = _halo_exchange(x, axis_name)
    padded = torch.cat([from_prev, x, from_next], dim=1)
    out = F.conv2d(padded.permute(0, 3, 1, 2),
                   kernel.permute(3, 2, 0, 1), padding=(0, 1))
    return out.permute(0, 2, 3, 1)


__all__ = ["Bottleneck", "spatial_conv3x3"]
