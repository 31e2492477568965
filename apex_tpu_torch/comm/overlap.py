"""Decomposed collective matmuls — a collective hidden behind partial
products on a ring (counterpart of ``apex_tpu/comm/overlap.py``).

A dependent collective→matmul chain (``all_gather(x) @ w``, ``psum(x @
w)``) makes every product wait for the collective. Decomposed into a ring,
each hop travels while a partial product that does not depend on it runs
(Wang et al., arXiv:2305.06942). Four ops, each a
``torch.autograd.Function`` whose backward rides rings too, as JAX's
``custom_vjp``\\ s do:

``all_gather_matmul(x, w)``
    ``all_gather(x, gather_axis) @ w`` — Megatron-SP's entry fused with
    the column-parallel product. Exact (the gathered dim is not
    contracted). Backward: dX on a :func:`matmul_reduce_scatter` ring, dW
    on a second gather ring of x.
``matmul_reduce_scatter(x, w)``
    ``reduce_scatter(x @ w, scatter_axis)`` — Megatron-SP's exit fused
    with the row-parallel product: a travelling accumulator visits every
    rank once. Backward: one gather ring over the cotangent, dX slices and
    dW partials a hop.
``matmul_all_reduce(x, w)``
    ``psum(x @ w)``: the reduce-scatter ring, then a ring broadcast.
    Backward is local: the row-parallel backward (every tp rank holds the
    whole cotangent of the replicated output, Megatron's contract).
``matmul_param_gather(x, w_shard)``
    ``x @ all_gather(w_shard, -1)`` — FSDP position, the weight gathered
    over dp. Backward: dX on a weight re-gather ring, dW on a travelling
    accumulator that reduce-scatters the dp-summed gradient into the
    shard.

A hop is a pair of point-to-point ops posted together through
``dist.batch_isend_irecv`` (send to one neighbour, receive from the
other) before the partial product it hides behind, then waited on before
the next hop: posting a send and its receive one after the other
deadlocks a two-rank ring. ``bidirectional`` gather rings run two
counter-rotating streams, ⌈(W-1)/2⌉ hops deep. dW partials sum in fp32
and round once, as JAX's ``_contract_leading``. On an axis of one rank
every op is its plain product.

:func:`ring_shift` is one such hop alone, differentiable (its backward
hops the cotangent back): the einsum ring attention's K / V hops and the
pipeline schedules' stage-to-stage shifts.

Every hop enters the open ``comm.accounting`` records as a
``collective-permute`` of its bytes; each ring op enters the open
overlap records (``accounting.record_overlap``) with its hops, the hops
that had a product issued while in flight, its products and its wire
bytes, which :func:`accounting.overlap_report` sums. The ``*_wire_bytes``
models are JAX's and agree with ``collective_report`` op for op.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.comm import accounting
from apex_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, axis_info

__all__ = [
    "ring_shift",
    "all_gather_matmul",
    "matmul_param_gather",
    "matmul_reduce_scatter",
    "matmul_all_reduce",
    "all_gather_matmul_wire_bytes",
    "matmul_param_gather_wire_bytes",
    "matmul_reduce_scatter_wire_bytes",
    "matmul_all_reduce_wire_bytes",
]

_TAG = "overlap"


# ---------------------------------------------------------------------------
# wire-byte models (JAX's; the collective_report agreement contract)


def all_gather_matmul_wire_bytes(shard_elems: int, itemsize: int,
                                 world: int) -> float:
    """Bytes on the wire per device of one ring all-gather-matmul whose
    input shard has ``shard_elems`` elements: ``W-1`` hops of the shard,
    the monolithic all-gather's ``b_full·(W-1)/W``."""
    if world <= 1:
        return 0.0
    return float(shard_elems) * itemsize * (world - 1)


def matmul_param_gather_wire_bytes(shard_elems: int, itemsize: int,
                                   world: int, backward: bool = False
                                   ) -> float:
    """One FSDP-position gather ring over a weight shard of
    ``shard_elems`` elements: ``W-1`` hops of the shard; ``backward``
    adds the backward pair, the re-gather (shard bytes again) and the
    fp32 travelling dW accumulator."""
    if world <= 1:
        return 0.0
    fwd = float(shard_elems) * itemsize * (world - 1)
    if not backward:
        return fwd
    return fwd + float(shard_elems) * 4 * (world - 1)


def matmul_reduce_scatter_wire_bytes(shard_elems: int, itemsize: int,
                                     world: int) -> float:
    """One matmul-reduce-scatter ring whose output shard has
    ``shard_elems`` elements: ``W-1`` hops of the accumulator, the
    monolithic reduce-scatter's ``b_shard·(W-1)``."""
    if world <= 1:
        return 0.0
    return float(shard_elems) * itemsize * (world - 1)


def matmul_all_reduce_wire_bytes(shard_elems: int, itemsize: int,
                                 world: int) -> float:
    """The reduce-scatter ring and the broadcast ring over the result's
    1/W shard: ``2·b_shard·(W-1)``, the monolithic all-reduce's
    ``2·b_full·(W-1)/W``."""
    if world <= 1:
        return 0.0
    return 2.0 * float(shard_elems) * itemsize * (world - 1)


# ---------------------------------------------------------------------------
# ring plumbing


class _Ring:
    """One ring op's hops and products, entered into the open overlap
    records when the op ends."""

    def __init__(self, name: str, axis_name: str):
        self.name = name
        self.group, self.world, self.index = axis_info(axis_name)
        self.hops = self.hidden = self.products = 0
        self.wire = self.hidden_wire = 0.0

    def peer(self, shift: int) -> int:
        return dist.get_global_rank(self.group,
                                    (self.index + shift) % self.world)

    def post(self, sends: List[Tuple[torch.Tensor, int]]) -> "_Hop":
        """Post one hop of each ``(tensor, shift)`` stream: send to rank
        ``index + shift``, receive the same shape from ``index − shift``."""
        ops, outs, nbytes = [], [], 0
        for t, shift in sends:
            t = t.contiguous()
            out = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, self.peer(shift),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, out, self.peer(-shift),
                                  self.group))
            outs.append((t, out))
            b = t.numel() * t.element_size()
            nbytes += b
            accounting.note("collective-permute", b, self.world, _TAG)
        self.wire += nbytes
        return _Hop(self, dist.batch_isend_irecv(ops), outs, nbytes)

    def mm(self, a, b):
        """A partial product (counted for the overlap record)."""
        self.products += 1
        return torch.matmul(a, b)

    def contract(self, a, b):
        """dW partial: every leading dim of ``a`` against ``b``'s, fp32."""
        self.products += 1
        return torch.matmul(a.reshape(-1, a.shape[-1]).t().float(),
                            b.reshape(-1, b.shape[-1]).float())

    def done(self):
        accounting.note_ring(self.name, self.world, self.hops, self.hidden,
                             self.products, self.wire, self.hidden_wire)


class _Hop:
    def __init__(self, ring: _Ring, reqs, outs, nbytes: int):
        self.ring, self.reqs, self.outs = ring, reqs, outs
        self.nbytes = nbytes
        self.products_at_post = ring.products
        ring.hops += len(outs)

    def wait(self):
        for r in self.reqs:
            r.wait()
        if self.ring.products > self.products_at_post:
            self.ring.hidden += len(self.outs)
            self.ring.hidden_wire += self.nbytes
        return [out for _, out in self.outs]


class _Shift(torch.autograd.Function):
    """One ring hop (send to ``index + shift``), differentiable: the
    backward sends the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, axis_name, shift, name):
        ctx.args = (axis_name, shift, name)
        ring = _Ring(name, axis_name)
        out, = ring.post([(x, shift)]).wait()
        ring.done()
        return out

    @staticmethod
    def backward(ctx, g):
        axis_name, shift, name = ctx.args
        return _Shift.apply(g, axis_name, -shift, name), None, None, None


def ring_shift(x, axis_name: str, shift: int = 1,
               name: str = "ring_shift"):
    """``x`` of the rank ``shift`` places before this one on the axis
    (``lax.ppermute`` over the ring ``i -> i + shift``): one hop, entered
    into the open records under ``name``. Differentiable: the cotangent
    hops back. On an axis of one rank ``x`` itself, no hop."""
    if axis_info(axis_name)[1] == 1:
        return x
    return _Shift.apply(x, axis_name, shift, name)


def _gather_ring(ring: _Ring, x, bidirectional: bool):
    """Yield ``(chunk, src)`` for every rank's shard of ``x``; the next hop
    is posted before the current chunk is yielded, so the caller's product
    on it hides the hop. Unidirectional: one stream receiving from the
    right (``W-1`` hops); bidirectional: two counter-rotating streams."""
    world, idx = ring.world, ring.index
    if world == 1:
        yield x, idx
        return
    if not bidirectional:
        chunk = x
        for t in range(world):
            hop = ring.post([(chunk, -1)]) if t < world - 1 else None
            yield chunk, (idx + t) % world
            if hop is not None:
                chunk, = hop.wait()
        return
    k_plus, k_minus = world // 2, (world - 1) // 2

    def post(t, plus, minus):
        sends = []
        if t <= k_plus:
            sends.append((plus, -1))
        if t <= k_minus:
            sends.append((minus, 1))
        return ring.post(sends) if sends else None

    plus = minus = x
    hop = post(1, plus, minus)
    yield x, idx
    for t in range(1, k_plus + 1):
        got = hop.wait()
        plus = got[0]
        if t <= k_minus:
            minus = got[1]
        hop = post(t + 1, plus, minus)
        yield plus, (idx + t) % world
        if t <= k_minus:
            yield minus, (idx - t) % world


def _slice(x, src: int, size: int, axis: int):
    return x.narrow(axis, src * size, size)


def _place(out, part, src: int, size: int, axis: int):
    out.narrow(axis, src * size, size).copy_(part)


def _rs_ring(ring: _Ring, x, kernel, scatter_axis: int):
    """reduce_scatter(x @ kernel, scatter_axis): the accumulator for shard
    d starts at rank d + 1, moves right, and each rank adds its partial
    product for the shard it holds while the hop is in flight."""
    world, idx = ring.world, ring.index
    s = x.shape[scatter_axis]
    if s % world:
        raise ValueError(
            f"matmul_reduce_scatter needs dim {scatter_axis} ({s}) "
            f"divisible by the axis size ({world})")
    size = s // world
    acc = ring.mm(_slice(x, (idx - 1) % world, size, scatter_axis), kernel)
    for t in range(1, world):
        hop = ring.post([(acc, 1)])
        part = ring.mm(_slice(x, (idx - 1 - t) % world, size,
                              scatter_axis), kernel)
        acc, = hop.wait()
        acc = acc + part
    return acc


def _gather_placed(ring: _Ring, shard, axis: int, bidirectional: bool,
                   fn=None, out_last: Optional[int] = None):
    """``cat_src fn(chunk_src)`` along ``axis``, every chunk's result
    placed as it arrives (``fn`` None: the chunks themselves)."""
    out = None
    size = shard.shape[axis]
    for chunk, src in _gather_ring(ring, shard, bidirectional):
        part = chunk if fn is None else fn(chunk)
        if out is None:
            shape = list(part.shape)
            shape[axis] = size * ring.world
            out = part.new_empty(shape)
        _place(out, part, src, size, axis)
    return out


# ---------------------------------------------------------------------------
# the ops


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, axis_name, gather_axis, bidirectional):
        ctx.args = (axis_name, gather_axis, bidirectional)
        ctx.save_for_backward(x, kernel)
        ring = _Ring("all_gather_matmul", axis_name)
        y = _gather_placed(ring, x, gather_axis, bidirectional,
                           lambda c: ring.mm(c, kernel))
        ring.done()
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        axis_name, gather_axis, bidirectional = ctx.args
        ring = _Ring("all_gather_matmul.dx", axis_name)
        dx = _rs_ring(ring, dy, kernel.t(), gather_axis)
        ring.done()
        ring = _Ring("all_gather_matmul.dw", axis_name)
        size = x.shape[gather_axis]
        dw = None
        for chunk, src in _gather_ring(ring, x, bidirectional):
            part = ring.contract(chunk, _slice(dy, src, size, gather_axis))
            dw = part if dw is None else dw + part
        ring.done()
        return dx.to(x.dtype), dw.to(kernel.dtype), None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, axis_name, scatter_axis):
        ctx.args = (axis_name, scatter_axis)
        ctx.save_for_backward(x, kernel)
        ring = _Ring("matmul_reduce_scatter", axis_name)
        y = _rs_ring(ring, x, kernel, scatter_axis)
        ring.done()
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        axis_name, scatter_axis = ctx.args
        ring = _Ring("matmul_reduce_scatter.bwd", axis_name)
        size = dy.shape[scatter_axis]
        kt = kernel.t()
        dx, dw = None, None
        for chunk, src in _gather_ring(ring, dy, False):
            part = ring.mm(chunk, kt)
            if dx is None:
                shape = list(part.shape)
                shape[scatter_axis] = size * ring.world
                dx = part.new_empty(shape)
            _place(dx, part, src, size, scatter_axis)
            p_dw = ring.contract(_slice(x, src, size, scatter_axis), chunk)
            dw = p_dw if dw is None else dw + p_dw
        ring.done()
        return dx.to(x.dtype), dw.to(kernel.dtype), None, None


class _MatmulAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, axis_name, scatter_axis):
        ctx.save_for_backward(x, kernel)
        ring = _Ring("matmul_all_reduce", axis_name)
        shard = _rs_ring(ring, x, kernel, scatter_axis)
        y = _gather_placed(ring, shard, scatter_axis, False)
        ring.done()
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dx = torch.matmul(dy, kernel.t()).to(x.dtype)
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t().float(),
                          dy.reshape(-1, dy.shape[-1]).float())
        return dx, dw.to(kernel.dtype), None, None


class _MatmulParamGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_shard, axis_name, bidirectional):
        ctx.args = (axis_name,)
        ctx.save_for_backward(x, w_shard)
        ring = _Ring("matmul_param_gather", axis_name)
        n_loc = w_shard.shape[-1]
        y = None
        for chunk, src in _gather_ring(ring, w_shard, bidirectional):
            part = ring.mm(x, chunk)
            if y is None:
                y = part.new_empty(part.shape[:-1] + (n_loc * ring.world,))
            _place(y, part, src, n_loc, part.dim() - 1)
        ring.done()
        return y

    @staticmethod
    def backward(ctx, dy):
        # two counter-rotating rings in one loop: the weight re-gather
        # (received from the right) feeds the dX partials, the dW
        # accumulator (moving right) collects the dp sum of this shard;
        # each hop travels behind the next dW partial
        x, w_shard = ctx.saved_tensors
        ring = _Ring("matmul_param_gather.bwd", ctx.args[0])
        world, idx = ring.world, ring.index
        n_loc = w_shard.shape[-1]
        col = dy.dim() - 1

        def dx_part(src, chunk):
            ring.products += 1
            return torch.matmul(_slice(dy, src, n_loc, col).float(),
                                chunk.t().float())

        chunk = w_shard
        dx = dx_part(idx, chunk)
        acc = ring.contract(x, _slice(dy, (idx - 1) % world, n_loc, col))
        for t in range(1, world):
            hop = ring.post([(chunk, -1), (acc, 1)])
            p_dw = ring.contract(x, _slice(dy, (idx - 1 - t) % world, n_loc,
                                           col))
            chunk, acc = hop.wait()
            acc = acc + p_dw
            dx = dx + dx_part((idx + t) % world, chunk)
        ring.done()
        return dx.to(x.dtype), acc.to(w_shard.dtype), None, None


def _world(axis_name: str) -> int:
    return axis_info(axis_name)[1]


def all_gather_matmul(x, kernel, *, axis_name: str = TP_AXIS,
                      gather_axis: int = 1, bidirectional: bool = False):
    """``all_gather(x, gather_axis) @ kernel`` with the gather on a ring of
    partial products. ``x``: this rank's shard; ``kernel``: ``(in,
    out)``. Exact against the monolithic form."""
    if _world(axis_name) == 1:
        return torch.matmul(x, kernel)
    return _AllGatherMatmul.apply(x, kernel, axis_name,
                                  gather_axis % x.dim(), bool(bidirectional))


def matmul_reduce_scatter(x, kernel, *, axis_name: str = TP_AXIS,
                          scatter_axis: int = 1):
    """``reduce_scatter(x @ kernel, scatter_axis)`` with the scatter on a
    travelling-accumulator ring; ``x`` is whole along ``scatter_axis``
    (divisible by the axis size). Equal to the monolithic form up to the
    ring's order of the sum."""
    if _world(axis_name) == 1:
        return torch.matmul(x, kernel)
    return _MatmulReduceScatter.apply(x, kernel, axis_name,
                                      scatter_axis % x.dim())


def matmul_all_reduce(x, kernel, *, axis_name: str = TP_AXIS,
                      scatter_axis: int = 1):
    """``psum(x @ kernel)``: the reduce-scatter ring, then a ring
    broadcast; ``scatter_axis`` (the internal shard) divisible by the
    axis size."""
    if _world(axis_name) == 1:
        return torch.matmul(x, kernel)
    return _MatmulAllReduce.apply(x, kernel, axis_name,
                                  scatter_axis % x.dim())


def matmul_param_gather(x, w_shard, *, axis_name: str = DP_AXIS,
                        bidirectional: bool = False):
    """``x @ all_gather(w_shard, axis=-1)`` with the weight gather on a ring
    of partial products (FSDP position). ``w_shard``: this rank's ``(in,
    out/W)`` column shard. Forward exact; dW is this rank's shard of the
    dp-SUMMED weight gradient."""
    if _world(axis_name) == 1:
        return torch.matmul(x, w_shard)
    return _MatmulParamGather.apply(x, w_shard, axis_name,
                                    bool(bidirectional))
