"""FSDP (ZeRO-3) parameter sharding — gather on demand over the dp axis
(counterpart of ``apex_tpu/fsdp/core.py``).

Each dp rank owns a flat, block-aligned fp32 shard of every leaf (the
``contrib.optimizers._sharding`` layout); there is no replicated
parameter copy. The forward gathers a leaf when it is needed through
:class:`_GatherLeaf`, a ``torch.autograd.Function`` whose backward
reduce-scatters the gradient straight into shard layout: the dp sum and
the shard delivery are one collective. It saves nothing for the backward
(reshard after forward: the shapes come from the leaf's
:class:`LeafMeta`).

Wires: the gather carries the model dtype (the saturating fp32 → model
cast of ``_sharding.gather_leaf``), or with ``weight_gather`` the codec's
packed codes and fp32 block scales (``CompressionConfig.quantize`` /
``dequantize``: the quantize and dequantize kernels on the card); the
gradient reduce-scatter is fp32 or, with ``compression``,
``comm.collectives.compressed_psum_scatter``. Both are stateless, so
error feedback and stochastic rounding are refused.

:meth:`FSDP.linear` (the weight gather hidden behind partial GEMMs on a
ring, ``comm.overlap.matmul_param_gather``) is tensor-parallel machinery:
ROADMAP A7c.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from apex_tpu_torch.comm.collectives import (CompressionConfig, all_gather,
                                             compressed_psum_scatter,
                                             psum_scatter_wire_bytes)
from apex_tpu_torch.contrib.optimizers._sharding import (
    gather_leaf,
    scatter_leaf,
    shard_multiple_lcm,
    slice_leaf,
)
from apex_tpu_torch.optimizers._common import tree_leaves, tree_map
from apex_tpu_torch.parallel.mesh import DP_AXIS, resolve_axis

Pytree = Any


def dtype_name(dtype: torch.dtype) -> str:
    """JAX's name of a torch dtype (``torch.bfloat16`` → ``"bfloat16"``)."""
    return str(dtype).split(".")[-1]


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype JAX's name stands for."""
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    """A gathered leaf's full shape and dtype; the dtype by JAX's name
    (``"bfloat16"``), so records compare equal across the packages."""

    shape: tuple
    dtype: str

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _is_meta(x) -> bool:
    return isinstance(x, LeafMeta)


def _meta_leaves(tree) -> list:
    return [m for m in tree_leaves(tree) if _is_meta(m)]


def _gather_impl(shard, axis_name, shape, dtype, wg):
    n = math.prod(shape)
    if wg is not None and wg.compresses(n):
        # the shard rounded to the model dtype first (the wire carries what
        # the model sees), then codes + fp32 block scales; the shard is
        # block-aligned, so no block (or nibble pair) straddles two ranks
        group, world, _ = resolve_axis(axis_name)
        vals = shard.to(dtype).float()
        q, s = wg.quantize(vals)
        qf = all_gather(q, group, world, tag="fsdp_gather")
        sf = all_gather(s, group, world, tag="fsdp_gather")
        full = wg.dequantize(qf, sf)
        return full[:n].reshape(tuple(shape)).to(dtype)
    # uncompressed: the model dtype on the wire, as ZeRO-1's gather
    return gather_leaf(shard, shape, dtype, axis_name, transport_dtype=dtype)


class _GatherLeaf(torch.autograd.Function):
    """The gather of one leaf; its backward is the reduce-scatter of the
    gradient (fp32) into this rank's shard."""

    @staticmethod
    def forward(ctx, shard, engine, meta):
        ctx.engine = engine
        return _gather_impl(shard.detach(), engine.axis_name, meta.shape,
                            dtype_of(meta.dtype), engine.weight_gather)

    @staticmethod
    def backward(ctx, dy):
        engine = ctx.engine
        flat = dy.reshape(-1).float()
        rs = engine.compression
        if rs is not None and rs.enabled:
            g, _ = compressed_psum_scatter(flat, engine.axis_name, rs,
                                           shard_multiple=engine.shard_multiple)
        else:
            g = scatter_leaf(flat, engine.axis_name,
                             multiple=engine.shard_multiple)
        return g, None, None


@dataclasses.dataclass(frozen=True)
class FSDP:
    """The ZeRO-3 engine: shard layout, gather on demand, the gradient
    reduce-scatter, over one dp axis of the current mesh::

        fsdp = FSDP(compression=CompressionConfig("int8"))
        opt = FSDPAdam(fsdp=fsdp, lr=1e-3)
        meta = fsdp.meta(params)            # shapes and dtypes, once
        state = opt.init(params)            # fp32 master / moment shards
        masters = [m.requires_grad_() for m in tree_leaves(state.master)]
        loss = model_loss(fsdp.gather(state.master, meta), batch)
        g = torch.autograd.grad(loss, masters)   # dp-summed shard grads
        state = opt.step(tree_unflatten(state.master, list(g)), state)

    ``compression``: the gradient reduce-scatter's wire (``int8`` /
    ``int4``); ``weight_gather``: the parameter gather's codec. Shards
    are ``(k,)``, ``k`` aligned to the lcm of both codecs' blocks."""

    axis_name: str = DP_AXIS
    compression: Optional[CompressionConfig] = None
    weight_gather: Optional[CompressionConfig] = None
    bidirectional: bool = False

    def __post_init__(self):
        for name, cfg in (("compression", self.compression),
                          ("weight_gather", self.weight_gather)):
            if cfg is None:
                continue
            if cfg.error_feedback:
                raise ValueError(
                    f"FSDP {name} cannot carry error feedback: the "
                    "gather/reduce-scatter VJP is stateless — use policy "
                    "'int8' (ZeRO-1 DistributedFusedAdam supports "
                    "'int8_ef' on its grad leg)")
            if cfg.stochastic_rounding:
                raise ValueError(
                    f"FSDP {name} does not support stochastic_rounding "
                    "(no per-step seed reaches the stateless VJP)")

    @property
    def shard_multiple(self) -> int:
        return shard_multiple_lcm(self.compression, self.weight_gather)

    # -- layout ------------------------------------------------------------
    def meta(self, params_template: Pytree) -> Pytree:
        """:class:`LeafMeta` tree mirroring ``params_template`` (no device
        read)."""
        return tree_map(lambda p: LeafMeta(tuple(p.shape),
                                           dtype_name(p.dtype)),
                        params_template)

    def shard_params(self, params: Pytree) -> Pytree:
        """This rank's flat fp32 shard of every replicated leaf: the
        master, the one store of the parameters."""
        return tree_map(lambda p: slice_leaf(
            p.detach().float(), self.axis_name,
            multiple=self.shard_multiple), params)

    def policy_dtype(self, meta: Pytree) -> Optional[torch.dtype]:
        """The compute dtype the gathered forwards run in: the widest
        floating dtype under 4 bytes of ``meta``, else the widest floating
        one, ties broken by JAX's name; ``None`` without a floating
        leaf."""
        dts = {dtype_of(m.dtype) for m in _meta_leaves(meta)}
        dts = {d for d in dts if d.is_floating_point}
        if not dts:
            return None
        low = [d for d in dts if d.itemsize < 4]
        return max(low or dts, key=lambda d: (d.itemsize, dtype_name(d)))

    # -- forward -----------------------------------------------------------
    def gather_leaf(self, shard: torch.Tensor, meta: LeafMeta):
        return _GatherLeaf.apply(shard, self, meta)

    def gather(self, shards: Pytree, meta: Pytree) -> Pytree:
        """Full parameters in the model dtype from the shard tree, one
        gather a leaf under the ``comm`` span; the backward reduce-scatters
        each leaf's gradient into its shard."""
        from apex_tpu_torch.monitor.trace import span

        with span("comm"):
            return tree_map(self.gather_leaf, shards, meta)

    # -- the ring matmul path ----------------------------------------------
    def shard_linear_weight(self, w: torch.Tensor) -> torch.Tensor:
        """Column shard ``(in, out/W)`` of a 2-D weight, fp32."""
        if w.dim() != 2:
            raise ValueError(
                f"shard_linear_weight needs a 2-D kernel, got "
                f"{tuple(w.shape)}")
        _, world, idx = resolve_axis(self.axis_name)
        if w.shape[-1] % world:
            raise ValueError(
                f"linear weight out dim {w.shape[-1]} not divisible by "
                f"the {self.axis_name} axis size {world}")
        n_loc = w.shape[-1] // world
        return w.detach().float()[:, idx * n_loc:(idx + 1) * n_loc].clone()

    def linear(self, x, w_shard, dtype=None):
        raise NotImplementedError(
            "FSDP.linear rides comm.overlap.matmul_param_gather (the "
            "weight gather decomposed into a ring behind partial GEMMs), "
            "tensor-parallel machinery the port has not ported yet: "
            "ROADMAP A7c. Gather the leaf with FSDP.gather instead")

    # -- accounting --------------------------------------------------------
    def gather_wire_bytes(self, meta: Pytree, world: int) -> float:
        """Modeled wire bytes a device of one full parameter gather."""
        from apex_tpu_torch.fsdp.accounting import param_gather_wire_bytes

        return param_gather_wire_bytes(meta, world, self.weight_gather,
                                       self.shard_multiple)

    def reduce_wire_bytes(self, meta: Pytree, world: int) -> float:
        """Modeled wire bytes of the backward gradient reduce-scatter."""
        return sum((psum_scatter_wire_bytes(m.size, 4, world,
                                            self.compression,
                                            self.shard_multiple)
                    for m in _meta_leaves(meta)), 0.0)
