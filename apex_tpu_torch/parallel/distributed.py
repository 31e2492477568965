"""Data-parallel gradient synchronization (counterpart of
``apex_tpu/parallel/distributed.py``).

JAX's DDP is a function of the gradient tree inside its mesh program:
leaves grouped per dtype into buckets of ~``message_size`` elements (in
tree order, dict keys sorted), each bucket flattened, optionally cast to
fp32, pre-divided, summed over the ``dp`` axis (``lax.psum``, or the
compressed all-reduce), post-scaled and split back. The port keeps the
function and its options, on tensors: ``grads`` is a tree (nested dicts,
lists) or an ordered list of gradient tensors, the sum one
``dist.all_reduce`` a bucket over the axis's process group (or
``comm.collectives.compressed_allreduce``).

Reduction order: the buckets are reduced last to first, as JAX emits
them (the backward finishes the last layers' gradients first). JAX's
scheduler overlaps them with independent work; here the uncompressed
all-reduces are issued ``async_op=True`` one after another, so NCCL runs
a bucket while the host flattens the next, and each is waited on before
its bucket is split back. Bucket contents, seeds and the metric labels
``comm_bucket{i}_bytes`` stay keyed by bucket index.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.comm import accounting
from apex_tpu_torch.comm.collectives import (CompressionConfig,
                                             all_reduce,
                                             allreduce_wire_bytes,
                                             compressed_allreduce,
                                             fold_seed)
from apex_tpu_torch.comm import error_feedback as ef
from apex_tpu_torch.optimizers._common import (tree_leaves, tree_map,
                                               tree_unflatten)
from apex_tpu_torch.parallel.mesh import DP_AXIS, resolve_axis


def _flatten_buckets(leaves: List[torch.Tensor], message_size: int):
    """Leaf indices grouped into buckets of ~``message_size`` elements per
    dtype, in leaf order: ``[(dtype, [i, ...]), ...]`` (JAX's grouping)."""
    buckets = []
    current: dict = {}
    counts: dict = {}
    for i, g in enumerate(leaves):
        dt = g.dtype
        current.setdefault(dt, []).append(i)
        counts[dt] = counts.get(dt, 0) + g.numel()
        if counts[dt] >= message_size:
            buckets.append((dt, current.pop(dt)))
            counts[dt] = 0
    for dt, idxs in current.items():
        if idxs:
            buckets.append((dt, idxs))
    return buckets


def _record_comm_metrics(metrics, bucket_bytes, baseline_bytes):
    """Per-bucket and total modeled wire bytes and the compression ratio
    into a ``monitor.Metrics`` (host scalars: no device work)."""
    total = float(sum(bucket_bytes.values()))
    base = float(sum(baseline_bytes.values()))
    entries = {f"comm_bucket{i}_bytes": bucket_bytes[i]
               for i in sorted(bucket_bytes)}
    entries["comm_wire_bytes"] = total
    entries["comm_compression_ratio"] = base / total if total else 1.0
    return metrics.record(**entries)


class DistributedDataParallel:
    """JAX's functional DDP: ``grads = ddp.average_gradients(grads)``
    after the backward, on the current mesh (``axis`` a mesh axis name,
    or a process group). The options are JAX's (and the reference's)."""

    def __init__(self, axis=DP_AXIS, message_size: int = 10_000_000,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 allreduce_always_fp32: bool = False,
                 flat_buckets: bool = True,
                 compression: Optional[CompressionConfig] = None):
        self.axis = axis
        self.message_size = message_size
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.flat_buckets = flat_buckets
        self.compression = compression

    def buckets(self, grads: Any):
        """The bucket list of ``grads``: ``[(dtype, [leaf index, ...])]``
        (one bucket a leaf without ``flat_buckets``)."""
        leaves = tree_leaves(grads)
        if not self.flat_buckets:
            return [(g.dtype, [i]) for i, g in enumerate(leaves)]
        return _flatten_buckets(leaves, self.message_size)

    def init_comm_state(self, grads_template: Any) -> Optional[Any]:
        """The error-feedback residuals (one fp32 leaf a gradient leaf)
        under an ``*_ef`` policy, else ``None``."""
        if self.compression is not None and self.compression.error_feedback:
            return ef.init_error_feedback(grads_template)
        return None

    def comm_state_dict(self, comm_state: Any) -> Optional[dict]:
        """The comm state for a checkpoint (``None`` stays ``None``)."""
        return None if comm_state is None else ef.state_dict(comm_state)

    def load_comm_state_dict(self, comm_state_template: Any,
                             d: Optional[dict]) -> Optional[Any]:
        """Inverse of :meth:`comm_state_dict`, checked against the live
        structure."""
        return None if d is None else ef.load_state_dict(
            comm_state_template, d)

    def replicate(self, params: Any) -> Any:
        """JAX marks the params per-replica so its AD does not insert a
        psum; a torch rank's gradients are its own already: ``params``."""
        return params

    def average_gradients(self, grads: Any, enabled: bool = True,
                          comm_state: Optional[Any] = None, seed=None,
                          metrics: Optional[Any] = None) -> Any:
        """The bucket pipeline: [flatten] → [fp32] → predivide → sum over
        the axis → post-scale (``predivide / world`` when averaging) →
        split back in each leaf's dtype. A new tree; ``grads`` is not
        written.

        With a compressing ``CompressionConfig`` the sum is
        :func:`~apex_tpu_torch.comm.collectives.compressed_allreduce`;
        under EF pass ``comm_state`` (:meth:`init_comm_state`). ``seed``
        (int) feeds stochastic rounding, folded with the bucket index.
        ``metrics`` (a ``monitor.Metrics``) records ``comm_bucket{i}_bytes``,
        ``comm_wire_bytes`` and ``comm_compression_ratio``. JAX's return
        convention: ``grads``, then the new comm state if one was passed,
        then the metrics if passed, as a tuple when more than one."""
        if not isinstance(enabled, bool):
            raise TypeError(
                f"enabled must be a static python bool, got {enabled!r}")
        cfg = self.compression
        compressing = cfg is not None and cfg.enabled
        if compressing and cfg.error_feedback and comm_state is None:
            raise ValueError(
                "compression policy 'int8_ef' carries state: pass comm_state="
                "ddp.init_comm_state(grads) and thread the returned state")
        bucket_bytes: dict = {}
        baseline_bytes: dict = {}

        def wrap(g, s):
            out = (g,)
            if comm_state is not None:
                out += (s,)
            if metrics is not None:
                out += (_record_comm_metrics(metrics, bucket_bytes,
                                             baseline_bytes),)
            return out[0] if len(out) == 1 else out

        if not enabled:
            return wrap(grads, comm_state)
        leaves = tree_leaves(grads)
        if not leaves:
            return wrap(grads, comm_state)
        group, world, _ = resolve_axis(self.axis)
        pre = 1.0 / self.gradient_predivide_factor
        post = (self.gradient_predivide_factor / world
                if self.gradient_average else 1.0)
        res_leaves = (tree_leaves(comm_state) if comm_state is not None
                      else None)
        new_res = list(res_leaves) if res_leaves is not None else None
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        pending = []   # (work, comm, bucket) of the async all-reduces

        def finish(comm, bi, idxs, r_new):
            if post != 1.0:
                comm = comm * post
            offset = 0
            for i in idxs:
                n = leaves[i].numel()
                out[i] = comm[offset:offset + n].reshape(
                    leaves[i].shape).to(leaves[i].dtype)
                if new_res is not None and r_new is not None:
                    new_res[i] = r_new[offset:offset + n].reshape(
                        res_leaves[i].shape)
                offset += n

        from apex_tpu_torch.monitor.trace import span

        with span("comm"):
            for bi, (dt, idxs) in reversed(list(enumerate(
                    self.buckets(leaves)))):
                if len(idxs) == 1:
                    flat = leaves[idxs[0]].reshape(-1)
                else:
                    flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
                n = flat.numel()
                base_item = (4 if self.allreduce_always_fp32
                             else flat.element_size())
                bucket_bytes[bi] = allreduce_wire_bytes(n, base_item, world,
                                                        cfg)
                baseline_bytes[bi] = allreduce_wire_bytes(n, base_item,
                                                          world, None)
                if compressing:
                    residual = None
                    if res_leaves is not None:
                        residual = torch.cat(
                            [res_leaves[i].reshape(-1) for i in idxs])
                    comm = flat.float()
                    if pre != 1.0:
                        comm = comm * pre
                    bseed = None if seed is None else fold_seed(seed, bi)
                    comm, r_new = compressed_allreduce(
                        comm, group, cfg, residual=residual, seed=bseed)
                    finish(comm, bi, idxs, r_new)
                    continue
                comm = flat.float() if self.allreduce_always_fp32 else flat
                if pre != 1.0:
                    comm = comm * pre
                if comm.data_ptr() == leaves[idxs[0]].data_ptr():
                    comm = comm.clone()     # never write the caller's leaf
                work = dist.all_reduce(comm, group=group, async_op=True)
                accounting.note("all-reduce", n * comm.element_size(),
                                world, "ddp")
                pending.append((work, comm, bi, idxs))
            for work, comm, bi, idxs in pending:
                work.wait()
                finish(comm, bi, idxs, None)
        reduced = tree_unflatten(grads, out)
        new_state = (tree_unflatten(comm_state, new_res)
                     if comm_state is not None else None)
        return wrap(reduced, new_state)

    def accumulate_and_average(self, value_and_grad_fn: Callable, params: Any,
                               microbatches: Any, *,
                               microbatch_keys: Optional[Any] = None,
                               unroll: int = 1, enabled: bool = True,
                               comm_state: Optional[Any] = None, seed=None,
                               metrics: Optional[Any] = None):
        """Gradient accumulation over the leading dim ``M`` of
        ``microbatches`` (a tree of tensors), then one
        :meth:`average_gradients`: the first ``M - 1`` microbatches summed
        from zeros in order, the last one's gradients added last (JAX's
        scan and its peeled step: the same association), the loss the
        mean. ``value_and_grad_fn(params, microbatch[, key]) -> (loss,
        grads)``. ``unroll`` is JAX's scan option and changes nothing
        here. Returns ``(mean_loss, grads[, comm_state][, metrics])``."""
        from apex_tpu_torch.monitor.trace import span

        leaves = tree_leaves(microbatches)
        if not leaves:
            raise ValueError("microbatches is an empty pytree")
        m = leaves[0].shape[0]

        def call(i):
            mb = tree_map(lambda x: x[i], microbatches)
            with span("fwd_bwd"):
                if microbatch_keys is None:
                    return value_and_grad_fn(params, mb)
                return value_and_grad_fn(params, mb, microbatch_keys[i])

        if m > 1:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
            gacc = tree_map(torch.zeros_like, params)
            for i in range(m - 1):
                l, g = call(i)
                loss_sum = loss_sum + l
                gacc = tree_map(torch.add, gacc, g)
            l_last, g_last = call(m - 1)
            loss_sum = loss_sum + l_last
            grads = tree_map(torch.add, gacc, g_last)
        else:
            loss_sum, grads = call(0)
        red = self.average_gradients(grads, enabled=enabled,
                                     comm_state=comm_state, seed=seed,
                                     metrics=metrics)
        red = red if isinstance(red, tuple) else (red,)
        return (loss_sum / m,) + red

    def broadcast_params(self, params: Any) -> Any:
        """Every rank on the axis gets rank 0's values: JAX's masked sum
        (rank 0's tensor, zeros elsewhere, summed), one all-reduce a
        leaf. A new tree."""
        group, world, index = resolve_axis(self.axis)
        return tree_map(lambda p: all_reduce(
            p.detach().clone() if index == 0 else torch.zeros_like(p),
            group, world, tag="broadcast_params"), params)


class Reducer:
    """Manual sync (the reference's ``Reducer``): :meth:`reduce` sums a
    tree over the axis, raw (no averaging)."""

    def __init__(self, axis=DP_AXIS):
        self.axis = axis

    def reduce(self, tree: Any) -> Any:
        group, world, _ = resolve_axis(self.axis)
        return tree_map(lambda g: all_reduce(g.detach().clone(), group,
                                             world, tag="reducer"), tree)

    def broadcast_params(self, params: Any) -> Any:
        return DistributedDataParallel(axis=self.axis).broadcast_params(
            params)
