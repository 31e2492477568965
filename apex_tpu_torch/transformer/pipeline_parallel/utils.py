"""Pipeline-parallel utilities (counterpart of
``apex_tpu/transformer/pipeline_parallel/utils.py``).

Reference: ``apex/transformer/pipeline_parallel/utils.py`` — microbatch
calculator setup (:58), DP loss averaging (:242), params-l2-norm (:213),
memory report (:253), GPT left-to-right mask builder (:303).

The collectives run over the current mesh's axes
(``parallel.mesh.axis_info``: none on an axis of one rank or with no mesh
installed). The norm and clipping stay on the device: no value is read
back to the host.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.optimizers._common import tree_leaves, tree_map
from apex_tpu_torch.parallel.mesh import DP_AXIS, axis_info
from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (
    NumMicroBatchesCalculator,
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import all_reduce

_GLOBAL_NUM_MICROBATCHES_CALCULATOR: Optional[NumMicroBatchesCalculator] = None


def setup_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    """Ref utils.py:58-80 (singleton with re-init guard)."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise RuntimeError(
            "num microbatches calculator is already initialized")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size,
    )


def _ensure_calculator() -> NumMicroBatchesCalculator:
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None:
        raise RuntimeError(
            "num microbatches calculator is not initialized; call "
            "setup_microbatch_calculator() first"
        )
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def destroy_microbatch_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def get_num_microbatches() -> int:
    return _ensure_calculator().get()


def get_current_global_batch_size() -> int:
    return _ensure_calculator().get_current_global_batch_size()


def get_micro_batch_size() -> int:
    return _ensure_calculator().micro_batch_size


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True) -> None:
    _ensure_calculator().update(consumed_samples, consistency_check)


# ---------------------------------------------------------------------------


def average_losses_across_data_parallel_group(losses: Sequence[Any],
                                              axis_name: str = DP_AXIS):
    """Ref utils.py:242-252: the stacked losses averaged over the dp
    axis."""
    stacked = torch.stack([torch.as_tensor(l) for l in losses])
    return all_reduce(stacked, axis_name) / axis_info(axis_name)[1]


def _spec_axes(spec) -> set:
    """Mesh axis names a PartitionSpec entry shards over."""
    out = set()
    for entry in (spec or ()):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out.add(a)
    return out


def _with_specs(params, specs):
    """``(leaf, spec)`` pairs in the JAX tree order (spec None without
    ``specs``)."""
    if specs is None:
        return [(p, None) for p in tree_leaves(params)]
    if isinstance(params, dict):
        return [pair for k in sorted(params)
                for pair in _with_specs(params[k], specs[k])]
    if isinstance(params, (list, tuple)):
        return [pair for p, s in zip(params, specs)
                for pair in _with_specs(p, s)]
    return [(params, specs)]


def calc_params_l2_norm(params: Any, model_parallel_axes: Sequence[str] = (),
                        specs: Any = None):
    """Global parameter L2 norm (ref utils.py:213-240), a 0-d fp32 tensor.

    Without ``specs``: the local sum of squares summed over every axis of
    ``model_parallel_axes`` (each leaf taken as sharded over each). With
    ``specs`` (a PartitionSpec tree matching ``params``): each leaf's sum
    over only the model-parallel axes that shard that leaf, so a
    tp-replicated leaf counts once (the reference's
    ``param_is_not_tensor_parallel_duplicate``). The total is then made
    the same on every rank of those axes (JAX's ``pmax``)."""
    mp = set(model_parallel_axes)
    total = None
    for p, spec in _with_specs(params, specs):
        sq = p.float().square().sum()
        for a in sorted(_spec_axes(spec) & mp if specs is not None else mp):
            sq = all_reduce(sq, a)
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros(())
    for a in sorted(mp):
        total = all_reduce(total, a, op=dist.ReduceOp.MAX)
    return total.sqrt()


def clip_grad_norm(grads: Any, max_norm: float,
                   model_parallel_axes: Sequence[str] = (),
                   specs: Any = None):
    """Global-norm gradient clipping (Megatron's ``clip_grad_norm_fp32``
    with :func:`calc_params_l2_norm`'s dedup rules). Returns
    ``(clipped_grads, global_norm)``; the scale stays on the device."""
    norm = calc_params_l2_norm(grads, model_parallel_axes, specs)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def report_memory(name: str = "") -> str:
    """Ref utils.py:253-270: each local CUDA device's allocated and peak
    bytes (``torch.cuda.memory_allocated`` / ``max_memory_allocated``), or
    a line saying there is no CUDA device; logged and returned."""
    if torch.cuda.is_available():
        lines = [
            f"[{name}] cuda:{d}: in_use="
            f"{torch.cuda.memory_allocated(d) / 2**20:.1f}MiB "
            f"peak={torch.cuda.max_memory_allocated(d) / 2**20:.1f}MiB"
            for d in range(torch.cuda.device_count())]
    else:
        lines = [f"[{name}] no CUDA device"]
    report = "\n".join(lines)
    logging.getLogger(__name__).info("%s", report)
    return report


# ---------------------------------------------------------------------------


def get_ltor_masks_and_position_ids(
    data: torch.Tensor,
    eod_token: int,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """Build GPT left-to-right masks + position ids (ref utils.py:303-367).

    Returns ``(attention_mask, loss_mask, position_ids)`` with the
    reference's conventions: attention_mask boolean with True = MASKED OUT
    (``(b, 1, seq, seq)``), loss_mask float (0 at eod with
    ``eod_mask_loss``), position_ids ``(b, seq)``. The per-document reset
    is JAX's vectorized form: a token's document is the count of eod tokens
    before it; attention is also masked across documents and positions
    restart at each document's first token."""
    b, seq = data.shape
    dev = data.device
    causal = torch.tril(torch.ones((seq, seq), dtype=torch.bool, device=dev))
    attention_mask = causal.expand(b, 1, seq, seq)

    loss_mask = torch.ones((b, seq), dtype=torch.float32, device=dev)
    if eod_mask_loss:
        loss_mask = torch.where(data == eod_token, 0.0, loss_mask)

    idx = torch.arange(seq, device=dev).expand(b, seq)
    position_ids = idx

    if reset_position_ids or reset_attention_mask:
        prev_is_eod = torch.cat(
            [torch.zeros((b, 1), dtype=torch.bool, device=dev),
             (data == eod_token)[:, :-1]], dim=1)
        doc_id = torch.cumsum(prev_is_eod.to(torch.int32), dim=1)
        if reset_attention_mask:
            same_doc = doc_id[:, :, None] == doc_id[:, None, :]
            attention_mask = attention_mask & same_doc[:, None, :, :]
        if reset_position_ids:
            doc_start = torch.where(prev_is_eod, idx, 0)
            doc_start = torch.cummax(doc_start, dim=1).values
            position_ids = idx - doc_start

    return ~attention_mask, loss_mask, position_ids


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def print_rank_0(message: str) -> None:
    """Print on global rank 0 only (ref ``pipeline_parallel/utils.py:
    159-168``); every process prints without a process group."""
    if _rank_and_world()[0] == 0:
        print(message, flush=True)


def print_rank_last(message: str) -> None:
    """Print on the last global rank only (ref ``:170-177``)."""
    rank, world = _rank_and_world()
    if rank == world - 1:
        print(message, flush=True)
