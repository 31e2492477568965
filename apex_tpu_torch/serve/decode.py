"""Paged attention and the GPT serve programs (counterpart of
``apex_tpu/serve/decode.py``): one device, or this rank's shards under
tensor parallelism.

Two halves:

* **paged attention** — :func:`paged_attention_reference`, the plain
  version (gather through the block tables, dequantizing int8/int4 pools,
  then ``attention_reference`` with a ``kpos >= ctx`` mask; ctx == 0 rows
  are zeros, as in the kernels), and :func:`paged_attention_fwd`, the
  wrapper of the CUDA kernels. :func:`_paged_route` picks them: bf16 and
  fp16 on the tensor cores (``csrc/paged_mma.cu``, counted as
  ``paged_mma_fwd``), fp32 on the CUDA cores (``csrc/paged_attention.cu``,
  ``paged_attention_fwd``), each at every head_dim % 8 == 0 up to
  :data:`PAGED_NARROW_HEAD_DIM`; above it every type takes the CUDA-core
  wide walk (``paged_wide_fwd``, the head dim in chunks), so every
  head_dim % 8 == 0 runs on the card. All walk the context in splits of a
  length :func:`_paged_splits` takes from the block table's capacity
  alone, rows of one group (``rows_per_table``) sharing each K/V tile,
  and merge the splits in order (:func:`paged_attention_split_reference`
  is the plain emulation). :func:`paged_attention` takes the plain
  version for CPU tensors and the kernels for CUDA tensors; a head_dim
  that is not a multiple of 8 takes the plain version on every device,
  with one warning per head_dim on the card, as JAX's gate sends it to
  its reference.

* **serve programs** — :func:`gpt_paged_forward` runs q tokens per slot
  against the paged cache (per-row math independent of q); the engine's
  three calls are thin wrappers: :func:`gpt_decode_step` (q=1),
  :func:`gpt_verify_step` (q=k+1) and :func:`gpt_prefill_chunk` (one
  slot, q=chunk). The layer stack is a Python loop over the stacked layer
  params (the JAX ``lax.scan``), and the K/V pools are written in place
  (where the JAX programs donated them). With ``adapters=`` each slot's
  rows add their LoRA adapter's delta (``serve.adapters.lora_delta``)
  after the qkv, out, fc1 and fc2 projections; ``gather_layer=`` is JAX's
  per-layer parameter hook; ``use_pallas=False`` runs the plain versions
  on every device. ``tp_axis=`` (a mesh axis, JAX's axis-optional TP
  plumbing): the params are this rank's Megatron shards
  (``gpt_param_specs``) and the pools hold ``num_heads / tp`` local
  heads; the qkv and fc1 projections are column-parallel, out and fc2
  row-parallel (an all-reduce exit; ``cfg.overlap_comm`` puts the exits
  of q > 1 calls with q % tp == 0 on ``comm.overlap``'s ring, decode's
  stay monolithic), the embedding vocab-parallel and the logits
  all-gathered over the vocab. Every serve entry point refuses a MoE
  model (:func:`ensure_dense_ffn`, JAX's text).

Row-count invariance: cuBLAS picks its GEMM algorithm per shape, and two
algorithms may sum a row's products in different orders. So every
projection runs its flat rows in tiles of exactly ``GEMM_ROW_TILE`` rows
(the last one zero-padded): a token's row goes through the same GEMM
whether it is decoded, verified or prefilled, and whatever else is in the
batch. That keeps speculative streams bitwise equal to plain decode on the
card, the property the JAX engine guarantees.
"""

from __future__ import annotations

import ctypes
import logging
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.parallel.mesh import axis_info
from apex_tpu_torch.ops.attention import NEG_INF, attention_reference
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.serve.adapters import lora_delta_rows, lora_rows
from apex_tpu_torch.serve.kv_cache import (KVCacheConfig, _dequant_rows_int4,
                                           gather_kv, paged_write)

Params = Dict[str, Any]
_log = logging.getLogger("apex_tpu_torch.serve")

_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
         + [ctypes.c_float, ctypes.c_void_p])
# the tensor-core and wide walks take q's type code too (ku.dtype_code),
# before the stream
_TYPED_ARGS = _ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {"paged_attention_fwd": _ARGS, "paged_wide_fwd": _TYPED_ARGS}
_MMA_SIGNATURES = {"paged_mma_fwd": _TYPED_ARGS}
# entry -> (csrc/<source>.cu, its ctypes table)
_ROUTES = {"paged_mma_fwd": ("paged_mma", _MMA_SIGNATURES),
           "paged_attention_fwd": ("paged_attention", _SIGNATURES),
           "paged_wide_fwd": ("paged_attention", _SIGNATURES)}
# the largest head dim of the two narrow walks; above it, paged_wide_fwd
PAGED_NARROW_HEAD_DIM = 256
PAGED_TILE = 64           # positions of the tensor-core kernel's K/V tile
_SPLIT_MIN_TILES = 2      # a split walks at least two tiles ...
_SPLITS_MAX = 64          # ... and a table at most this many splits
GEMM_ROW_TILE = 64


# ---------------------------------------------------------------------------
# Paged attention


def _nibble_dequant(packed, s, group: int):
    """int4 pool dequant: (.., bs, D/2) packed uint8 codes + (.., bs,
    D/group) bf16 group scales -> (.., bs, D) fp32, code x scale. The plain
    version of what the kernels do per staged tile (``dequant`` in
    ``csrc/paged_split.cuh``)."""
    return _dequant_rows_int4(packed, s, group, torch.float32)


def paged_attention_reference(q, cache_layer, cfg: KVCacheConfig,
                              block_tables, ctx_lens,
                              scale: Optional[float] = None):
    """q (n, H, D) against one layer's paged pools; ``ctx_lens`` (n,)
    tokens of context per row. Returns (n, H, D) in q.dtype: exactly
    ``attention_reference`` over the gathered K/V with a ``kpos >= ctx``
    mask, and zeros for rows with ``ctx == 0`` (where the JAX reference
    gives a finite junk row)."""
    k, v = gather_kv(cache_layer, cfg, block_tables)  # (n, H, S, D)
    kpos = torch.arange(k.shape[2], device=q.device)
    mask = kpos[None, None, None, :] >= ctx_lens[:, None, None, None]
    o = attention_reference(q[:, :, None], k, v, mask=mask, scale=scale)
    o = o[:, :, 0]
    return torch.where((ctx_lens > 0)[:, None, None], o, torch.zeros_like(o))


def kv_mode(cfg: KVCacheConfig) -> int:
    """The kernels' pool format code: 0 the model dtype, 1 int8 + fp32
    scales, 2 int4 nibble pairs + bf16 group scales."""
    if not cfg.quantized:
        return 0
    return 2 if cfg.bits == 4 else 1


def check_pools(what: str, cache_layer, cfg: KVCacheConfig, device,
                dtype) -> None:
    """The kernels' pool rules: one layer's contiguous, 16-byte aligned
    leaves on ``device`` of the shapes and types ``cfg`` gives (a
    full-precision pool in ``dtype``, the model's)."""
    kp = cache_layer["k"]
    h, d, bs = cfg.num_heads, cfg.head_dim, cfg.block_size
    blocks = kp.shape[1] if kp.dim() == 4 else -1
    mode = kv_mode(cfg)
    leaves = {"k": ((h, blocks, bs, d // 2 if mode == 2 else d),
                    (dtype, torch.int8, torch.uint8)[mode])}
    if mode == 1:
        leaves["k_scale"] = ((h, blocks, bs), torch.float32)
    elif mode == 2:
        leaves["k_scale"] = ((h, blocks, bs, d // cfg.kv_group),
                             torch.bfloat16)
    for name, (shape, dt) in list(leaves.items()):
        leaves[name.replace("k", "v", 1)] = (shape, dt)
    for name, (shape, dt) in leaves.items():
        pool = cache_layer.get(name)
        if not (pool is not None and pool.device == device
                and pool.dtype == dt and tuple(pool.shape) == shape
                and pool.is_contiguous() and pool.data_ptr() % 16 == 0):
            got = (None if pool is None
                   else (pool.dtype, tuple(pool.shape), pool.device))
            raise ValueError(f"{what}: pool {name} must be a contiguous "
                             f"16-byte aligned {shape} {dt} tensor on "
                             f"{device}, got {got}")


def _paged_route(dtype, d: int) -> str:
    """The kernel entry that runs paged attention for ``dtype`` queries of
    head dim ``d`` on the card, every d % 8 == 0: up to
    :data:`PAGED_NARROW_HEAD_DIM`, ``paged_mma_fwd`` (bf16 or fp16, tensor
    cores) or ``paged_attention_fwd`` (fp32, CUDA cores: the tensor cores
    would take fp32 as TF32); above it ``paged_wide_fwd`` for all three
    (CUDA cores, the head dim in chunks). d % 8 != 0 raises
    (:func:`paged_attention` sends it to the plain version before it gets
    here)."""
    ku.require(dtype in ku.KERNEL_DTYPES,
               f"paged attention takes fp32, bf16 or fp16 queries, got "
               f"{dtype}")
    ku.require(d > 0 and d % 8 == 0,
               f"paged attention: head_dim {d} is not a multiple of 8 (the "
               f"kernels take d % 8 == 0, as JAX's gate)")
    if d > PAGED_NARROW_HEAD_DIM:
        return "paged_wide_fwd"
    return "paged_mma_fwd" if dtype in ku.HALF_DTYPES else \
        "paged_attention_fwd"


def _paged_splits(capacity: int) -> Tuple[int, int]:
    """``(splits, positions a split covers)`` for a block table of
    ``capacity`` = max_blocks · block_size positions: splits of at least
    two 64-position tiles, at most :data:`_SPLITS_MAX` of them. A function
    of the capacity alone, never of the row count or the groups, so a
    token's partials start at the same positions in a decode, verify or
    prefill call."""
    tiles = max(1, -(-capacity // PAGED_TILE))
    per = max(_SPLIT_MIN_TILES, -(-tiles // _SPLITS_MAX))
    return -(-tiles // per), per * PAGED_TILE


def _check_groups(n: int, rows_per_table: int) -> None:
    ku.require(rows_per_table >= 1 and n % rows_per_table == 0,
               f"paged attention: {n} rows are not whole groups of "
               f"rows_per_table={rows_per_table}")


def paged_attention_split_reference(q, cache_layer, cfg: KVCacheConfig,
                                    block_tables, ctx_lens,
                                    scale: Optional[float] = None, *,
                                    rows_per_table: int = 1, parts: int = 1):
    """The plain emulation of the kernels' walk: each row reads the block
    table of its group's first row, its context is cut into
    :func:`_paged_splits` splits, each split into ``parts`` parts (4: the
    tensor-core kernel's warps, a quarter of every 64-position tile each),
    every part gives (m, l, acc) in fp32, a split's parts merge in order,
    then the row's live splits in order. Returns (n, H, D) in q.dtype,
    zeros where ctx == 0. Each row is computed alone, at shapes that do
    not depend on n or the groups."""
    n, h, d = q.shape
    _check_groups(n, rows_per_table)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mb = block_tables.shape[1]
    cap = mb * cfg.block_size
    splits, split_len = _paged_splits(cap)
    tables = block_tables[(torch.arange(n) // rows_per_table
                           * rows_per_table).to(block_tables.device)]
    k_all, v_all = gather_kv(cache_layer, cfg, tables)    # (n, H, cap, D)
    pad = splits * split_len - cap
    k_all = F.pad(k_all.float(), (0, 0, 0, pad))
    v_all = F.pad(v_all.float(), (0, 0, 0, pad))
    j = torch.arange(split_len, device=q.device)
    part_of = (j % PAGED_TILE) // (PAGED_TILE // parts)
    pos = torch.arange(splits * split_len, device=q.device).reshape(
        splits, split_len)
    out = torch.zeros_like(q)
    for i in range(n):
        c = min(max(int(ctx_lens[i]), 0), cap)
        if c == 0:
            continue
        kk = k_all[i].reshape(h, splits, split_len, d)
        vv = v_all[i].reshape(h, splits, split_len, d)
        s = (q[i].float()[:, None, None, :] * kk).sum(-1) * scale
        ms, ls, accs = [], [], []
        for w in range(parts):
            live = (part_of == w)[None, :] & (pos < c)       # (splits, SL)
            sw = torch.where(live, s, NEG_INF)
            m = sw.amax(-1)                                   # (H, splits)
            p = torch.where(live, torch.exp(sw - m[..., None]), 0.0)
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append((p[..., None] * vv).sum(-2))          # (H, S, D)
        # a split's parts merge first, in part order; then the row's live
        # splits, in split order
        m_s = torch.stack(ms).amax(0)                     # (H, splits)
        l_s = torch.zeros_like(m_s)
        acc_s = torch.zeros_like(accs[0])
        for m, l, acc in zip(ms, ls, accs):
            wgt = torch.exp(m - m_s)
            l_s = l_s + l * wgt
            acc_s = acc_s + acc * wgt[..., None]
        live = -(-c // split_len)
        mx = m_s[:, :live].amax(-1)
        tot_l = torch.zeros(h, device=q.device)
        tot = torch.zeros(h, d, device=q.device)
        for si in range(live):
            wgt = torch.exp(m_s[:, si] - mx)
            tot_l = tot_l + l_s[:, si] * wgt
            tot = tot + acc_s[:, si] * wgt[:, None]
        out[i] = (tot / tot_l[:, None]).to(q.dtype)
    return out


def paged_attention_fwd(q, cache_layer, cfg: KVCacheConfig, block_tables,
                        ctx_lens, scale: float, *, rows_per_table: int = 1):
    """Launch the paged-attention kernel :func:`_paged_route` picks on
    CUDA tensors (and the merge of its splits; one count under the entry's
    name). ``q`` (n, H, D) contiguous, fp32, bf16 or fp16; one layer's
    pools as ``cfg`` lays them out (full-precision pools in q's dtype; int8
    codes + fp32 scales; int4 nibble pairs + bf16 group scales, also for an
    fp16 model, as JAX's pools keep them); ``block_tables``
    (n, max_blocks) and ``ctx_lens`` (n,) integer. The rows [i·g, (i+1)·g)
    of a group (g = ``rows_per_table``, n % g == 0) share block-table row
    i·g, which the kernel reads for all of them (the other rows of the
    group are not read). A context longer than the row's blocks attends to
    the blocks it has."""
    ku.require(q.is_cuda and q.dim() == 3,
               f"paged_attention_fwd takes a 3-d CUDA q, got {q.device} "
               f"{tuple(q.shape)}")
    n, h, d = q.shape
    entry = _paged_route(q.dtype, d)
    _check_groups(n, rows_per_table)
    ku.require(h == cfg.num_heads and d == cfg.head_dim,
               f"paged_attention_fwd: q ({h} heads x {d}) does not match "
               f"the cache ({cfg.num_heads} x {cfg.head_dim})")
    check_pools("paged_attention_fwd", cache_layer, cfg, q.device, q.dtype)
    ku.require(q.is_contiguous() and q.data_ptr() % 16 == 0,
               "paged_attention_fwd: q must be contiguous and 16-byte "
               "aligned")
    ku.require(tuple(block_tables.shape[:1]) == (n,)
               and block_tables.dim() == 2
               and tuple(ctx_lens.shape) == (n,),
               "paged_attention_fwd: block_tables (n, max_blocks) and "
               "ctx_lens (n,) must match q's rows")
    ku.require(block_tables.device == q.device and ctx_lens.device == q.device,
               "paged_attention_fwd: block tables and lengths must be on "
               "q's device")
    ku.require(n <= 65535, f"paged_attention_fwd: {n} rows > 65535")
    bt = block_tables.to(torch.int32).contiguous()
    lens = ctx_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    source, table = _ROUTES[entry]
    splits, split_len = _paged_splits(bt.shape[1] * cfg.block_size)
    part = torch.empty(n * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    kp, vp = cache_layer["k"], cache_layer["v"]
    ks, vs = cache_layer.get("k_scale"), cache_layer.get("v_scale")
    typed = (ku.dtype_code(q.dtype),) if entry != "paged_attention_fwd" \
        else ()
    lib = ku.load_kernel(source, table)
    status = getattr(lib, entry)(
        q.device.index, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), out.data_ptr(), part.data_ptr(), n, h, d,
        kp.shape[1], cfg.block_size, bt.shape[1], kv_mode(cfg),
        cfg.kv_group, rows_per_table, splits, split_len, float(scale),
        *typed, ku.stream_handle(q))
    ku.count_launch(entry)
    ku.check_status(lib, status, entry)
    return out


# head dims whose reference dispatch on the card was already logged
_FALLBACK_WARNED: set = set()


def _warn_reference_fallback(head_dim: int) -> None:
    """Log once per head dim that a CUDA call took the plain version
    because head_dim % 8 != 0 (JAX's ``_warn_reference_fallback``)."""
    if head_dim in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(head_dim)
    _log.warning("paged_attention: head_dim %d %% 8 != 0 — taking the "
                 "plain gather + reference path on the card (expect a much "
                 "slower decode step; pad head_dim to a multiple of 8 to "
                 "get the kernels)", head_dim)


def paged_attention(q, cache_layer, cfg: KVCacheConfig, block_tables,
                    ctx_lens, scale: Optional[float] = None, *,
                    rows_per_table: int = 1,
                    use_pallas: Optional[bool] = None):
    """The plain version for CPU tensors, the kernels for CUDA tensors
    (raises on a shape they do not take). Same result as
    :func:`paged_attention_reference`, which ignores ``rows_per_table``:
    rows [i·g, (i+1)·g) share block-table row i·g (n % g == 0), so the
    kernels read each K/V tile once for the group. JAX's gate first: a
    head_dim that is not a multiple of 8 takes the plain version on every
    device, logged once per head_dim where the kernels would have run
    (a shape gate, not a fallback: a kernel that fails still raises).
    ``use_pallas``: ``False`` takes the plain version on every device,
    ``True`` the kernels (raising for CPU tensors)."""
    _check_groups(q.shape[0], rows_per_table)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kernel = ku.use_kernel_as_asked(q, use_pallas)
    if kernel and q.shape[-1] % 8 != 0:
        _warn_reference_fallback(q.shape[-1])
        kernel = False
    if not kernel:
        return paged_attention_reference(q, cache_layer, cfg, block_tables,
                                         ctx_lens, scale=scale)
    return paged_attention_fwd(q, cache_layer, cfg, block_tables, ctx_lens,
                               scale, rows_per_table=rows_per_table)


# ---------------------------------------------------------------------------
# Model pieces


def _dense(x, kernel, bias):
    """``x @ kernel + bias`` in x.dtype, over the flat rows in tiles of
    ``GEMM_ROW_TILE`` rows, so each row's sum order does not depend on the
    row count (see the module docstring)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    r = x2.shape[0]
    tiles = -(-r // GEMM_ROW_TILE)
    pad = tiles * GEMM_ROW_TILE - r
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    w = kernel.to(x.dtype)
    if tiles == 1:
        y = (x2 @ w)[:r]
    else:
        y = torch.cat([x2[i * GEMM_ROW_TILE:(i + 1) * GEMM_ROW_TILE] @ w
                       for i in range(tiles)])[:r]
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, y.shape[-1])


def _tp_size(tp_axis: Optional[str]) -> int:
    return 1 if tp_axis is None else axis_info(tp_axis)[1]


def _tiled(x, kernel):
    """The local product of a tp projection, in ``GEMM_ROW_TILE``-row
    tiles (row-count invariance for this rank's shard too)."""
    return _dense(x, kernel, None)


def _col(x, kernel, bias, tp_axis: Optional[str]):
    """Column-parallel projection (output-sharded, no gather)."""
    if tp_axis is None:
        return _dense(x, kernel, bias)
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        column_parallel_linear,
    )

    return column_parallel_linear(x, kernel, bias, gather_output=False,
                                  axis_name=tp_axis, product=_tiled)


def _row(x, kernel, bias, tp_axis: Optional[str], overlap: bool = False):
    """Row-parallel projection (input-sharded, all-reduce exit; ``overlap``
    puts the exit of a 3-d (n, q, h) activation on the ring)."""
    if tp_axis is None:
        return _dense(x, kernel, bias)
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        row_parallel_linear,
    )

    return row_parallel_linear(x, kernel, bias, input_is_parallel=True,
                               axis_name=tp_axis,
                               overlap_comm=overlap and x.dim() == 3,
                               product=_tiled)


def _embed(embed, tokens, positions, tp_axis: Optional[str] = None):
    """Token + position embedding at explicit positions (the token table
    vocab-parallel under ``tp_axis``)."""
    if tp_axis is None:
        x = embed["tok"][tokens.long()]
    else:
        from apex_tpu_torch.transformer.tensor_parallel.layers import (
            vocab_parallel_embedding,
        )

        x = vocab_parallel_embedding(tokens.long(), embed["tok"],
                                     axis_name=tp_axis)
    pos = embed["pos"][positions.long()]
    return x + pos.to(x.dtype)


def _ln_pallas(use_pallas: Optional[bool]) -> Optional[bool]:
    """The ``use_pallas`` a serve program hands ``layer_norm``: ``False``
    (the plain versions) passes on; otherwise the norm's own gate."""
    return False if use_pallas is False else None


def serve_logits(params: Params, x, cfg, use_pallas: Optional[bool] = None,
                 tp_axis: Optional[str] = None):
    """Final LN + LM head -> full-vocab fp32 logits. The tied head is a
    product in the model dtype, then cast to fp32 (as in JAX). Under
    ``tp_axis`` the head holds this rank's vocab shard and the logits are
    all-gathered over the vocab (sampling needs the global argmax /
    top-k)."""
    head = params["head"]
    x = layer_norm(x, head["ln_w"], head["ln_b"],
                   use_pallas=_ln_pallas(use_pallas))
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(x.dtype).t()
    else:
        w = head["lm"]
    logits = _dense(x, w, None)
    if tp_axis is not None:
        from apex_tpu_torch.transformer.tensor_parallel.mappings import (
            all_gather_dim,
        )

        logits = all_gather_dim(logits, -1, tp_axis)
    return logits.float()


def _split_qkv(qkv, heads: int, head_dim: int):
    """Per-head interleaved unpack — the standalone_gpt packing."""
    qkv = qkv.reshape(*qkv.shape[:-1], heads, 3, head_dim)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _serve_heads(cfg, tp_axis: Optional[str]) -> int:
    tp = _tp_size(tp_axis)
    if cfg.num_heads % tp:
        raise ValueError(
            f"num_heads ({cfg.num_heads}) not divisible by tp ({tp})")
    return cfg.num_heads // tp


def ensure_dense_ffn(num_experts: int) -> None:
    """The one MoE serving refusal, shared by every serve entry point (the
    paged programs and the engine constructor), with JAX's text: the
    paged programs assume a dense FFN."""
    if num_experts:
        raise NotImplementedError(
            "serve does not support MoE layers (num_experts > 0) yet — "
            "the paged decode/prefill programs assume a dense FFN, and "
            "no ServeConfig.plan residency strategy (tp/pp/fsdp, "
            "apex_tpu.serve.sharded) shards experts either: a plan moves "
            "dense weights, it does not route tokens. One refusal for "
            "both stacks; routed-expert serving is ROADMAP item 5a.")


def _check_stack_cfg(cfg, kv_cfg: KVCacheConfig, tp_axis) -> None:
    """The layer-stack half of the serve config check (no layer count: a
    pipeline stage's pools hold its own layer slice)."""
    ensure_dense_ffn(cfg.num_experts)
    heads_local = _serve_heads(cfg, tp_axis)
    if kv_cfg.num_heads != heads_local or kv_cfg.head_dim != cfg.head_dim:
        raise ValueError(
            f"KVCacheConfig ({kv_cfg.num_heads} heads x {kv_cfg.head_dim}) "
            f"does not match the model's local layout ({heads_local} x "
            f"{cfg.head_dim})")


def _check_serve_cfg(cfg, kv_cfg: KVCacheConfig, tp_axis=None) -> None:
    _check_stack_cfg(cfg, kv_cfg, tp_axis)
    if kv_cfg.num_layers != cfg.num_layers:
        raise ValueError(
            f"KVCacheConfig.num_layers ({kv_cfg.num_layers}) != "
            f"cfg.num_layers ({cfg.num_layers})")


# ---------------------------------------------------------------------------
# The unified paged forward: q tokens per slot through the whole stack.
# Per-row math is identical across q (each token row embeds at its own
# position, writes its K/V, then attends through the paged gather masked
# to its own context), so speculative verification and chunked prefill
# give the streams sequential decode would.


def paged_layer_stack(x, layers: Params, start_lens, n_valid, active,
                      cache: Dict[str, torch.Tensor], block_tables, cfg,
                      kv_cfg: KVCacheConfig, *,
                      tp_axis: Optional[str] = None,
                      use_pallas: Optional[bool] = None,
                      adapters: Optional[Dict[str, torch.Tensor]] = None,
                      adapter_ids=None, gather_layer=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run embedded activations ``x`` (n, q, h) through the stacked layers
    against their paged pools; ``cache`` is updated in place. Returns
    ``(x', cache)``.

    ``adapters``: an optional ``serve.adapters`` pool; each slot's rows add
    their adapter's ``lora_delta`` after the qkv, out, fc1 and fc2
    projections, ``adapter_ids`` (n,) picking the pool slot per slot (0:
    the base model, an exact zero). ``gather_layer``: JAX's per-layer
    parameter hook, applied to each layer's dict before use.
    ``use_pallas``: as :func:`paged_attention`; ``False`` also takes the
    plain LayerNorm. ``tp_axis``: this rank's Megatron shards and local
    heads (the module docstring). The number of layers is the stacked
    params' (a pipeline stage runs its slice)."""
    _check_stack_cfg(cfg, kv_cfg, tp_axis)
    if adapters is not None:
        if tp_axis is not None:
            raise NotImplementedError(
                "paged LoRA adapters are single-device for now — the pool "
                "is not TP-sharded (pass tp_axis=None)")
        if adapter_ids is None:
            raise ValueError("adapters given without adapter_ids")
    ln_pallas = _ln_pallas(use_pallas)
    n, q = x.shape[:2]
    # every flat row's pool slot, once a call for all layers and targets
    rows = (None if adapters is None
            else lora_rows(adapter_ids, q, x.device))
    heads, hd = _serve_heads(cfg, tp_axis), cfg.head_dim
    # q > 1 row exits ride the ring with cfg.overlap_comm (the ring
    # scatters over q, so q % tp == 0); decode's q = 1 stays monolithic
    overlap = (tp_axis is not None and cfg.overlap_comm and q > 1
               and q % _tp_size(tp_axis) == 0)
    offs = torch.arange(q, device=x.device)
    positions = start_lens.long()[:, None] + offs[None, :]      # (n, q)
    valid = active[:, None] & (offs[None, :] < n_valid[:, None])
    ctx_lens = torch.where(valid, positions + 1, 0).to(torch.int32)
    ctx_lens = ctx_lens.reshape(-1)
    # flat row views: each token is its own "slot" sharing its owner's
    # block-table row
    bt_rows = block_tables.to(torch.int32).repeat_interleave(q, dim=0)
    pos_flat = positions.reshape(-1)
    valid_flat = valid.reshape(-1)
    for li in range(next(iter(layers.values())).shape[0]):
        lp = {name: t[li] for name, t in layers.items()}
        if gather_layer is not None:
            lp = gather_layer(lp)
        cl = {name: pool[li] for name, pool in cache.items()}
        ad = (None if adapters is None
              else {name: t[li] for name, t in adapters.items()})
        h1 = layer_norm(x, lp["ln1_w"], lp["ln1_b"], use_pallas=ln_pallas)
        qkv = _col(h1, lp["qkv_kernel"], lp["qkv_bias"], tp_axis)
        if ad is not None:
            qkv = qkv + lora_delta_rows(h1, ad["qkv_a"], ad["qkv_b"], rows)
        qh, k, v = _split_qkv(qkv, heads, hd)                  # (n,q,H,D)
        paged_write(cl, kv_cfg, k.reshape(n * q, heads, hd).transpose(0, 1),
                    v.reshape(n * q, heads, hd).transpose(0, 1), bt_rows,
                    pos_flat, valid_flat)
        ctx = paged_attention(qh.reshape(n * q, heads, hd).contiguous(), cl,
                              kv_cfg, bt_rows, ctx_lens, rows_per_table=q,
                              use_pallas=use_pallas)
        ctx = ctx.reshape(n, q, heads * hd)
        a = _row(ctx, lp["out_kernel"], lp["out_bias"], tp_axis, overlap)
        if ad is not None:
            a = a + lora_delta_rows(ctx, ad["out_a"], ad["out_b"], rows)
        x = x + a
        h2 = layer_norm(x, lp["ln2_w"], lp["ln2_b"], use_pallas=ln_pallas)
        pre = _col(h2, lp["fc1_kernel"], lp["fc1_bias"], tp_axis)
        if ad is not None:
            pre = pre + lora_delta_rows(h2, ad["fc1_a"], ad["fc1_b"], rows)
        y = F.gelu(pre, approximate="tanh")
        m = _row(y, lp["fc2_kernel"], lp["fc2_bias"], tp_axis, overlap)
        if ad is not None:
            m = m + lora_delta_rows(y, ad["fc2_a"], ad["fc2_b"], rows)
        x = x + m
    return x, cache


def gpt_paged_forward(params: Params, tokens, start_lens, n_valid, active,
                      cache: Dict[str, torch.Tensor], block_tables, cfg,
                      kv_cfg: KVCacheConfig, *,
                      tp_axis: Optional[str] = None,
                      use_pallas: Optional[bool] = None,
                      adapters: Optional[Dict[str, torch.Tensor]] = None,
                      adapter_ids=None, gather_layer=None):
    """Process ``tokens`` (n, q) — per slot, q consecutive tokens starting
    at position ``start_lens[slot]`` — against the paged cache.

    ``n_valid``: (n,) how many of each slot's q tokens are real (the rest
    are padding: K/V writes go to the trash block, logits junk).
    ``active``: (n,) bool. Returns ``(cache, logits (n, q, vocab) fp32)``;
    ``cache`` is updated in place. logits[i, j] is the next-token
    distribution after tokens[i, j] at position ``start_lens[i] + j``.
    ``tp_axis`` / ``use_pallas`` / ``adapters`` / ``adapter_ids`` /
    ``gather_layer``: see :func:`paged_layer_stack`.
    """
    _check_serve_cfg(cfg, kv_cfg, tp_axis)
    q = tokens.shape[1]
    offs = torch.arange(q, device=tokens.device)
    positions = start_lens.long()[:, None] + offs[None, :]
    # JAX's take clamps; torch indexing raises, so clamp explicitly
    positions_c = torch.clamp(positions, max=cfg.max_seq - 1)
    x = _embed(params["embed"], tokens, positions_c, tp_axis)  # (n, q, h)
    x, cache = paged_layer_stack(
        x, params["layers"], start_lens, n_valid, active, cache,
        block_tables, cfg, kv_cfg, tp_axis=tp_axis, use_pallas=use_pallas,
        adapters=adapters, adapter_ids=adapter_ids, gather_layer=gather_layer)
    return cache, serve_logits(params, x, cfg, use_pallas, tp_axis)


def gpt_decode_step(params: Params, last_tokens, seq_lens, active, cache,
                    block_tables, cfg, kv_cfg: KVCacheConfig, *,
                    tp_axis: Optional[str] = None,
                    use_pallas: Optional[bool] = None, adapters=None,
                    adapter_ids=None, gather_layer=None):
    """Advance every active slot by one token (q=1). ``last_tokens`` (n,)
    the token each slot feeds; ``seq_lens`` (n,) tokens already cached.
    Returns ``(cache, logits (n, vocab) fp32)``. The keywords: see
    :func:`paged_layer_stack`."""
    n = last_tokens.shape[0]
    ones = torch.ones((n,), dtype=torch.int32, device=last_tokens.device)
    cache, logits = gpt_paged_forward(
        params, last_tokens[:, None], seq_lens, ones, active, cache,
        block_tables, cfg, kv_cfg, tp_axis=tp_axis, use_pallas=use_pallas,
        adapters=adapters, adapter_ids=adapter_ids, gather_layer=gather_layer)
    return cache, logits[:, 0]


def gpt_verify_step(params: Params, fed_tokens, seq_lens, n_fed, active,
                    cache, block_tables, cfg, kv_cfg: KVCacheConfig, *,
                    tp_axis: Optional[str] = None,
                    use_pallas: Optional[bool] = None, adapters=None,
                    adapter_ids=None, gather_layer=None):
    """Speculative verify: ``fed_tokens`` (n, k+1) — each slot's last
    token then up to k drafts — in one paged call. Returns ``(cache,
    logits (n, k+1, vocab))``. Rejected drafts' K/V need no rollback: the
    accepted length caps the context, and later writes overwrite them."""
    return gpt_paged_forward(params, fed_tokens, seq_lens, n_fed, active,
                             cache, block_tables, cfg, kv_cfg,
                             tp_axis=tp_axis, use_pallas=use_pallas,
                             adapters=adapters,
                             adapter_ids=adapter_ids,
                             gather_layer=gather_layer)


def gpt_prefill_chunk(params: Params, tokens, start: int, n_valid: int,
                      cache, block_row, cfg, kv_cfg: KVCacheConfig, *,
                      tp_axis: Optional[str] = None,
                      use_pallas: Optional[bool] = None, adapters=None,
                      adapter_id=None, gather_layer=None):
    """One fixed-size chunk of ONE prompt: ``tokens`` (chunk,) holding
    prompt positions ``start .. start + n_valid - 1``, padded. Returns
    ``(cache, logits (vocab,))`` after the chunk's last valid token.
    ``adapter_id``: the prefilling slot's pool slot with ``adapters`` (an
    int or a 0-d / (1,) tensor; the prompt's K/V are written with the
    adapted projections decode will use)."""
    dev = tokens.device
    aids = None
    if adapters is not None:
        aids = (adapter_id.reshape(1) if isinstance(adapter_id, torch.Tensor)
                else torch.full((1,), int(adapter_id or 0),
                                dtype=torch.int32, device=dev))
    start_lens = torch.full((1,), int(start), dtype=torch.int32, device=dev)
    nv = torch.full((1,), int(n_valid), dtype=torch.int32, device=dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    cache, logits = gpt_paged_forward(
        params, tokens[None, :], start_lens, nv, active, cache,
        block_row[None, :], cfg, kv_cfg, tp_axis=tp_axis,
        use_pallas=use_pallas, adapters=adapters, adapter_ids=aids,
        gather_layer=gather_layer)
    return cache, logits[0, max(int(n_valid) - 1, 0)]
