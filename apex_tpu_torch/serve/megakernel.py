"""The fused decode/verify layer — one CUDA kernel per layer (counterpart
of ``apex_tpu/serve/megakernel.py``).

At serving row counts a per-op decode step is a few dozen small ops per
layer, and the host spends its time launching them. The fused layer runs
LN1, QKV, the pool write, paged attention, the out-projection, LN2 and the
MLP of every fed row in ONE launch of ``csrc/megakernel.cu`` (a cooperative
grid; see its header for the design):

* :func:`fused_layer_decode` (q = 1) and :func:`fused_layer_verify` (q =
  k + 1 rows per slot) run one layer and write its K/V into the paged pool
  in place: the kernel writes each valid fed row first and then attends
  positions ``0..pos`` from the pool, so a row reads back exactly what the
  per-op path would (the codec round trip included) and a verify row gives
  the bits the decode of that token gives. They return ``(x', k_new,
  v_new)`` as JAX's do (the emitted K/V in the model dtype).
* :func:`fused_layer_reference` is the kernel's plain version: the per-op
  pieces at the kernel's rounding points (q and the residual in fp32,
  fp32-accumulated products, the pool written through ``paged_write``).
  The wrappers take it for CPU tensors.
* :func:`gpt_decode_step_fused` / :func:`gpt_verify_step_fused` mirror
  ``decode.gpt_decode_step`` / ``decode.gpt_verify_step``: embed, the
  fused layer per layer, final LN + logits.
* :func:`megakernel_refusal` / :func:`megakernel_ok` gate the shape:
  JAX's rules (no MoE, ``heads * head_dim == hidden``, head_dim matching
  the model and divisible by 8: every such head dim, any number of slots
  and fed rows) and, where the kernel itself must run
  (``allow_interpret=False``: a CUDA device), the Hopper kernel's limits
  in place of the TPU's VMEM budget: fp32, bf16 or fp16, and its shared
  memory (:func:`kernel_smem_bytes`, reported in bytes) within
  :data:`SMEM_LIMIT_BYTES`. Every shape it admits launches.
  :func:`warn_megakernel_fallback` logs an ``auto`` fallback once per
  reason.

The Hopper kernel (``csrc/megakernel.cu``, whose header has the design):
one cooperative launch a layer, one 256-thread block an SM, phases
qkv | (int8 / int4 codec) | attention | merge | out | fc1 | fc2 between 5
(6) grid syncs. Each GEMM item is 16 output columns over K (fc2, whose K
is wide, in ordered K splits added by the last to arrive), its weights
streamed through a cp.async ring in shared memory; bf16 and fp16 products
on the tensor cores (mma.sync, the weight's columns on M and the fed rows
on N),
fp32 on the CUDA cores; LN1 and LN2 are computed by every block for the
rows it stages. Attention is the per-op path's split walk
(``csrc/paged_split.cuh``, ``paged_walks.cuh``) over :func:`_fused_splits`
of the table's capacity, its items taken from a queue, merged in order in
a later phase. Rows go in chunks of up to 64 within the launch, and no
sum depends on the row count, the chunk or the grid: a verify row equals
the decode of its token bit for bit, and one launch is made a call,
whatever the rows. Its bound is device memory: one layer's weights read
once (14.2 MB in bf16 at GPT-2-124M, 4.2 µs at 3.35 TB/s) plus the
attended pool blocks; it runs at about 10x that (PERF.md §6 row 20). Its
limits: the shared memory, whose largest parts are the attention walk's
tiles at head dims up to 256 and an LN phase's fewest rows of the hidden
width (refused from a hidden of about 4,500 in either type).

JAX's weight-tile planner (``tiles=``, ``default_tiles``,
``fused_live_bytes``) sizes VMEM-resident tiles; the Hopper kernel streams
every weight through shared memory in fixed chunks and has no counterpart
(ROADMAP §C).
"""

from __future__ import annotations

import ctypes
import logging
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops.layer_norm import layer_norm_fwd_reference
from apex_tpu_torch.serve.decode import (PAGED_TILE, _SPLITS_MAX,
                                         _check_serve_cfg, _embed,
                                         _split_qkv, check_pools, kv_mode,
                                         paged_attention_reference,
                                         serve_logits)
from apex_tpu_torch.serve.kv_cache import KVCacheConfig, paged_write

Params = Dict[str, Any]

# the Hopper kernel's limits (csrc/megakernel.cu)
KERNEL_DTYPES = ku.KERNEL_DTYPES
SMEM_LIMIT_BYTES = 229376      # dynamic shared memory a launch takes
_WARPS, _NT = 8, 16
# per type: (k of a ring stage, stages, row padding, fewest and most rows
# of a chunk); csrc/megakernel.cu `Gemm<T>`
_GEMM = {torch.bfloat16: (128, 12, 8, 16, 64),
         torch.float16: (128, 12, 8, 16, 64),
         torch.float32: (128, 6, 4, 8, 64)}
# 64-position tiles of a fused attention split, at least (the per-op
# kernels' two make more, shorter items; the fused layer's blocks walk
# their items one after another)
_FUSED_SPLIT_TILES = 4
_EPS = 1e-5

_SIGNATURES = {
    "fused_layer_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 25
    + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p],
    "fused_layer_smem_bytes": [ctypes.c_int] * 6,
    "fused_layer_smem_budget": [],
    "fused_layer_scratch_bytes": [ctypes.c_int] * 8,
}

_log = logging.getLogger("apex_tpu_torch.serve")


def layer_weight_bytes(cfg) -> int:
    """Bytes of one layer's weights and vectors in the model dtype: what
    one launch of the fused layer reads once."""
    h, f = cfg.hidden, cfg.ffn_hidden
    hd = cfg.num_heads * cfg.head_dim
    elems = h * 3 * h + hd * h + h * f + f * h
    elems += 3 * h + 2 * h + f + 2 * h + h + h
    return elems * torch.empty((), dtype=cfg.dtype).element_size()


def _walk_layout_bytes(q_bytes: int, tile_bytes: int, tp: int, mode: int,
                       code_row: int, scale_row: int, ring: int) -> int:
    """Bytes of a paged walk's shared memory (``csrc/paged_split.cuh``
    ``make_layout``): q, the K and V tiles (``ring`` stages for
    full-precision pools, one dequantized stage beside ``ring`` stages of
    codes, scales and scale offsets for quantized ones)."""
    stages = ring if mode == 0 else 1
    at = q_bytes + 2 * stages * tile_bytes
    if mode:
        rs = -(-code_row // 16) * 16
        sw = (scale_row + 2 + 3) // 4 * 4 if scale_row % 4 else scale_row
        at = (-(-(at + 2 * ring * tp * rs + 2 * ring * tp * sw) // 16) * 16
              + ring * tp * 4)
    return at


def _fused_splits(capacity: int) -> Tuple[int, int]:
    """``(splits, positions a split covers)`` of the fused layer's attention
    walk for a block table of ``capacity`` positions: ``decode._paged_splits``
    with splits of at least ``_FUSED_SPLIT_TILES`` tiles, at most
    ``_SPLITS_MAX`` of them. A function of the capacity alone."""
    tiles = max(1, -(-capacity // PAGED_TILE))
    per = max(_FUSED_SPLIT_TILES, -(-tiles // _SPLITS_MAX))
    return -(-tiles // per), per * PAGED_TILE


def _gemm_kw(k: int, split: bool, dtype) -> int:
    """Columns a GEMM phase stages a row (``gemm_geo``'s kw): the whole K
    in ring chunks, or, where a copied phase (out, fc2) would not fit its
    most rows with the whole K, one of the fewest K splits that do."""
    kc, most = _GEMM[dtype][0], _GEMM[dtype][4]
    nch, s = -(-k // kc), 1
    while (split and s < nch and _gemm_smem_bytes(-(-nch // s) * kc, k, most,
                                                  False, 0, dtype)
           > SMEM_LIMIT_BYTES):
        s += 1
    return -(-nch // s) * kc


def _gemm_smem_bytes(kw: int, k: int, rows: int, ln: bool, raw: int,
                     dtype) -> int:
    """Bytes of a GEMM phase staging ``kw`` columns of ``rows`` rows
    (``gemm_smem``): the rows, the weight ring, the warps' sums, the LN
    weights (``ln``), the rows' pool tokens, and ``raw`` raw fp32 rows (an
    LN of fp32 rows into a half type: at least one)."""
    kc, stages, apad, _, _ = _GEMM[dtype]
    esz = torch.empty((), dtype=dtype).element_size()
    lnw = (rows * (kw + apad) * esz + stages * kc * _NT * esz
           + _WARPS * _NT * rows * 4)
    tok = lnw + (-(-(2 * k * esz) // 16) * 16 if ln else 0)
    return tok + -(-(rows * 4) // 16) * 16 + raw * k * 4


def kernel_smem_bytes(hidden: int, head_dim: int, ffn: int, dtype,
                      mode: int = 0, group: int = 0) -> int:
    """Dynamic shared memory the fused-layer kernel needs at this shape
    (``csrc/megakernel.cu`` ``fused_layer_smem_bytes`` computes the
    same): the largest of the attention walk's layout at the head dim's
    bucket (64, 128, 256; above 256 the wide walk's chunks), the codec
    phase's per-warp vectors (int8 / int4 pools) and a GEMM phase's fewest
    rows of the widest K beside the weight ring. ``mode``: the pools'
    ``kv_mode``; ``group``: the int4 group."""
    d = head_dim
    db = 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 0
    code = (db if mode == 1 else db // 2) if mode else 0
    scale = (4 if mode == 1 else 2 * (d // group)) if mode else 0
    ring = 4 if db <= 128 else 2        # kWalkRing
    if db == 0:
        att = (8 * 128 + 32 * (128 + 4)) * 4
    elif dtype in ku.HALF_DTYPES:   # q as two half terms hi + lo
        att = _walk_layout_bytes(2 * 32 * (db + 8) * 2, PAGED_TILE * (db + 8)
                                 * 2, PAGED_TILE, mode, code, scale, ring)
    else:
        att = _walk_layout_bytes(8 * db * 4, 32 * (db + 4) * 4, 32, mode,
                                 code, scale, ring)
    need = max(att, _WARPS * 2 * d * 4 if mode else 0)
    rows = _GEMM[dtype][3]
    return max(need,
               _gemm_smem_bytes(_gemm_kw(hidden, False, dtype), hidden, rows,
                                True, int(dtype in ku.HALF_DTYPES), dtype),
               _gemm_smem_bytes(_gemm_kw(hidden, True, dtype), hidden, rows,
                                False, 0, dtype),
               _gemm_smem_bytes(_gemm_kw(ffn, True, dtype), ffn, rows, False,
                                0, dtype))


def megakernel_refusal(cfg, kv_cfg: KVCacheConfig,
                       allow_interpret: bool = True, q: int = 1,
                       slots: int = 1) -> Optional[str]:
    """Why the fused layer refuses this model/cache shape; ``None`` when it
    is supported. ``allow_interpret=True`` lets the plain version stand in
    (a CPU engine, as JAX's interpret mode); ``False`` asks for the Hopper
    kernel itself: a CUDA device, its dtypes, and its shared memory within
    :data:`SMEM_LIMIT_BYTES` (reported in bytes). It takes every head_dim %
    8 == 0 and any ``slots`` x ``q`` fed rows (one launch a call), as JAX's
    grid does; the C entry refuses nothing this admits."""
    if getattr(cfg, "num_experts", 0):
        return ("MoE layers (num_experts > 0) — the fused block assumes a "
                "dense FFN")
    if cfg.num_heads * cfg.head_dim != cfg.hidden:
        return (f"num_heads * head_dim ({cfg.num_heads} * {cfg.head_dim} "
                f"= {cfg.num_heads * cfg.head_dim}) != hidden "
                f"({cfg.hidden}) — the residual add needs hd == h")
    if kv_cfg.head_dim != cfg.head_dim or kv_cfg.head_dim % 8 != 0:
        return (f"head_dim {kv_cfg.head_dim} must match the model "
                f"({cfg.head_dim}) and be a multiple of 8")
    if allow_interpret:
        return None
    if not torch.cuda.is_available():
        return ("no CUDA device (the plain version stands in for the "
                "kernel and saves no dispatch)")
    if cfg.dtype not in KERNEL_DTYPES or kv_cfg.dtype != cfg.dtype:
        return (f"the Hopper kernel takes fp32, bf16 or fp16 models with "
                f"pools in the model dtype, got {cfg.dtype} / "
                f"{kv_cfg.dtype}")
    if cfg.ffn_hidden % 8:
        return (f"ffn_hidden {cfg.ffn_hidden} is not a multiple of 8 (the "
                f"Hopper kernel's 16-byte rows)")
    smem = kernel_smem_bytes(cfg.hidden, cfg.head_dim, cfg.ffn_hidden,
                             cfg.dtype, kv_mode(kv_cfg), kv_cfg.kv_group)
    if smem > SMEM_LIMIT_BYTES:
        return (f"the Hopper kernel's blocks need {smem} B of shared "
                f"memory at hidden {cfg.hidden}, ffn {cfg.ffn_hidden}, "
                f"head_dim {cfg.head_dim}, over the {SMEM_LIMIT_BYTES} B "
                f"limit")
    return None


def megakernel_ok(cfg, kv_cfg: KVCacheConfig, allow_interpret: bool = True,
                  q: int = 1, slots: int = 1) -> bool:
    """Whether the fused layer supports this shape (see
    :func:`megakernel_refusal`)."""
    return megakernel_refusal(cfg, kv_cfg, allow_interpret=allow_interpret,
                              q=q, slots=slots) is None


# reasons whose megakernel="auto" fallback was already logged
_FALLBACK_WARNED: set = set()


def warn_megakernel_fallback(reason: str) -> None:
    """Log, once per distinct reason, that ``megakernel="auto"`` fell back
    to the per-op layer body on a CUDA engine."""
    if reason in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(reason)
    _log.warning("megakernel='auto': falling back to the unfused per-op "
                 "decode path — %s", reason)


# ---------------------------------------------------------------------------
# one fused layer


def _rows(x, start_lens, n_valid, active):
    """Per fed row: position, valid (active slot, w < n_valid) and the
    attention context (pos + 1, 0 when invalid), flat (n * q,)."""
    n, q = x.shape[:2]
    offs = torch.arange(q, device=x.device)
    positions = start_lens.long()[:, None] + offs[None, :]
    valid = active.bool()[:, None]
    if n_valid is not None:
        valid = valid & (offs[None, :] < n_valid[:, None])
    valid = valid.expand(n, q)
    ctx = torch.where(valid, positions + 1, 0)
    return positions.reshape(-1), valid.reshape(-1), ctx.reshape(-1)


def fused_layer_reference(x, layer_params, cache_layer, cfg,
                          kv_cfg: KVCacheConfig, block_tables, start_lens,
                          n_valid, active):
    """Plain version of the fused layer: ``x`` (n, q, h) fed rows, slot
    ``i``'s row ``w`` at position ``start_lens[i] + w``, valid when
    ``active[i]`` and ``w < n_valid[i]`` (``n_valid=None``: every row).
    Writes the valid rows' K/V into ``cache_layer`` in place (through
    ``paged_write``'s codec), then attends each valid row over positions
    ``0..pos``; invalid rows attend nothing. Rounding points as the
    kernel's: h1, K, V, ctx, h2 and y in the model dtype; q, the residual
    x1 and every product's accumulation in fp32. Returns ``(x' (n, q, h),
    k_new (n, q, H, D), v_new)``."""
    n, q, h = x.shape
    dt = x.dtype
    heads, d = cfg.num_heads, cfg.head_dim
    lp = layer_params
    pos, valid, ctx = _rows(x, start_lens, n_valid, active)
    rows = x.reshape(n * q, h)
    bt_rows = block_tables.to(torch.int32).repeat_interleave(q, dim=0)

    def dense32(a, w, b):
        return a.float() @ w.float() + b.float()

    h1 = layer_norm_fwd_reference(rows, lp["ln1_w"], lp["ln1_b"], _EPS)[0]
    qh, k, v = _split_qkv(dense32(h1, lp["qkv_kernel"], lp["qkv_bias"]),
                          heads, d)                        # (R, H, D) fp32
    k, v = k.to(dt), v.to(dt)
    paged_write(cache_layer, kv_cfg, k.transpose(0, 1), v.transpose(0, 1),
                bt_rows, pos, valid)
    att = paged_attention_reference(qh.contiguous(), cache_layer, kv_cfg,
                                    bt_rows, ctx, scale=1.0 / math.sqrt(d))
    x1 = rows.float() + dense32(att.to(dt).reshape(n * q, h),
                                lp["out_kernel"], lp["out_bias"])
    h2 = layer_norm_fwd_reference(x1, lp["ln2_w"], lp["ln2_b"], _EPS)[0]
    y = F.gelu(dense32(h2.to(dt), lp["fc1_kernel"], lp["fc1_bias"]),
               approximate="tanh").to(dt)
    out = (x1 + dense32(y, lp["fc2_kernel"], lp["fc2_bias"])).to(dt)
    return (out.reshape(n, q, h), k.reshape(n, q, heads, d),
            v.reshape(n, q, heads, d))


def fused_layer_fwd(x, layer_params, cache_layer, cfg,
                    kv_cfg: KVCacheConfig, block_tables, start_lens,
                    n_valid, active):
    """Launch the fused-layer kernel on CUDA tensors (the arguments and
    result of :func:`fused_layer_reference`). Raises on a shape, dtype or
    layout the kernel does not take, and on a launch the card refuses."""
    ku.require(x.is_cuda and x.dim() == 3,
               f"fused_layer_fwd takes a 3-d CUDA x, got {x.device} "
               f"{tuple(x.shape)}")
    n, q, h = x.shape
    dt, dev = x.dtype, x.device
    reason = megakernel_refusal(cfg, kv_cfg, allow_interpret=False, q=q,
                                slots=n)
    ku.require(reason is None, f"fused_layer_fwd: {reason}")
    ku.require(dt == cfg.dtype and h == cfg.hidden,
               f"fused_layer_fwd: x must be ({n}, {q}, {cfg.hidden}) "
               f"{cfg.dtype}, got {dt} {tuple(x.shape)}")
    heads, d, f = cfg.num_heads, cfg.head_dim, cfg.ffn_hidden
    # the kernel's argument order
    shapes = {"ln1_w": (h,), "ln1_b": (h,), "qkv_kernel": (h, 3 * h),
              "qkv_bias": (3 * h,), "out_kernel": (h, h), "out_bias": (h,),
              "ln2_w": (h,), "ln2_b": (h,), "fc1_kernel": (h, f),
              "fc1_bias": (f,), "fc2_kernel": (f, h), "fc2_bias": (h,)}
    for name, shape in shapes.items():
        t = layer_params[name]
        if not (t.device == dev and t.dtype == dt
                and tuple(t.shape) == shape and t.is_contiguous()
                and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"fused_layer_fwd: {name} must be a contiguous 16-byte "
                f"aligned {shape} {dt} tensor on {dev}, got {t.dtype} "
                f"{tuple(t.shape)}")
    check_pools("fused_layer_fwd", cache_layer, kv_cfg, dev, dt)
    ku.require(block_tables.dim() == 2 and block_tables.shape[0] == n
               and block_tables.device == dev,
               "fused_layer_fwd: block_tables must be (n, max_blocks) on "
               "x's device")
    for name, t in (("start_lens", start_lens), ("n_valid", n_valid),
                    ("active", active)):
        if t is None and name == "n_valid":
            continue
        if not (tuple(t.shape) == (n,) and t.device == dev):
            raise ValueError(f"fused_layer_fwd: {name} must be ({n},) on "
                             f"{dev}")
    x = x.contiguous()
    ku.require(x.data_ptr() % 16 == 0, "fused_layer_fwd: x must be 16-byte "
               "aligned")
    bt = block_tables.to(torch.int32).contiguous()
    start = start_lens.to(torch.int32).contiguous()
    nv = None if n_valid is None else n_valid.to(torch.int32).contiguous()
    act = active.to(torch.bool).contiguous()
    lib = ku.load_kernel("megakernel", _SIGNATURES)
    lib.fused_layer_scratch_bytes.restype = ctypes.c_longlong
    splits, split_len = _fused_splits(bt.shape[1] * kv_cfg.block_size)
    x_out = torch.empty_like(x)
    k_out = torch.empty((n, q, heads, d), dtype=dt, device=dev)
    v_out = torch.empty_like(k_out)
    scratch = torch.empty(
        lib.fused_layer_scratch_bytes(n * q, h, f, heads, d, splits, q,
                                      ku.dtype_code(dt)),
        dtype=torch.uint8, device=dev)
    pools = [cache_layer.get(k) for k in ("k", "v", "k_scale", "v_scale")]
    lp = [layer_params[k] for k in shapes]
    status = lib.fused_layer_fwd(
        dev.index, x.data_ptr(), *(t.data_ptr() for t in lp),
        *(None if t is None else t.data_ptr() for t in pools),
        bt.data_ptr(), start.data_ptr(),
        None if nv is None else nv.data_ptr(), act.data_ptr(),
        x_out.data_ptr(), k_out.data_ptr(), v_out.data_ptr(),
        scratch.data_ptr(), n, q, h, heads, d, f, pools[0].shape[1],
        kv_cfg.block_size, bt.shape[1], kv_mode(kv_cfg), kv_cfg.kv_group,
        splits, split_len, 1.0 / math.sqrt(d), _EPS,
        ku.dtype_code(dt), ku.stream_handle(x))
    ku.count_launch("megakernel")
    ku.check_status(lib, status, "fused_layer_fwd")
    return x_out, k_out, v_out


def fused_layer(x, layer_params, cache_layer, cfg, kv_cfg: KVCacheConfig,
                block_tables, start_lens, n_valid, active,
                use_pallas: Optional[bool] = None):
    """The plain version for CPU tensors, the kernel for CUDA tensors;
    ``use_pallas=False`` takes the plain version on every device, ``True``
    the kernel (raising for CPU tensors)."""
    fn = (fused_layer_fwd if ku.use_kernel_as_asked(x, use_pallas)
          else fused_layer_reference)
    return fn(x, layer_params, cache_layer, cfg, kv_cfg, block_tables,
              start_lens, n_valid, active)


def fused_layer_decode(x, layer_params, cache_layer, cfg,
                       kv_cfg: KVCacheConfig, block_tables, seq_lens,
                       active):
    """One decode layer: ``x`` (n, h) one row per slot at position
    ``seq_lens[i]`` (tokens already cached). Writes the active slots' K/V
    into ``cache_layer`` in place and returns ``(x', k_new (n, H, D),
    v_new)``. An inactive slot writes nothing and attends nothing."""
    xo, k, v = fused_layer(x[:, None], layer_params, cache_layer, cfg,
                           kv_cfg, block_tables, seq_lens, None, active)
    return xo[:, 0], k[:, 0], v[:, 0]


def fused_layer_verify(x, layer_params, cache_layer, cfg,
                       kv_cfg: KVCacheConfig, block_tables, seq_lens, n_fed,
                       active):
    """One verify layer: ``x`` (n, q, h), slot ``i``'s fed rows at
    positions ``seq_lens[i] + w``, the first ``n_fed[i]`` real. Row ``w``
    attends the pool's old tokens plus fed rows ``0..w``. Returns ``(x',
    k_new (n, q, H, D), v_new)``; the valid rows' K/V are in the pool."""
    return fused_layer(x, layer_params, cache_layer, cfg, kv_cfg,
                       block_tables, seq_lens, n_fed, active)


# ---------------------------------------------------------------------------
# the fused serve programs


def _fused_program(params: Params, tokens, seq_lens, n_fed, active, cache,
                   block_tables, cfg, kv_cfg: KVCacheConfig, what: str,
                   use_pallas: Optional[bool]):
    _check_serve_cfg(cfg, kv_cfg)
    n, q = tokens.shape
    kernel = ku.use_kernel_as_asked(tokens, use_pallas)
    refusal = megakernel_refusal(cfg, kv_cfg, allow_interpret=not kernel,
                                 q=q, slots=n)
    if refusal is not None:
        raise ValueError(f"megakernel unsupported: {refusal} — use "
                         f"decode.{what}")
    offs = torch.arange(q, device=tokens.device)
    positions = seq_lens.long()[:, None] + offs[None, :]
    positions = torch.clamp(positions, max=cfg.max_seq - 1)
    x = _embed(params["embed"], tokens, positions)             # (n, q, h)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        lp = {name: t[li] for name, t in layers.items()}
        cl = {name: pool[li] for name, pool in cache.items()}
        x, _, _ = fused_layer(x, lp, cl, cfg, kv_cfg, block_tables,
                              seq_lens, n_fed, active, use_pallas)
    return cache, serve_logits(params, x, cfg, use_pallas)


def gpt_decode_step_fused(params: Params, last_tokens, seq_lens, active,
                          cache, block_tables, cfg, kv_cfg: KVCacheConfig, *,
                          use_pallas: Optional[bool] = None
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Advance every active slot by one token with the fused layer: the
    contract of ``decode.gpt_decode_step`` (same pool writes, junk but
    finite logits for inactive slots). Returns ``(cache, logits (n,
    vocab) fp32)``; ``cache`` is updated in place. ``use_pallas`` as
    :func:`fused_layer`."""
    cache, logits = _fused_program(params, last_tokens[:, None], seq_lens,
                                   None, active, cache, block_tables, cfg,
                                   kv_cfg, "gpt_decode_step", use_pallas)
    return cache, logits[:, 0]


def gpt_verify_step_fused(params: Params, fed_tokens, seq_lens, n_fed,
                          active, cache, block_tables, cfg,
                          kv_cfg: KVCacheConfig, *,
                          use_pallas: Optional[bool] = None
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Speculative verify with the fused layer: the contract of
    ``decode.gpt_verify_step`` — ``fed_tokens`` (n, k+1), logits (n, k+1,
    vocab) scoring the token after each fed one; rejected drafts' K/V need
    no rollback."""
    return _fused_program(params, fed_tokens, seq_lens, n_fed, active, cache,
                          block_tables, cfg, kv_cfg, "gpt_verify_step",
                          use_pallas)
