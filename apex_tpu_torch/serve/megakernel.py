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
  the model and divisible by 8) and, where the kernel itself must run
  (``allow_interpret=False``: a CUDA device), the Hopper kernel's limits —
  its head dims, fed rows per launch and shared memory — in place of the
  TPU's VMEM budget. :func:`warn_megakernel_fallback` logs an ``auto``
  fallback once per reason.

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
from apex_tpu_torch.serve.decode import (_check_serve_cfg, _embed,
                                         _split_qkv, check_pools, kv_mode,
                                         paged_attention_reference,
                                         serve_logits)
from apex_tpu_torch.serve.kv_cache import KVCacheConfig, paged_write

Params = Dict[str, Any]

# the Hopper kernel's limits (csrc/megakernel.cu)
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 128                 # fed rows (slots x q) per launch
SMEM_LIMIT_BYTES = 232448      # dynamic shared memory of one H100 block
_THREADS, _WARPS, _KC, _NC = 256, 8, 32, 32
_EPS = 1e-5

_SIGNATURES = {
    "fused_layer_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 25
    + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p],
    "fused_layer_smem_bytes": [ctypes.c_int, ctypes.c_int],
    "fused_layer_scratch_bytes": [ctypes.c_int] * 4,
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


def kernel_smem_bytes(hidden: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of the fused-layer kernel: its
    largest phase (GEMM chunks, the attention walk, the pool write's
    per-warp vectors, one LayerNorm row); ``csrc/megakernel.cu``
    ``smem_floats`` computes the same."""
    nt = 4096 // head_dim
    attend = 2 * nt * (head_dim + 1) + nt + _WARPS + _THREADS
    floats = max(MAX_ROWS * (_KC + 1) + _KC * _NC, attend + head_dim,
                 _WARPS * (head_dim + head_dim // 2), hidden + _WARPS)
    return 4 * floats


def megakernel_refusal(cfg, kv_cfg: KVCacheConfig,
                       allow_interpret: bool = True, q: int = 1,
                       slots: int = 1) -> Optional[str]:
    """Why the fused layer refuses this model/cache shape; ``None`` when it
    is supported. ``allow_interpret=True`` lets the plain version stand in
    (a CPU engine, as JAX's interpret mode); ``False`` asks for the Hopper
    kernel itself, for ``slots`` slots of ``q`` fed rows: a CUDA device,
    its dtypes and head dims, at most ``MAX_ROWS`` fed rows per launch, and
    its shared memory within the block's limit (reported in bytes)."""
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
        return (f"the Hopper kernel takes fp32 or bf16 models with pools "
                f"in the model dtype, got {cfg.dtype} / {kv_cfg.dtype}")
    if cfg.head_dim not in KERNEL_HEAD_DIMS:
        return (f"the Hopper kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                f"got {cfg.head_dim}")
    if slots * q > MAX_ROWS:
        return (f"{slots} slots x {q} fed rows = {slots * q} rows per "
                f"launch, over the Hopper kernel's {MAX_ROWS}")
    smem = kernel_smem_bytes(cfg.hidden, cfg.head_dim)
    if smem > SMEM_LIMIT_BYTES:
        return (f"the Hopper kernel's blocks need {smem} B of shared "
                f"memory at hidden {cfg.hidden}, over the "
                f"{SMEM_LIMIT_BYTES} B limit")
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
    x_out = torch.empty_like(x)
    k_out = torch.empty((n, q, heads, d), dtype=dt, device=dev)
    v_out = torch.empty_like(k_out)
    scratch = torch.empty(
        lib.fused_layer_scratch_bytes(n * q, h, f, int(dt == torch.bfloat16)),
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
        1.0 / math.sqrt(d), _EPS, int(dt == torch.bfloat16),
        ku.stream_handle(x))
    ku.count_launch("megakernel")
    ku.check_status(lib, status, "fused_layer_fwd")
    return x_out, k_out, v_out


def fused_layer(x, layer_params, cache_layer, cfg, kv_cfg: KVCacheConfig,
                block_tables, start_lens, n_valid, active):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    fn = fused_layer_fwd if ku.use_kernel(x) else fused_layer_reference
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
                   block_tables, cfg, kv_cfg: KVCacheConfig, what: str):
    _check_serve_cfg(cfg, kv_cfg)
    n, q = tokens.shape
    refusal = megakernel_refusal(cfg, kv_cfg,
                                 allow_interpret=not ku.use_kernel(tokens),
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
                              seq_lens, n_fed, active)
    return cache, serve_logits(params, x, cfg)


def gpt_decode_step_fused(params: Params, last_tokens, seq_lens, active,
                          cache, block_tables, cfg, kv_cfg: KVCacheConfig
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Advance every active slot by one token with the fused layer: the
    contract of ``decode.gpt_decode_step`` (same pool writes, junk but
    finite logits for inactive slots). Returns ``(cache, logits (n,
    vocab) fp32)``; ``cache`` is updated in place."""
    cache, logits = _fused_program(params, last_tokens[:, None], seq_lens,
                                   None, active, cache, block_tables, cfg,
                                   kv_cfg, "gpt_decode_step")
    return cache, logits[:, 0]


def gpt_verify_step_fused(params: Params, fed_tokens, seq_lens, n_fed,
                          active, cache, block_tables, cfg,
                          kv_cfg: KVCacheConfig
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Speculative verify with the fused layer: the contract of
    ``decode.gpt_verify_step`` — ``fed_tokens`` (n, k+1), logits (n, k+1,
    vocab) scoring the token after each fed one; rejected drafts' K/V need
    no rollback."""
    return _fused_program(params, fed_tokens, seq_lens, n_fed, active, cache,
                          block_tables, cfg, kv_cfg, "gpt_verify_step")
