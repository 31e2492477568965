"""Block-paged KV cache (counterpart of ``apex_tpu/serve/kv_cache.py``).

* the pools are one dict ``{"k", "v"}`` of ``(L, H, num_blocks + 1,
  block_size, head_dim)`` tensors, allocated once per engine and updated
  IN PLACE by the serve programs (where the JAX programs donated them);
* quantized pools (``KVCacheConfig.quantized``) hold codes of the
  ``comm.quantize`` codec at codec-block = head_dim: int8 codes + one fp32
  scale per (head, token) vector (``bits=8``), or nibble-packed int4 codes
  (last dim ``head_dim // 2``) + one bf16 scale per ``kv_group`` channels
  (``bits=4``), under ``"k_scale"`` / ``"v_scale"``;
* the one extra trailing block is the **trash block**: a write that the
  JAX code dropped with ``.at[...].set(mode="drop")`` (inactive slot,
  padded position) is sent there instead, because PyTorch has no drop
  mode and an out-of-range index faults on CUDA. Filtering the rows would
  sync with the host; the trash block keeps the write branch-free. It is
  never read: block tables hold ids < ``num_blocks`` only;
* a host-side :class:`BlockAllocator` (refcounts, content-addressed prefix
  cache, LRU eviction) and :func:`copy_block` for copy-on-write;
* byte models of the pools and of one decode step's reads.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.comm.quantize import (QMAX4, divide, pack_int4,
                                          quantize_blockwise, unpack_int4)


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static shape/layout of the paged pools. ``num_blocks`` is the number
    of allocatable blocks (the pools hold one more: the trash block).

    ``quantized=True, bits=8``: int8 codes + one fp32 scale per (head,
    token) head_dim vector. ``bits=4``: codes nibble-packed two per byte
    and group-quantized along head_dim with one bf16 scale per
    ``group_size`` channels (default: the whole vector, half the int8
    pool's bytes). ``dtype`` is the model's: what reads dequantize to."""

    num_layers: int
    num_heads: int
    head_dim: int
    num_blocks: int
    block_size: int = 16
    dtype: torch.dtype = torch.bfloat16
    quantized: bool = False
    bits: int = 8
    # int4 scale-group length along head_dim; None -> head_dim
    group_size: Optional[int] = None

    @property
    def tokens_capacity(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def kv_group(self) -> int:
        """Effective scale-group length along head_dim (the full vector
        unless int4 ``group_size`` narrows it)."""
        if self.bits == 8 or self.group_size is None:
            return self.head_dim
        return self.group_size

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` (ceil)."""
        return -(-n_tokens // self.block_size)

    def validate(self) -> None:
        for name in ("num_layers", "num_heads", "head_dim", "num_blocks",
                     "block_size"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.group_size is not None and self.bits == 8:
            raise ValueError("group_size only applies to the int4 mode "
                             "(int8 scales one full head_dim vector)")
        if self.quantized and self.bits == 4:
            g = self.kv_group
            if self.head_dim % 2:
                raise ValueError(
                    f"int4 KV needs an even head_dim (nibble packing): "
                    f"{self.head_dim}")
            if g % 2 or g <= 0 or self.head_dim % g:
                raise ValueError(
                    f"int4 KV group_size must be even and divide head_dim "
                    f"({self.head_dim}): got {g}")


def init_kv_cache(cfg: KVCacheConfig, device: DeviceLike = None
                  ) -> Dict[str, torch.Tensor]:
    """Zeroed pools ``{"k", "v"}`` (+ ``{"k_scale", "v_scale"}``, ones, when
    quantized), each (L, H, num_blocks + 1, bs, ...) on ``device`` (default
    ``cuda``): (..., D) of ``cfg.dtype``; int8 codes (..., D) + fp32 scales
    (L, H, B + 1, bs); int4 uint8 codes (..., D/2) + bf16 scales (...,
    D/group)."""
    cfg.validate()
    dev = resolve_device(device)
    lead = (cfg.num_layers, cfg.num_heads, cfg.num_blocks + 1,
            cfg.block_size)
    d = cfg.head_dim
    if cfg.quantized and cfg.bits == 4:
        codes, cdt = lead + (d // 2,), torch.uint8
        scales, sdt = lead + (d // cfg.kv_group,), torch.bfloat16
    elif cfg.quantized:
        codes, cdt = lead + (d,), torch.int8
        scales, sdt = lead, torch.float32
    else:
        shape = lead + (d,)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    # scale 1 keeps the dequantized never-written codes (0) well defined
    return {"k": torch.zeros(codes, dtype=cdt, device=dev),
            "v": torch.zeros(codes, dtype=cdt, device=dev),
            "k_scale": torch.ones(scales, dtype=sdt, device=dev),
            "v_scale": torch.ones(scales, dtype=sdt, device=dev)}


def _quant_rows(x):
    """(..., head_dim) vectors -> int8 codes of the same shape + one fp32
    scale per vector: the ``comm.quantize`` codec's reference at
    codec-block = head_dim, round-to-nearest — ``use_pallas=False``, as
    JAX's KV path calls it, so the codec kernels never move the pools."""
    d = x.shape[-1]
    q, s = quantize_blockwise(x.float().reshape(-1), d, use_pallas=False)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def _dequant_rows(q, s, dtype):
    return (q.float() * s[..., None]).to(dtype)


def _quant_rows_int4(x, group: int):
    """(..., head_dim) vectors -> (packed uint8 codes (..., head_dim/2),
    bf16 scales (..., head_dim/group)): absmax/7 per group with the scale
    ROUNDED TO bf16 FIRST and the codes computed against that stored value
    (round-to-nearest, ±7 clip, nibble pack)."""
    d = x.shape[-1]
    g = x.float().reshape(*x.shape[:-1], d // group, group)
    amax = g.abs().amax(dim=-1)
    scale = torch.where(amax > 0, divide(amax, QMAX4),
                        torch.ones_like(amax)).to(torch.bfloat16)
    q = torch.clamp(torch.round(g / scale.float()[..., None]), -QMAX4, QMAX4)
    return pack_int4(q.to(torch.int8).reshape(x.shape)), scale


def _dequant_rows_int4(q, s, group: int, dtype):
    """Inverse of :func:`_quant_rows_int4`: unpack nibbles, scale per
    group, restore (..., head_dim)."""
    codes = unpack_int4(q)
    d = codes.shape[-1]
    g = codes.reshape(*codes.shape[:-1], d // group, group)
    out = g.float() * s.float()[..., None]
    return out.reshape(codes.shape).to(dtype)


def _pool_write(pool, values, block_ids, offsets, valid) -> None:
    """Scatter ``values`` (H, n, ...) into ``pool`` (H, B + 1, bs, ...) at
    ``(block_ids[i], offsets[i])`` in place; rows with ``valid[i] == False``
    land in the trash block (the last one)."""
    trash = pool.shape[1] - 1
    idx = torch.where(valid, block_ids, torch.full_like(block_ids, trash))
    pool[:, idx, offsets] = values.to(pool.dtype)


def paged_write(cache_layer: Dict[str, torch.Tensor], cfg: KVCacheConfig,
                k_new, v_new, block_rows, positions, valid
                ) -> Dict[str, torch.Tensor]:
    """Write per-token K/V into one layer's pools, in place.

    ``cache_layer``: ``{"k": (H, B + 1, bs, D), "v": ...}`` (+ the scale
    pools when quantized; views into the stacked pools). ``k_new``/
    ``v_new``: (H, n, D), quantized here through the codec. ``block_rows``:
    (n, max_blocks) block-table rows owning each token. ``positions``: (n,)
    logical positions. ``valid``: (n,) bool — False rows (inactive slots,
    padding) and positions past the row's blocks are not written.
    Returns ``cache_layer``.
    """
    bs = cfg.block_size
    mb = block_rows.shape[1]
    positions = positions.long()
    # clamp as jnp.take_along_axis did: a position past the row's blocks
    # is invalid below, but its gather index must stay in range
    col = torch.clamp(positions // bs, max=mb - 1)
    block_ids = torch.gather(block_rows.long(), 1, col[:, None])[:, 0]
    offsets = positions % bs
    valid = valid & (positions < mb * bs)
    if not cfg.quantized:
        _pool_write(cache_layer["k"], k_new, block_ids, offsets, valid)
        _pool_write(cache_layer["v"], v_new, block_ids, offsets, valid)
        return cache_layer
    for name, x in (("k", k_new), ("v", v_new)):
        if cfg.bits == 4:
            codes, scales = _quant_rows_int4(x, cfg.kv_group)
        else:
            codes, scales = _quant_rows(x)
        _pool_write(cache_layer[name], codes, block_ids, offsets, valid)
        _pool_write(cache_layer[name + "_scale"], scales, block_ids, offsets,
                    valid)
    return cache_layer


def gather_kv(cache_layer: Dict[str, torch.Tensor], cfg: KVCacheConfig,
              block_tables):
    """Contiguous K/V through the block tables: ``block_tables`` (n,
    max_blocks) -> ``(k, v)`` each (n, H, max_blocks*block_size, D) in
    ``cfg.dtype``, dequantized when the pools are quantized. Positions
    never written come back as whatever the pool holds and must be masked
    by the caller's context lengths."""
    bt = block_tables.long()

    def grab(pool):
        g = pool[:, bt]                       # (H, n, mb, bs[, ...])
        h, n, mb, bs = g.shape[:4]
        perm = (1, 0, 2, 3) + tuple(range(4, g.dim()))
        return g.permute(perm).reshape(n, h, mb * bs, *g.shape[4:])

    k, v = grab(cache_layer["k"]), grab(cache_layer["v"])
    if cfg.quantized and cfg.bits == 4:
        ks, vs = grab(cache_layer["k_scale"]), grab(cache_layer["v_scale"])
        return (_dequant_rows_int4(k, ks, cfg.kv_group, cfg.dtype),
                _dequant_rows_int4(v, vs, cfg.kv_group, cfg.dtype))
    if cfg.quantized:
        return (_dequant_rows(k, grab(cache_layer["k_scale"]), cfg.dtype),
                _dequant_rows(v, grab(cache_layer["v_scale"]), cfg.dtype))
    return k.to(cfg.dtype), v.to(cfg.dtype)


def copy_block(cache: Dict[str, torch.Tensor], src: int, dst: int
               ) -> Dict[str, torch.Tensor]:
    """Copy pool block ``src`` -> ``dst`` across every layer and pool leaf
    (codes and scales when quantized), in place —
    the device half of copy-on-write (the sharers' block is never
    mutated). Returns ``cache``."""
    for pool in cache.values():
        pool[:, :, dst] = pool[:, :, src]
    return cache


# ---------------------------------------------------------------------------
# Prefix hashing — chained content address of a FULL block of prompt
# tokens (a hash names the whole prefix ending at that block). Ints only:
# python salts str hashing per process; int tuples hash stably.


def hash_block_tokens(prev_hash: int, tokens: Sequence[int]) -> int:
    """Chained content hash of one full block: ``h_j = H(h_{j-1}, tokens)``."""
    return hash((prev_hash,) + tuple(int(t) for t in tokens))


def prefix_block_hashes(tokens: Sequence[int], block_size: int,
                        salt: Any = None) -> List[int]:
    """Chain hashes of every FULL block of ``tokens`` (the partial tail
    block has no content address — it is never shared). ``salt`` (any
    hashable, default none) starts a separate chain: the engine salts an
    adapter-bound request's blocks with its adapter, whose K/V differ
    from the base model's for the same tokens."""
    out: List[int] = []
    h = hash(("apex_tpu.serve.prefix", block_size) if salt is None
             else ("apex_tpu.serve.prefix", block_size, salt))
    for j in range(len(tokens) // block_size):
        h = hash_block_tokens(h, tokens[j * block_size:(j + 1) * block_size])
        out.append(h)
    return out


# ---------------------------------------------------------------------------
# Host-side block allocator: a refcounted LIFO free list plus, with
# ``prefix_cache=True``, a hash -> block content map whose refcount-0
# blocks park in an LRU instead of returning to the free list.


class BlockAllocator:
    """Refcounted free-list (+ optional content-addressed prefix cache)
    over the pool's ``num_blocks`` block ids.

    Invariants (:meth:`assert_consistent`): every block is in exactly one
    of free list, evictable LRU (cached, refcount 0) or allocated
    (refcount >= 1); a block is evictable iff its refcount is 0 and it
    holds a content hash; freeing a refcount-0 or out-of-range id raises.
    """

    def __init__(self, num_blocks: int, prefix_cache: bool = False):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.num_blocks = num_blocks
        self.prefix_cache = prefix_cache
        # LIFO: recently freed blocks are re-used first
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refcount: Dict[int, int] = {}
        self._hash_to_block: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        # refcount-0 cached blocks, least-recently-used first
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.blocks_reused_total = 0
        self.blocks_evicted_total = 0

    @property
    def free_count(self) -> int:
        """Allocatable blocks: truly free + evictable cached."""
        return len(self._free) + len(self._lru)

    @property
    def cached_count(self) -> int:
        """Blocks holding a content address (shared or parked)."""
        return len(self._block_hash)

    def refcount(self, block: int) -> int:
        return self._refcount.get(block, 0)

    def _evict_one(self) -> None:
        b, _ = self._lru.popitem(last=False)  # least recently used
        h = self._block_hash.pop(b)
        del self._hash_to_block[h]
        self._free.append(b)
        self.blocks_evicted_total += 1

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh block ids at refcount 1, or None when the pool cannot
        satisfy the request even after evicting every refcount-0 cached
        block (never a partial grant)."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > self.free_count:
            return None
        while len(self._free) < n:
            self._evict_one()
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refcount[b] = 1
        return out

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id. A cached block reaching refcount 0
        parks in the evictable LRU; an uncached one returns to the free
        list."""
        for b in ids:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range")
            rc = self._refcount.get(b, 0)
            if rc <= 0:
                raise ValueError(f"double free of block {b}")
            if rc > 1:
                self._refcount[b] = rc - 1
                continue
            del self._refcount[b]
            if b in self._block_hash:
                self._lru[b] = None          # most-recently-used end
            else:
                self._free.append(b)

    def lookup(self, hashes: Sequence[int]) -> List[int]:
        """Longest cached prefix of the chained ``hashes``: acquires one
        reference each and returns the matched block ids in prefix order.
        Always misses when the allocator is plain."""
        if not self.prefix_cache:
            return []
        out: List[int] = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            out.append(b)
        for b in out:
            rc = self._refcount.get(b, 0)
            if rc == 0:
                self._lru.pop(b, None)
            self._refcount[b] = rc + 1
            self.blocks_reused_total += 1
        return out

    def commit(self, block: int, h: int) -> bool:
        """Register an allocated, fully written block under its content
        hash. False (no-op) when the allocator is plain, the hash is
        already mapped, or the block already carries an address."""
        if self._refcount.get(block, 0) <= 0:
            raise ValueError(f"commit of unallocated block {block}")
        if not self.prefix_cache:
            return False
        if h in self._hash_to_block or block in self._block_hash:
            return False
        self._hash_to_block[h] = block
        self._block_hash[block] = h
        return True

    def assert_consistent(self) -> None:
        """Every-block-in-exactly-one-place conservation check."""
        free = set(self._free)
        lru = set(self._lru)
        alloc = set(self._refcount)
        if (free & lru) or (free & alloc) or (lru & alloc):
            raise AssertionError("a block is in two places")
        if len(free) + len(lru) + len(alloc) != self.num_blocks:
            raise AssertionError("blocks lost or duplicated")
        if any(rc < 1 for rc in self._refcount.values()):
            raise AssertionError("allocated block with refcount < 1")
        for b in lru:
            if b not in self._block_hash:
                raise AssertionError(f"evictable block {b} uncached")
        for h, b in self._hash_to_block.items():
            if self._block_hash.get(b) != h:
                raise AssertionError(f"hash map out of sync at block {b}")


# ---------------------------------------------------------------------------
# Byte accounting — modeled device-memory traffic of the paged cache.


def _elem_bytes(cfg: KVCacheConfig) -> float:
    """Bytes per cached K or V element, scale overhead amortized in."""
    if cfg.quantized and cfg.bits == 4:
        return 0.5 + 2.0 / cfg.kv_group  # nibble code + bf16 group scale
    if cfg.quantized:
        return 1.0 + 4.0 / cfg.head_dim  # int8 code + fp32 vector scale
    return float(torch.empty((), dtype=cfg.dtype).element_size())


def kv_cache_bytes(cfg: KVCacheConfig) -> int:
    """Device memory held by the allocatable pools (the trash block is one
    extra block per layer and head, not counted)."""
    n = (cfg.num_layers * cfg.num_heads * cfg.num_blocks * cfg.block_size
         * cfg.head_dim)
    return int(2 * n * _elem_bytes(cfg))


def kv_write_bytes_per_token(cfg: KVCacheConfig) -> float:
    """Bytes written to the pools per cached token (all layers, K+V)."""
    return 2 * cfg.num_layers * cfg.num_heads * cfg.head_dim * _elem_bytes(cfg)


def kv_read_bytes(cfg: KVCacheConfig, seq_lens: Sequence[int]) -> float:
    """Modeled bytes read by ONE decode step over the given context lengths,
    in whole blocks per slot (the JAX model's convention)."""
    toks = sum(cfg.blocks_for_tokens(int(s)) * cfg.block_size
               for s in seq_lens if int(s) > 0)
    return (2 * cfg.num_layers * cfg.num_heads * cfg.head_dim
            * _elem_bytes(cfg) * toks)
