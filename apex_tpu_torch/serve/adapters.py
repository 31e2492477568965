"""Per-tenant paged LoRA adapters (counterpart of
``apex_tpu/serve/adapters.py``).

Rank-r LoRA factors for the four adapted projections (fused QKV, attention
out, FC1, FC2) live in one **adapter pool** (:func:`init_adapter_pool`):
per target, ``f"{t}_a"`` (L, S, d_in, r) and ``f"{t}_b"`` (L, S, r, d_out)
on the engine's device, S = ``max_adapters + 1`` slots. Slot 0 is the base
model, all zeros, so ``adapter_id == 0`` adds an exact zero (a zero
matmul, not a select) and base traffic gives the streams of an engine
without adapters. :func:`lora_delta` is JAX's gathered BGMV: each row
gathers its adapter's factors by id and adds ``(x @ A[aid]) @ B[aid]``.

Row-count invariance: the gathered products run over the flat rows in
tiles of exactly ``decode.GEMM_ROW_TILE`` rows (the last one padded with
slot-0 rows), as the per-op path's ``_dense`` runs every projection. Each
tile is one batched product of a fixed shape, whose batch entries are
computed independently, so a row's bits do not depend on how many rows
share the call or what they hold: a slot decodes, verifies and prefills
to the same bits alone or among many, and speculative streams stay equal
to plain decode under adapter traffic.

:func:`write_adapter` writes one adapter into a pool slot in place (the
LoRA scale folded into B; slot 0 refuses), :func:`merge_adapter_params` is
the dense merged-weight oracle, and :class:`AdapterRegistry` is JAX's
host-side bookkeeping (refcounts, idle LRU, loud refusal,
``assert_consistent``), line for line.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import DeviceLike, resolve_device

# the four adapted projections; pool keys are f"{target}_a"/f"{target}_b"
ADAPTER_TARGETS = ("qkv", "out", "fc1", "fc2")

# rows of one gathered product: decode.GEMM_ROW_TILE's value (decode
# imports this module, so the constant is repeated; a test holds them equal)
LORA_ROW_TILE = 64


def _target_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) per adapted projection — the standalone_gpt layer
    kernel shapes (qkv (h, 3h), out (h, h), fc1 (h, f), fc2 (f, h))."""
    h, f = cfg.hidden, cfg.ffn_hidden
    return {"qkv": (h, 3 * h), "out": (h, h), "fc1": (h, f), "fc2": (f, h)}


def init_adapter_pool(cfg, rank: int, max_adapters: int, dtype=None,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The zero-initialised adapter pool on ``device`` (default ``cuda``):
    ``f"{t}_a"`` (L, S, d_in, rank) and ``f"{t}_b"`` (L, S, rank, d_out) per
    target t, S = ``max_adapters + 1`` (slot 0: the base model's zero
    delta), in ``dtype`` (default the model's)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if max_adapters < 1:
        raise ValueError(f"max_adapters must be >= 1, got {max_adapters}")
    dev = resolve_device(device)
    dt = dtype if dtype is not None else cfg.dtype
    L, S = cfg.num_layers, max_adapters + 1
    pool = {}
    for t, (d_in, d_out) in _target_dims(cfg).items():
        pool[f"{t}_a"] = torch.zeros((L, S, d_in, rank), dtype=dt, device=dev)
        pool[f"{t}_b"] = torch.zeros((L, S, rank, d_out), dtype=dt,
                                     device=dev)
    return pool


def adapter_pool_bytes(cfg, rank: int, max_adapters: int,
                       dtype=None) -> int:
    """Device bytes :func:`init_adapter_pool` allocates."""
    dt = dtype if dtype is not None else cfg.dtype
    itemsize = torch.empty((), dtype=dt).element_size()
    S = max_adapters + 1
    elems = sum((d_in + d_out) * rank
                for d_in, d_out in _target_dims(cfg).values())
    return cfg.num_layers * S * elems * itemsize


def make_adapter_weights(cfg, rank: int,
                         generator: Optional[torch.Generator] = None,
                         std: float = 0.02, device: DeviceLike = "cpu"
                         ) -> Dict[str, torch.Tensor]:
    """Random adapter weights for tests and benches: per target
    ``f"{t}_a"`` (L, d_in, r) and ``f"{t}_b"`` (L, r, d_out), both
    normal(std), drawn on the CPU from ``generator`` (default: seeded 0)
    and moved to ``device``, so a seed gives the same weights on every
    device. Nonzero B, unlike a training init, so the delta is not
    vacuous."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = resolve_device(device)
    out = {}
    dims = _target_dims(cfg)
    for t in ADAPTER_TARGETS:
        d_in, d_out = dims[t]
        for side, shape in (("a", (cfg.num_layers, d_in, rank)),
                            ("b", (cfg.num_layers, rank, d_out))):
            w = torch.randn(shape, generator=generator) * std
            out[f"{t}_{side}"] = w.to(cfg.dtype).to(dev)
    return out


def _check_weights(pool, weights) -> None:
    for t in ADAPTER_TARGETS:
        for side in ("a", "b"):
            k = f"{t}_{side}"
            if k not in weights:
                raise ValueError(f"adapter weights missing {k!r}")
            want = tuple(pool[k].shape[:1] + pool[k].shape[2:])
            got = tuple(weights[k].shape)
            if got != want:
                raise ValueError(
                    f"adapter weights[{k!r}] shape {got} != pool slot "
                    f"shape {want}")


def write_adapter(pool: Dict[str, torch.Tensor], slot: int, weights,
                  scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Write one adapter's factors into pool ``slot`` in place and return
    the pool. ``scale`` (the LoRA alpha/r) is folded into B here, as JAX
    folds it (B · scale in B's type, then cast to the pool's); the
    products apply a bare ``(x @ A) @ B``. Slot 0 (the base model's zero
    delta) refuses writes."""
    if not 1 <= slot <= pool["qkv_a"].shape[1] - 1:
        raise ValueError(
            f"slot must be in [1, {pool['qkv_a'].shape[1] - 1}] "
            f"(slot 0 is the reserved base zero-delta), got {slot}")
    _check_weights(pool, weights)
    with torch.no_grad():
        for t in ADAPTER_TARGETS:
            a, b = pool[f"{t}_a"], pool[f"{t}_b"]
            a[:, slot].copy_(weights[f"{t}_a"].to(a.device, a.dtype))
            wb = weights[f"{t}_b"]
            b[:, slot].copy_((wb * scale).to(b.device, b.dtype))
    return pool


def merge_adapter_params(params, weights, scale: float = 1.0):
    """The dense merged-weight oracle: a new parameter dict whose adapted
    kernels are ``W + (A @ B) * scale`` in W's type — what a per-tenant
    merged checkpoint would serve."""
    layers = dict(params["layers"])
    for t, kern in (("qkv", "qkv_kernel"), ("out", "out_kernel"),
                    ("fc1", "fc1_kernel"), ("fc2", "fc2_kernel")):
        w = layers[kern]
        a = weights[f"{t}_a"].to(w.device, w.dtype)
        b = weights[f"{t}_b"].to(w.device, w.dtype)
        delta = torch.einsum("lir,lro->lio", a, b) * scale
        layers[kern] = w + delta.to(w.dtype)
    return {**params, "layers": layers}


def lora_rows(adapter_ids, q: int, device=None):
    """The pool slot of every flat row of (n, q) rows: each slot's id ``q``
    times, as int64, padded with slot 0 to whole tiles of
    :data:`LORA_ROW_TILE` rows (a broadcast, no device read). A serve call
    computes it once and hands it to every :func:`lora_delta_rows`."""
    ids = adapter_ids.to(device=device or adapter_ids.device,
                         dtype=torch.long)
    rows = ids[:, None].expand(ids.shape[0], q).reshape(-1)
    pad = -rows.shape[0] % LORA_ROW_TILE
    return F.pad(rows, (0, pad)) if pad else rows


def lora_delta_rows(x, a, b, rows):
    """:func:`lora_delta` with the row ids of :func:`lora_rows`: ``x``
    (n, q, d_in), ``rows`` (tiles · LORA_ROW_TILE,) int64."""
    n, q, d_in = x.shape
    r = n * q
    x2 = x.reshape(r, 1, d_in)
    pad = rows.shape[0] - r
    if pad:
        x2 = F.pad(x2, (0, 0, 0, 0, 0, pad))
    outs = []
    for i in range(rows.shape[0] // LORA_ROW_TILE):
        sl = slice(i * LORA_ROW_TILE, (i + 1) * LORA_ROW_TILE)
        ag = a.index_select(0, rows[sl]).to(x.dtype)      # (T, d_in, r)
        bg = b.index_select(0, rows[sl]).to(x.dtype)      # (T, r, d_out)
        outs.append(torch.bmm(torch.bmm(x2[sl], ag), bg))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:r].reshape(n, q, -1)


def lora_delta(x, a, b, adapter_ids):
    """Gathered BGMV: ``x`` (n, q, d_in) against one layer's slot stacks
    ``a`` (S, d_in, r) / ``b`` (S, r, d_out), each slot's q rows applying
    its adapter ``adapter_ids`` (n,): returns ``(x @ A[aid]) @ B[aid]``
    (n, q, d_out) in x's type. Id 0 gathers the all-zero base slot, an
    exact zero. The products run in fixed tiles of :data:`LORA_ROW_TILE`
    rows (see the module docstring)."""
    return lora_delta_rows(x, a, b,
                           lora_rows(adapter_ids, x.shape[1], x.device))


class AdapterRegistry:
    """Host-side slot bookkeeping for the adapter pool — the
    ``BlockAllocator`` discipline applied to weights (JAX's class).

    Named adapters map to pool slots ``1..max_adapters`` (slot 0 is the
    base model and never allocated). :meth:`acquire` pins an adapter for a
    decoding slot (refcount up, LRU touch); :meth:`release` unpins;
    :meth:`load` assigns a slot to a new name, evicting the least recently
    idle (refcount-0) resident under pool pressure and refusing, loudly,
    when every resident is pinned. The registry never touches the pool;
    callers pair ``load`` with :func:`write_adapter`. Counters:
    ``hits_total`` / ``misses_total`` (acquire outcomes), ``loads_total``
    / ``unloads_total`` / ``evictions_total``."""

    def __init__(self, max_adapters: int):
        if max_adapters < 1:
            raise ValueError(
                f"max_adapters must be >= 1, got {max_adapters}")
        self.max_adapters = max_adapters
        # LIFO free list, slot 1 on top (deterministic assignment order)
        self._free: List[int] = list(range(max_adapters, 0, -1))
        self._slots: Dict[str, int] = {}
        self._refs: Dict[str, int] = {}
        # idle (refcount-0) residents in LRU order: front = evict first
        self._idle: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict())
        self.hits_total = 0
        self.misses_total = 0
        self.loads_total = 0
        self.unloads_total = 0
        self.evictions_total = 0

    # -- queries -----------------------------------------------------------
    def lookup(self, name: str) -> Optional[int]:
        """Resident slot of ``name`` (no refcount, no counters)."""
        return self._slots.get(name)

    def resident(self) -> Dict[str, int]:
        """name -> slot for every resident adapter."""
        return dict(self._slots)

    @property
    def resident_count(self) -> int:
        return len(self._slots)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def refcount(self, name: str) -> int:
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} is not resident")
        return self._refs[name]

    def counters(self) -> Dict[str, int]:
        return {"hits_total": self.hits_total,
                "misses_total": self.misses_total,
                "loads_total": self.loads_total,
                "unloads_total": self.unloads_total,
                "evictions_total": self.evictions_total}

    # -- refcounting (one ref per decoding slot) ---------------------------
    def acquire(self, name: str) -> Optional[int]:
        """Pin ``name`` for a decoding slot: refcount up, slot returned.
        ``None`` when it is not resident (a miss: the engine sheds); a
        pinned adapter is never evicted under a live stream."""
        slot = self._slots.get(name)
        if slot is None:
            self.misses_total += 1
            return None
        self.hits_total += 1
        self._refs[name] += 1
        self._idle.pop(name, None)
        return slot

    def release(self, name: str) -> None:
        """Drop one ref; at zero the adapter parks in the idle LRU (most
        recently released evicts last)."""
        if name not in self._slots:
            raise RuntimeError(f"release of non-resident adapter {name!r}")
        if self._refs[name] <= 0:
            raise RuntimeError(f"release of unreferenced adapter {name!r}")
        self._refs[name] -= 1
        if self._refs[name] == 0:
            self._idle[name] = None

    # -- load / unload / evict ---------------------------------------------
    def load(self, name: str) -> int:
        """Assign a pool slot to ``name`` (an idempotent refresh when it is
        resident). Under pool pressure the least recently idle resident is
        evicted; when every resident is pinned the load refuses instead of
        corrupting a live stream."""
        slot = self._slots.get(name)
        if slot is not None:
            self.loads_total += 1
            return slot
        if not self._free:
            if not self._idle:
                raise RuntimeError(
                    f"adapter pool exhausted: all {self.max_adapters} "
                    f"resident adapters are pinned by decoding slots — "
                    f"retire or migrate their requests first")
            victim, _ = self._idle.popitem(last=False)
            self._free.append(self._slots.pop(victim))
            del self._refs[victim]
            self.evictions_total += 1
        slot = self._free.pop()
        self._slots[name] = slot
        self._refs[name] = 0
        self._idle[name] = None
        self.loads_total += 1
        return slot

    def unload(self, name: str) -> None:
        """Remove an idle resident (refcount must be 0)."""
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} is not resident")
        if self._refs[name] > 0:
            raise RuntimeError(
                f"cannot unload adapter {name!r}: "
                f"{self._refs[name]} decoding slot(s) still reference it")
        self._free.append(self._slots.pop(name))
        del self._refs[name]
        self._idle.pop(name, None)
        self.unloads_total += 1

    # -- invariants ---------------------------------------------------------
    def assert_consistent(self) -> None:
        """Resident + free slots partition 1..max_adapters, refcounts
        exist for exactly the residents and are never negative, and the
        idle LRU is exactly the refcount-0 residents."""
        used = sorted(self._slots.values())
        if len(set(used)) != len(used):
            raise AssertionError(f"duplicate slot assignment: {used}")
        if set(used) & set(self._free):
            raise AssertionError("slot both resident and free")
        if sorted(used + self._free) != list(
                range(1, self.max_adapters + 1)):
            raise AssertionError(
                f"slots {sorted(used + self._free)} do not partition "
                f"1..{self.max_adapters}")
        if set(self._refs) != set(self._slots):
            raise AssertionError("refcount keys != resident keys")
        if any(r < 0 for r in self._refs.values()):
            raise AssertionError(f"negative refcount: {self._refs}")
        idle = {n for n, r in self._refs.items() if r == 0}
        if set(self._idle) != idle:
            raise AssertionError(
                f"idle LRU {set(self._idle)} != refcount-0 set {idle}")
