"""Iteration-level continuous-batching inference engine (counterpart of
``apex_tpu/serve/engine.py``), single device.

A fixed grid of decode slots advances one token per step; between steps
finished requests retire and waiting ones are admitted (FCFS) into the
freed slots. On the same paged cache:

* **chunked prefill** — prompts are processed as fixed-size chunks
  (``ServeConfig.prefill_chunk``), one chunk per step, interleaved with
  the decode of the slots already generating;
* **prefix caching** — admission looks up the longest cached prefix of
  the prompt at block granularity (``kv_cache.BlockAllocator``) and only
  prefills the tail; a fully cached prompt recomputes its last position in
  a private copy of the last shared block (copy-on-write), so a shared
  block is never mutated;
* **self-speculative decoding** — a host-side drafter proposes up to
  ``spec_k`` tokens per slot and one q=k+1 verify call checks them; the
  engine keeps the longest run matching its own position-keyed draws, so
  streams equal non-speculative decode (greedy and sampled).

Slot bookkeeping (block tables, lengths, last tokens, keys) is host-side
numpy with cached device copies, re-uploaded only after a host change
(through pinned memory, without a sync). The one sync per step is the
copy of the sampled tokens back to the host.

The decode and verify calls run the fused per-layer kernel
(``serve.megakernel``) when ``ServeConfig.megakernel`` resolves to it — the
default ``"auto"`` does on a CUDA engine whose shape the kernel takes, as
JAX's does on its compiled backend — else the per-op programs of
``serve.decode``; prefill chunks always take the per-op program.
``kv_quant="int8"|"int4"`` keeps the pools in the ``comm.quantize`` codec.

Outside this slice: LoRA adapters and plan-sharded serving
(``ServeConfig`` raises ``NotImplementedError`` for each), and the
``monitor`` telemetry (events, histograms, SLOs, metering):
:meth:`InferenceEngine.stats` reports counts and numpy quantiles instead.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.monitor.hist import Histogram
from apex_tpu_torch.serve.decode import (
    gpt_decode_step,
    gpt_prefill_chunk,
    gpt_verify_step,
)
from apex_tpu_torch.serve.drafter import Drafter, NGramDrafter
from apex_tpu_torch.serve.megakernel import (
    gpt_decode_step_fused,
    gpt_verify_step_fused,
    megakernel_refusal,
    warn_megakernel_fallback,
)
from apex_tpu_torch.serve.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    copy_block,
    init_kv_cache,
    kv_cache_bytes,
    prefix_block_hashes,
)
from apex_tpu_torch.serve.sampling import SamplingConfig, request_key, sample


@dataclasses.dataclass
class Request:
    """One generation request. ``seed`` feeds the request's sampling key
    (default: crc32 of the uid — stable across runs and admission orders);
    irrelevant under greedy decoding."""

    uid: str
    tokens: Sequence[int]
    max_new_tokens: int = 64
    seed: Optional[int] = None

    def sampling_seed(self) -> int:
        if self.seed is not None:
            return int(self.seed)
        return zlib.crc32(self.uid.encode())


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape knobs, JAX's fields and defaults. ``megakernel``:
    ``"auto"`` runs decode and verify through the fused per-layer kernel on
    a CUDA engine when the shape allows it (else the per-op path, with a
    warning logged once per reason) and the per-op path on a CPU engine;
    ``"on"`` forces the fused layer (its plain version on the CPU) and
    raises with the reason on an unsupported shape; ``"off"`` keeps the
    per-op path. ``kv_quant``: ``"none"``, ``"int8"`` or ``"int4"`` pools
    (``kv_group``: int4 scale-group length). The LoRA and plan fields
    exist so a JAX config reads the same; their non-default values raise
    ``NotImplementedError`` until their slice is ported."""

    num_slots: int = 4
    block_size: int = 16
    # total pool blocks; default = num_slots * blocks-per-max-context
    num_blocks: Optional[int] = None
    # tokens per prefill chunk, one chunk per step
    prefill_chunk: int = 32
    prefix_cache: bool = True
    # draft up to spec_k tokens per slot per step; 0 disables
    spec_k: int = 0
    spec_ngram: int = 3
    megakernel: str = "auto"
    max_context: Optional[int] = None  # default: model cfg.max_seq
    eos_id: Optional[int] = None
    kv_quant: str = "none"
    kv_group: Optional[int] = None
    lora_rank: int = 0
    max_adapters: int = 0
    plan: Optional[Any] = None
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)

    def validate(self) -> None:
        if self.num_slots <= 0:
            raise ValueError("num_slots must be positive")
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if self.num_blocks is not None and self.num_blocks <= 0:
            raise ValueError("num_blocks must be positive when given")
        if self.prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be positive")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if self.megakernel not in ("auto", "on", "off"):
            raise ValueError(f"megakernel must be 'auto', 'on' or 'off', "
                             f"got {self.megakernel!r}")
        if self.max_context is not None and self.max_context <= 0:
            raise ValueError("max_context must be positive when given")
        if self.kv_quant not in ("none", "int8", "int4"):
            raise ValueError(f"kv_quant must be 'none', 'int8' or 'int4', "
                             f"got {self.kv_quant!r}")
        if self.kv_group is not None and self.kv_quant != "int4":
            raise ValueError("kv_group only applies to kv_quant='int4'")
        if self.lora_rank < 0 or self.max_adapters < 0:
            raise ValueError("lora_rank and max_adapters must be >= 0")
        if self.lora_rank > 0 or self.max_adapters > 0:
            raise NotImplementedError(
                "LoRA adapters (lora_rank > 0) are not ported yet: "
                "serve.adapters is ROADMAP §A item 8")
        if self.plan is not None:
            raise NotImplementedError(
                "plan-sharded serving (ServeConfig.plan) is not ported yet: "
                "serve.sharded is ROADMAP §A item 8")
        self.sampling.validate()


@dataclasses.dataclass
class _SlotState:
    request: Request
    blocks: List[int]          # every block the slot holds a ref on
    generated: List[int]
    history: List[int]         # prompt + generated (the drafter reads it)
    prompt_len: int
    prefill_pos: int           # prompt tokens cached so far (chunk cursor)
    cached_tokens: int         # prompt tokens served by the prefix cache
    # (block_id, hash, end_pos): commit to the content map once the chunk
    # cursor passes end_pos (the block is then fully written)
    pending_commits: List[Tuple[int, int, int]]
    t_submit_ms: float
    t_first_ms: float = 0.0
    queue_ms: float = 0.0
    ttft_ms: float = 0.0


# the engine's latency dimensions (JAX's ``_HIST_NAMES``); each gets a
# streaming Histogram, so the records stay O(1) however long the run
_HIST_NAMES = ("ttft_ms", "tpot_ms", "queue_ms", "e2e_ms",
               "decode_step_ms", "verify_step_ms")

# host arrays with cached device copies (uploaded only when changed)
_MIRROR_NAMES = ("block_tables", "seq_lens", "last_tokens", "active", "keys")


class InferenceEngine:
    """Continuous-batching engine over one parameter dict (the layout of
    ``transformer.testing.init_gpt_params`` / ``convert.params_from_numpy``).

    ``device``: where the params, pools and programs live (default
    ``cuda``; raises without CUDA unless ``device="cpu"``). The params must
    already be there. ``base_seed`` keys sampled draws. ``drafter``: the
    speculative proposer (default with ``spec_k > 0``: ``NGramDrafter``).
    ``on_reject(request, info)``: when given, a request the pool can never
    fit is handed back instead of ``run()`` raising. ``retain_streams=False``
    hands each finished stream to ``on_retire(uid, tokens)`` instead of
    keeping it.
    """

    def __init__(self, params, cfg, serve_cfg: Optional[ServeConfig] = None,
                 *, device: DeviceLike = None, base_seed: int = 0,
                 drafter: Optional[Drafter] = None,
                 on_reject: Optional[Callable[[Request, Dict[str, Any]],
                                              None]] = None,
                 retain_streams: bool = True,
                 on_retire: Optional[Callable[[str, List[int]],
                                              None]] = None):
        scfg = serve_cfg or ServeConfig()
        scfg.validate()
        cfg.validate()
        self.device = resolve_device(device)
        leaf = params["embed"]["tok"]
        if leaf.device != self.device:
            raise ValueError(f"params are on {leaf.device}, the engine on "
                             f"{self.device}: convert them with "
                             f"params_from_numpy(tree, device)")
        self.params = params
        self.cfg = cfg
        self.serve_cfg = scfg
        if scfg.max_context is not None and scfg.max_context > cfg.max_seq:
            raise ValueError(
                f"max_context ({scfg.max_context}) exceeds the model's "
                f"max_seq ({cfg.max_seq})")
        self.max_context = scfg.max_context or cfg.max_seq
        bs = scfg.block_size
        self._blocks_per_slot = -(-self.max_context // bs)
        num_blocks = (scfg.num_blocks if scfg.num_blocks is not None
                      else scfg.num_slots * self._blocks_per_slot)
        self.kv_cfg = KVCacheConfig(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            head_dim=cfg.head_dim, num_blocks=num_blocks, block_size=bs,
            dtype=cfg.dtype, quantized=scfg.kv_quant != "none",
            bits=4 if scfg.kv_quant == "int4" else 8,
            group_size=scfg.kv_group)
        self.allocator = BlockAllocator(num_blocks,
                                        prefix_cache=scfg.prefix_cache)
        self.cache = init_kv_cache(self.kv_cfg, self.device)
        self.drafter: Optional[Drafter] = None
        if scfg.spec_k > 0:
            self.drafter = (drafter if drafter is not None
                            else NGramDrafter(ngram=scfg.spec_ngram))
        elif drafter is not None:
            raise ValueError("drafter given but spec_k == 0 — set "
                             "ServeConfig.spec_k to enable speculation")
        n = scfg.num_slots
        self._block_tables = np.zeros((n, self._blocks_per_slot), np.int32)
        self._seq_lens = np.zeros((n,), np.int32)
        self._last_tokens = np.zeros((n,), np.int32)
        self._active = np.zeros((n,), bool)
        self._keys = np.zeros((n,), np.int64)
        self._dev_cache: Dict[str, torch.Tensor] = {}
        self.transfer_counts: Dict[str, int] = {
            nm: 0 for nm in _MIRROR_NAMES}
        self._slots: List[Optional[_SlotState]] = [None] * n
        # admission-ordered slots with prompt tokens still to prefill; the
        # front slot gets one chunk per step
        self._prefill_queue: collections.deque = collections.deque()
        self._pending: collections.deque = collections.deque()
        self._finished: Dict[str, List[int]] = {}
        self._base_seed = int(base_seed)
        self._retain_streams = retain_streams
        self._on_retire = on_retire
        self._on_reject = on_reject
        self._t_anchor = time.perf_counter()
        self._t_start: Optional[float] = None
        self._step_idx = 0
        self._tokens_generated = 0
        self._rejected = 0
        self._completed = 0
        self.hists: Dict[str, Histogram] = {
            name: Histogram() for name in _HIST_NAMES}
        self._prefix_blocks_hit = 0
        self._prefix_blocks_needed = 0
        self._prefill_tokens_saved = 0
        self._cow_copies = 0
        self._chunks_run = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._verify_steps = 0
        self._decode_steps = 0
        self._megakernel = self._resolve_megakernel()

    def _resolve_megakernel(self) -> bool:
        """``ServeConfig.megakernel`` -> whether the decode AND verify calls
        run the fused layer, gated on the verify call's spec_k + 1 rows per
        slot so speculation never flips the choice. ``auto`` needs the
        kernel itself (a CUDA engine): on a CUDA engine it falls back to the
        per-op path only with a reason, logged once; on the CPU it means
        per-op. ``on`` raises with the reason on an unsupported shape."""
        mode = self.serve_cfg.megakernel
        if mode == "off":
            return False
        cuda = self.device.type == "cuda"
        if mode == "auto" and not cuda:
            return False
        reason = megakernel_refusal(
            self.cfg, self.kv_cfg, allow_interpret=not cuda,
            q=self.serve_cfg.spec_k + 1, slots=self.serve_cfg.num_slots)
        if mode == "on":
            if reason is not None:
                raise ValueError(
                    f"megakernel='on' but the fused decode layer does not "
                    f"support this configuration: {reason} — use "
                    f"megakernel='off'/'auto'")
            return True
        if reason is not None:
            warn_megakernel_fallback(reason)
            return False
        return True

    @property
    def megakernel_enabled(self) -> bool:
        """Whether decode and verify run the fused per-layer kernel."""
        return self._megakernel

    @property
    def decode_kernel(self) -> str:
        """The decode path this engine runs: ``fused`` (the per-layer
        megakernel, or its plain version on the CPU), else the per-op
        path's ``cuda`` (the paged-attention and LayerNorm kernels) on a
        CUDA engine or ``plain`` (their PyTorch versions) on the CPU."""
        if self._megakernel:
            return "fused"
        return "cuda" if self.device.type == "cuda" else "plain"

    @property
    def verify_kernel(self) -> Optional[str]:
        """The speculative verify path: ``None`` when ``spec_k == 0``, else
        :attr:`decode_kernel` (one flag drives both calls)."""
        if self.serve_cfg.spec_k <= 0:
            return None
        return self.decode_kernel

    # -- device copies -----------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()  # the host array keeps changing

    def _dirty(self, *names: str) -> None:
        for nm in names:
            self._dev_cache.pop(nm, None)

    def _dev(self, name: str) -> torch.Tensor:
        """Cached device copy of host array ``self._<name>``."""
        t = self._dev_cache.get(name)
        if t is None:
            t = self._upload(getattr(self, "_" + name))
            self._dev_cache[name] = t
            self.transfer_counts[name] += 1
        return t

    # -- submission --------------------------------------------------------
    def submit(self, request: Request) -> None:
        p = len(request.tokens)
        if p < 1:
            raise ValueError(f"{request.uid}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(f"{request.uid}: max_new_tokens must be >= 1")
        if p >= self.max_context:
            raise ValueError(
                f"{request.uid}: prompt ({p}) must leave room to generate "
                f"(max_context {self.max_context})")
        self._pending.append((request, self._now_ms()))

    def _now_ms(self) -> float:
        return (time.perf_counter() - self._t_anchor) * 1e3

    # -- admission ---------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _total_tokens(self, request: Request) -> int:
        # cached tokens at retirement: prompt + all generated but the last
        return min(len(request.tokens) + request.max_new_tokens,
                   self.max_context)

    def _try_admit(self) -> int:
        admitted = 0
        while self._pending:
            slot = self._free_slot()
            if slot is None:
                break
            request, t_submit = self._pending[0]
            n_blocks = self.kv_cfg.blocks_for_tokens(
                self._total_tokens(request))
            bs = self.kv_cfg.block_size
            hashes = (prefix_block_hashes(request.tokens, bs)
                      if self.serve_cfg.prefix_cache else [])
            # acquire the longest cached prefix FIRST (a ref pins those
            # blocks against the eviction alloc() may run next)
            hit = self.allocator.lookup(hashes)
            # a full-prompt hit recomputes the final position, whose write
            # lands in the last matched block: copy it first (CoW)
            cow = bool(hit) and len(hit) * bs >= len(request.tokens)
            fresh = self.allocator.alloc(
                n_blocks - len(hit) + (1 if cow else 0))
            if fresh is None and cow:
                # no room for the copy: prefill the last block instead
                self.allocator.free([hit[-1]])
                hit = hit[:-1]
                cow = False
                fresh = self.allocator.alloc(n_blocks - len(hit))
            if fresh is None:
                if hit:
                    self.allocator.free(hit)
                break  # pool full: wait for a retirement
            self._pending.popleft()
            self._admit(slot, request, hit, fresh, cow, hashes, t_submit)
            admitted += 1
        return admitted

    def _admit(self, slot: int, request: Request, hit: List[int],
               fresh: List[int], cow: bool, hashes: List[int],
               t_submit_ms: float) -> None:
        p = len(request.tokens)
        bs = self.kv_cfg.block_size
        n_hit = len(hit)
        if cow:
            # fresh[0] replaces the last matched block: copy the shared
            # content on device, drop OUR ref on the source
            src, dst = hit[-1], fresh[0]
            copy_block(self.cache, src, dst)
            self.allocator.free([src])
            blocks = hit[:-1] + [dst] + fresh[1:]
            self._cow_copies += 1
        else:
            blocks = hit + fresh
        cached = min(n_hit * bs, p - 1)  # position p-1 always recomputed
        n_full = p // bs
        if self.serve_cfg.prefix_cache:
            self._prefix_blocks_needed += n_full
            self._prefix_blocks_hit += min(n_hit, n_full)
        self._prefill_tokens_saved += cached
        row = np.zeros((self._blocks_per_slot,), np.int32)
        row[:len(blocks)] = blocks
        # blocks the tail prefill fills: committed to the content map as
        # the chunk cursor passes their end (never before)
        commits = [(int(row[j]), hashes[j], (j + 1) * bs)
                   for j in range(n_hit, n_full)] if hashes else []
        if cow:
            commits.append((int(blocks[n_hit - 1]), hashes[n_full - 1], p))
        self._slots[slot] = _SlotState(
            request=request, blocks=blocks, generated=[],
            history=[int(t) for t in request.tokens], prompt_len=p,
            prefill_pos=cached, cached_tokens=cached,
            pending_commits=commits, t_submit_ms=t_submit_ms,
            queue_ms=self._now_ms() - t_submit_ms)
        self._block_tables[slot] = row
        self._keys[slot] = request_key(self._base_seed,
                                       request.sampling_seed())
        self._dirty("block_tables", "keys")
        self._prefill_queue.append(slot)

    # -- chunked prefill ---------------------------------------------------
    def _prefill_backlog_tokens(self) -> int:
        return sum(s.prompt_len - s.prefill_pos for s in self._slots
                   if s is not None and s.prefill_pos < s.prompt_len)

    def _run_prefill_chunk(self) -> bool:
        """One chunk for the front of the prefill queue; on the prompt's
        final chunk, sample the first token and move the slot to the
        decode grid."""
        if not self._prefill_queue:
            return False
        slot = self._prefill_queue[0]
        state = self._slots[slot]
        C = self.serve_cfg.prefill_chunk
        c = state.prefill_pos
        p = state.prompt_len
        n_valid = min(C, p - c)
        tokens = np.zeros((C,), np.int32)
        tokens[:n_valid] = np.asarray(state.request.tokens[c:c + n_valid],
                                      np.int32)
        self.cache, logits = gpt_prefill_chunk(
            self.params, self._upload(tokens), c, n_valid, self.cache,
            self._dev("block_tables")[slot], self.cfg, self.kv_cfg)
        state.prefill_pos = c + n_valid
        self._chunks_run += 1
        done = state.prefill_pos >= p
        if done:
            pos = torch.full((1,), p, dtype=torch.int64, device=self.device)
            tok = sample(logits[None], self._dev("keys")[slot:slot + 1], pos,
                         self.serve_cfg.sampling)
            first = int(tok[0])  # fence: TTFT includes the round trip
        while (state.pending_commits
               and state.pending_commits[0][2] <= state.prefill_pos):
            b, h, _ = state.pending_commits.pop(0)
            self.allocator.commit(b, h)
        if not done:
            return True
        self._prefill_queue.popleft()
        t_first = self._now_ms()
        state.t_first_ms = t_first
        state.ttft_ms = t_first - state.t_submit_ms
        if self._t_start is None:
            self._t_start = time.perf_counter()
        self._tokens_generated += 1
        state.generated.append(first)
        state.history.append(first)
        self._seq_lens[slot] = p
        self._last_tokens[slot] = first
        self._active[slot] = True
        self._dirty("seq_lens", "last_tokens", "active")
        if self._should_retire(state, first):
            self._retire(slot)
        return True

    # -- retirement --------------------------------------------------------
    def _should_retire(self, state: _SlotState, tok: int) -> bool:
        if (self.serve_cfg.eos_id is not None
                and tok == self.serve_cfg.eos_id):
            return True
        if len(state.generated) >= state.request.max_new_tokens:
            return True
        # feeding the next token writes at position p + generated - 1,
        # which must stay inside the context window
        return state.prompt_len + len(state.generated) > self.max_context

    def _retire(self, slot: int) -> None:
        """Fold the request's latencies into the histograms and drop every
        per-request entry: with ``retain_streams=False`` the engine's state
        stays O(slots + backlog) (:meth:`per_request_state_count`)."""
        state = self._slots[slot]
        self._completed += 1
        now = self._now_ms()
        n_gen = len(state.generated)
        self.hists["ttft_ms"].add([state.ttft_ms])
        self.hists["queue_ms"].add([state.queue_ms])
        self.hists["e2e_ms"].add([now - state.t_submit_ms])
        if n_gen > 1:
            self.hists["tpot_ms"].add([(now - state.t_first_ms) / (n_gen - 1)])
        if self._retain_streams:
            self._finished[state.request.uid] = state.generated
        if self._on_retire is not None:
            self._on_retire(state.request.uid, state.generated)
        # cached blocks park in the allocator's LRU: the prefix cache
        # outlives its requests
        self.allocator.free(state.blocks)
        self._slots[slot] = None
        self._active[slot] = False
        self._seq_lens[slot] = 0
        self._last_tokens[slot] = 0
        self._block_tables[slot] = 0
        self._dirty("block_tables", "seq_lens", "last_tokens", "active")

    # -- speculative drafting ----------------------------------------------
    def _collect_drafts(self) -> Optional[Dict[int, List[int]]]:
        """Up to spec_k drafts per active slot, capped so fed positions
        stay inside the slot's blocks, the context window and the
        remaining budget. None when no slot proposes (plain decode)."""
        if self.drafter is None:
            return None
        out: Dict[int, List[int]] = {}
        for i, state in enumerate(self._slots):
            if state is None or not self._active[i]:
                continue
            s = int(self._seq_lens[i])
            remaining = state.request.max_new_tokens - len(state.generated)
            cap = min(self.serve_cfg.spec_k,
                      remaining - 1,  # the last token is never fed back
                      len(state.blocks) * self.kv_cfg.block_size - 1 - s,
                      self.max_context - 1 - s)
            if cap < 1:
                continue
            drafts = list(self.drafter.propose(state.history, cap))[:cap]
            if drafts:
                out[i] = [int(t) for t in drafts]
        return out or None

    # -- stepping ----------------------------------------------------------
    def _decode(self) -> torch.Tensor:
        step = gpt_decode_step_fused if self._megakernel else gpt_decode_step
        self.cache, logits = step(
            self.params, self._dev("last_tokens"), self._dev("seq_lens"),
            self._dev("active"), self.cache, self._dev("block_tables"),
            self.cfg, self.kv_cfg)
        return sample(logits, self._dev("keys"),
                      self._dev("seq_lens").long() + 1,
                      self.serve_cfg.sampling)

    def _verify(self, drafts: Dict[int, List[int]]) -> torch.Tensor:
        k1 = self.serve_cfg.spec_k + 1
        fed = np.zeros((self.serve_cfg.num_slots, k1), np.int32)
        fed[:, 0] = self._last_tokens
        n_fed = np.where(self._active, 1, 0).astype(np.int32)
        for i, d in drafts.items():
            fed[i, 1:1 + len(d)] = d
            n_fed[i] = 1 + len(d)
        seq_lens = self._dev("seq_lens")
        step = gpt_verify_step_fused if self._megakernel else gpt_verify_step
        self.cache, logits = step(
            self.params, self._upload(fed), seq_lens, self._upload(n_fed),
            self._dev("active"), self.cache, self._dev("block_tables"),
            self.cfg, self.kv_cfg)
        offs = torch.arange(k1, device=self.device)
        draw_pos = seq_lens.long()[:, None] + 1 + offs[None, :]
        return sample(logits, self._dev("keys"), draw_pos,
                      self.serve_cfg.sampling)

    def step(self) -> bool:
        """Admit what fits, run one prefill chunk if a prompt is mid-
        prefill, then advance every decoding slot — one token via the
        decode program, or up to spec_k+1 via the verify program when the
        drafter proposed. Returns False when nothing happened."""
        admitted = self._try_admit()
        chunked = self._run_prefill_chunk()
        if not self._active.any():
            if chunked:
                self._step_idx += 1
            return admitted > 0 or chunked
        t0 = time.perf_counter()
        drafts = self._collect_drafts()
        if drafts is None:
            self._decode_steps += 1
            toks = self._decode()
        else:
            self._verify_steps += 1
            toks = self._verify(drafts)
        toks = toks.cpu().numpy()  # fence — the iteration-level sync
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.hists["decode_step_ms"].add([dt_ms])
        if drafts is not None:
            # a verify step is one engine iteration too: it also lands in
            # decode_step_ms, as in JAX
            self.hists["verify_step_ms"].add([dt_ms])
        for i in range(len(self._slots)):
            if not self._active[i]:
                continue
            state = self._slots[i]
            if drafts is None:
                emitted = [int(toks[i])]
            else:
                d = drafts.get(i, [])
                self._spec_proposed += len(d)
                a = 1
                while a <= len(d) and int(toks[i, a - 1]) == d[a - 1]:
                    a += 1
                emitted = [int(toks[i, j]) for j in range(a)]
                self._spec_accepted += a - 1
            retired = False
            n_emit = 0
            for tok in emitted:
                state.generated.append(tok)
                state.history.append(tok)
                self._tokens_generated += 1
                n_emit += 1
                if self._should_retire(state, tok):
                    retired = True
                    break
            self._seq_lens[i] += n_emit
            self._last_tokens[i] = state.generated[-1]
            if retired:
                self._retire(i)
        self._dirty("seq_lens", "last_tokens")
        self._step_idx += 1
        return True

    # -- driving -----------------------------------------------------------
    def run(self, requests: Sequence[Request],
            max_steps: Optional[int] = None) -> Dict[str, List[int]]:
        """Serve ``requests`` to completion; returns uid -> generated
        tokens."""
        for r in requests:
            self.submit(r)
        steps = 0
        while self.active:
            if max_steps is not None and steps >= max_steps:
                break
            if not self.step():
                request = self._pending[0][0]
                needed = self.kv_cfg.blocks_for_tokens(
                    self._total_tokens(request))
                if self._on_reject is not None:
                    self._pending.popleft()
                    self._rejected += 1
                    self._on_reject(request, {
                        "reason": "pool_exhausted",
                        "needed_blocks": needed,
                        "free_blocks": self.allocator.free_count,
                        "pool_blocks": self.kv_cfg.num_blocks,
                    })
                    continue
                raise RuntimeError(
                    f"engine stalled: next request needs {needed} blocks, "
                    f"pool has {self.allocator.free_count} free and no "
                    f"active slot will release more — the pool is too "
                    f"small for this request")
            steps += 1
        return dict(self._finished)

    # -- introspection -----------------------------------------------------
    @property
    def active(self) -> bool:
        """Whether the engine still has work: a slot mid-generation or
        mid-prefill, or a queued submission."""
        return (bool(self._active.any()) or bool(self._pending)
                or bool(self._prefill_queue))

    def occupancy(self) -> float:
        """Occupied slots (decoding or mid-prefill) / total slots."""
        return (sum(s is not None for s in self._slots)
                / self.serve_cfg.num_slots)

    def throughput(self) -> Optional[float]:
        """Generated tokens per second since the first token."""
        if self._t_start is None:
            return None
        dt = time.perf_counter() - self._t_start
        return self._tokens_generated / dt if dt > 0 else None

    def per_request_state_count(self) -> int:
        """Per-request entries the engine is holding: retained streams +
        queued submissions + occupied slots. With ``retain_streams=False``
        this is O(slots + backlog) however many requests went through."""
        return (len(self._finished) + len(self._pending)
                + sum(s is not None for s in self._slots))

    def stats(self) -> Dict[str, Any]:
        """One JSON-serializable snapshot: counts, tokens/s, latency
        quantiles (``<name>_p50`` / ``_p99`` of each dimension recorded so
        far, from the streaming histograms: bounded relative error, O(1)
        memory, rounded to 3 decimals as JAX's ``stats()``), and the
        prefix-cache, prefill and speculation counters."""
        out: Dict[str, Any] = {
            "completed": self._completed,
            "rejected": self._rejected,
            "steps": self._step_idx,
            "generated_tokens": self._tokens_generated,
            "queue_depth": len(self._pending),
            "occupancy": self.occupancy(),
            "device": str(self.device),
            "megakernel": self._megakernel,
            "decode_kernel": self.decode_kernel,
            "verify_kernel": self.verify_kernel,
            "kv_bits": (self.kv_cfg.bits if self.kv_cfg.quantized else
                        8 * torch.empty((), dtype=self.kv_cfg.dtype)
                        .element_size()),
            "kv_cache_bytes": kv_cache_bytes(self.kv_cfg),
            "contexts_max": self.kv_cfg.tokens_capacity // self.max_context,
        }
        out["tokens_per_s"] = self.throughput()
        for name in _HIST_NAMES:
            h = self.hists[name]
            if h.total:
                out[f"{name}_p50"] = round(h.quantile(0.5), 3)
                out[f"{name}_p99"] = round(h.quantile(0.99), 3)
        out["prefix_cache"] = {
            "enabled": self.serve_cfg.prefix_cache,
            "blocks_hit": self._prefix_blocks_hit,
            "blocks_needed": self._prefix_blocks_needed,
            "hit_rate": (self._prefix_blocks_hit / self._prefix_blocks_needed
                         if self._prefix_blocks_needed else None),
            "tokens_saved": self._prefill_tokens_saved,
            "cow_copies": self._cow_copies,
            "cached_blocks": self.allocator.cached_count,
            "evictions": self.allocator.blocks_evicted_total,
        }
        out["prefill"] = {
            "chunk": self.serve_cfg.prefill_chunk,
            "chunks_run": self._chunks_run,
            "backlog_tokens": self._prefill_backlog_tokens(),
        }
        out["speculative"] = {
            "k": self.serve_cfg.spec_k,
            "proposed": self._spec_proposed,
            "accepted": self._spec_accepted,
            "acceptance_rate": (self._spec_accepted / self._spec_proposed
                                if self._spec_proposed else None),
            "verify_steps": self._verify_steps,
            "decode_steps": self._decode_steps,
        }
        return out
