"""Iteration-level continuous-batching inference engine (counterpart of
``apex_tpu/serve/engine.py``): one device, or one rank of a tensor-parallel
group (``tp_axis``).

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

Per-tenant LoRA (``ServeConfig.lora_rank`` / ``max_adapters``): the
adapter pool (``serve.adapters``) lives on the engine's device and rides
the per-op decode, verify and prefill calls; :meth:`InferenceEngine.
load_adapter` writes into it in place, and each request's ``adapter``
binds it to a pool slot (slot 0, the base model, adds an exact zero).
Adapter traffic takes the per-op path (the fused layer has no adapter
inputs), as in JAX.

Telemetry, JAX's ``monitor`` wiring, each piece off (``None``) unless
given: ``sink`` (one ``JsonlSink`` record per step), ``events`` (an
``EventLog`` of every request's lifecycle; its clock becomes the engine's),
``slo`` (an ``SloSpec``, tracked over the engine's own histograms), and
``meter`` (a ``Meter`` charged once per request at retirement). The step
records take ``active_slots`` / ``context_tokens`` from the host copies of
the slot state, so telemetry adds no device read to a step; with every
piece off a step does no telemetry work beyond the latency histograms it
always keeps. Spans (``monitor.trace``) mark the ``prefill``, ``decode``
and ``verify`` calls. :meth:`InferenceEngine.evict_slot` /
:meth:`~InferenceEngine.restore_slot` move a decoding request out of and
back into the grid, and :meth:`~InferenceEngine.collect_registry` /
:meth:`~InferenceEngine.scrape` expose the engine to a
``MetricsRegistry``.

Tensor parallelism (``tp_axis`` / ``tp_size``): JAX wraps the engine's
programs in ``shard_map`` (its ``transform=``), which has no torch
counterpart. The port runs one engine per rank of the model-parallel mesh
(``transformer.parallel_state``): each holds its Megatron shards of the
params (``gpt_param_specs``) and pools of ``num_heads / tp_size`` local
heads, runs the host scheduler on the same requests, and the programs'
collectives meet over ``tp_axis``. Every host decision is a function of
the requests and the sampled tokens (the logits are all-gathered, the
draws keyed by request and position), so the ranks stay in step.
``ServeConfig.plan`` is validated as JAX's; ``serve.sharded.build_engine``
builds the engine it names. Outside this slice: ``from_checkpoint``.
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
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.monitor.events import EventLog
from apex_tpu_torch.monitor.hist import (DEFAULT_LATENCY_SPEC, HistSpec,
                                         Histogram)
from apex_tpu_torch.monitor.meter import Meter, modeled_request_flops
from apex_tpu_torch.monitor.metrics import Metrics
from apex_tpu_torch.monitor.slo import SloSpec, SloTracker
from apex_tpu_torch.monitor.trace import span
from apex_tpu_torch.serve.adapters import (AdapterRegistry,
                                           adapter_pool_bytes,
                                           init_adapter_pool, write_adapter)
from apex_tpu_torch.serve.decode import (
    ensure_dense_ffn,
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
    kv_read_bytes,
    kv_write_bytes_per_token,
    prefix_block_hashes,
)
from apex_tpu_torch.serve.sampling import SamplingConfig, request_key, sample


@dataclasses.dataclass
class Request:
    """One generation request. ``seed`` feeds the request's sampling key
    (default: crc32 of the uid — stable across runs and admission orders);
    irrelevant under greedy decoding. ``tenant`` names the paying party
    (the meter charges it). ``adapter`` names the tenant's LoRA adapter
    (None: the base model); admission binds it to a resident pool slot,
    and an unknown name is shed through ``on_reject`` (or raises), never
    served on the wrong weights."""

    uid: str
    tokens: Sequence[int]
    max_new_tokens: int = 64
    seed: Optional[int] = None
    tenant: str = "default"
    adapter: Optional[str] = None

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
    (``kv_group``: int4 scale-group length). ``lora_rank`` /
    ``max_adapters``: per-tenant LoRA (0 disables; both or neither).
    ``plan``: a ``parallel.ParallelismPlan`` whose one sharding term (tp,
    pp or fsdp) picks the residency ``serve.sharded.build_engine`` builds;
    validated inference-legal here (JAX's checks)."""

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
        if self.lora_rank < 0:
            raise ValueError("lora_rank must be >= 0")
        if self.max_adapters < 0:
            raise ValueError("max_adapters must be >= 0")
        if self.lora_rank > 0 and self.max_adapters < 1:
            raise ValueError("lora_rank > 0 needs max_adapters >= 1")
        if self.max_adapters > 0 and self.lora_rank == 0:
            raise ValueError("max_adapters > 0 needs lora_rank > 0")
        if self.plan is not None:
            if not hasattr(self.plan, "serve_overrides"):
                raise ValueError(
                    f"plan must be a ParallelismPlan "
                    f"(apex_tpu_torch.parallel.plan), got {type(self.plan)!r}")
            # the inference-legality checks run here: a plan that only
            # makes sense feeding an optimizer is refused before any build
            self.plan.serve_overrides()
            if self.lora_rank > 0:
                raise NotImplementedError(
                    "paged LoRA adapters are single-device for now — the "
                    "AdapterPool is not plan-sharded (lora_rank needs "
                    "plan=None)")
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
    chunk_start_ms: float = 0.0  # start of the decode chunk being counted
    chunk_done: int = 0          # tokens already covered by emitted chunks
    adapter_id: int = 0          # the adapter pool slot this request uses


# the engine's latency dimensions (JAX's ``_HIST_NAMES``); each gets a
# streaming Histogram, so the records stay O(1) however long the run
_HIST_NAMES = ("ttft_ms", "tpot_ms", "queue_ms", "e2e_ms",
               "decode_step_ms", "verify_step_ms")

# host arrays with cached device copies (uploaded only when changed)
_MIRROR_NAMES = ("block_tables", "seq_lens", "last_tokens", "active", "keys",
                 "adapter_ids")


class InferenceEngine:
    """Continuous-batching engine over one parameter dict (the layout of
    ``transformer.testing.init_gpt_params`` / ``convert.params_from_numpy``).

    ``device``: where the params, pools and programs live (default
    ``cuda``; raises without CUDA unless ``device="cpu"``). The params must
    already be there. ``base_seed`` keys sampled draws. ``drafter``: the
    speculative proposer (default with ``spec_k > 0``: ``NGramDrafter``).
    ``on_reject(request, info)``: when given, a request the pool can never
    fit (or whose adapter is not resident) is handed back instead of
    raising. ``retain_streams=False`` hands each finished stream to
    ``on_retire(uid, tokens)`` instead of keeping it.

    ``use_pallas``: ``None`` runs the kernels on a CUDA engine and their
    plain versions on the CPU; ``False`` asks for the plain versions on
    every device (``decode_kernel == "plain"``, or ``"fused"`` with
    ``megakernel="on"``, the fused layer's plain version); ``True`` asks for
    the kernels and raises on a CPU engine. ``gather_layer``: JAX's
    per-layer parameter hook (see ``decode.paged_layer_stack``); it and
    ``lora_rank > 0`` take the per-op path.

    ``tp_axis`` / ``tp_size``: this engine is one rank of a tensor-parallel
    group over that mesh axis (both or neither; see the module docstring):
    ``params`` are this rank's shards, the pools hold ``num_heads /
    tp_size`` local heads, decode and verify take the per-op path, and
    LoRA is refused. ``plan_stats``: a zero-argument callable whose fields
    :meth:`stats` merges (``serve.sharded`` sets it).

    Telemetry (JAX's arguments, each off when ``None``): ``sink`` a
    ``monitor.JsonlSink`` receiving one record per step (``decode_mfu``
    when ``peak_flops_per_s``, the card's peak, is given); ``events`` a
    ``monitor.EventLog``; ``slo`` a ``monitor.SloSpec``; ``hist_spec`` the
    latency buckets; ``chunk_tokens`` the ``decode_chunk`` event span;
    ``meter`` a ``monitor.Meter`` charged as ``meter_worker``.
    """

    def __init__(self, params, cfg, serve_cfg: Optional[ServeConfig] = None,
                 *, device: DeviceLike = None, base_seed: int = 0,
                 sink=None, peak_flops_per_s: Optional[float] = None,
                 use_pallas: Optional[bool] = None,
                 events: Optional[EventLog] = None,
                 slo: Optional[SloSpec] = None,
                 hist_spec: Optional[HistSpec] = None,
                 retain_streams: bool = True,
                 on_retire: Optional[Callable[[str, List[int]],
                                              None]] = None,
                 chunk_tokens: int = 16,
                 drafter: Optional[Drafter] = None,
                 gather_layer: Optional[Callable] = None,
                 on_reject: Optional[Callable[[Request, Dict[str, Any]],
                                              None]] = None,
                 meter: Optional[Meter] = None,
                 meter_worker: str = "engine",
                 tp_axis: Optional[str] = None,
                 tp_size: int = 1):
        scfg = serve_cfg or ServeConfig()
        scfg.validate()
        ensure_dense_ffn(cfg.num_experts)
        cfg.validate()
        if (tp_axis is None) != (tp_size == 1):
            raise ValueError("pass tp_axis together with tp_size > 1 "
                             "(and a shard_map transform)")
        if cfg.num_heads % tp_size:
            raise ValueError(f"num_heads ({cfg.num_heads}) not divisible "
                             f"by tp_size ({tp_size})")
        self.device = resolve_device(device)
        if use_pallas and self.device.type != "cuda":
            raise ValueError(
                f"use_pallas=True asks for the CUDA kernels, but the engine "
                f"is on {self.device} (the kernels have no interpret mode): "
                f"leave it None or pass False for the plain versions")
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
        self._tp_axis = tp_axis
        self.kv_cfg = KVCacheConfig(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads // tp_size,
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
        # per-tenant LoRA: the pool on the device + the host registry
        # (None/None when disabled: the calls then take no adapter inputs)
        self._lora_pool: Optional[Dict[str, torch.Tensor]] = None
        self.adapters: Optional[AdapterRegistry] = None
        self._adapter_load_ms_total = 0.0
        # name -> times loaded (the prefix-cache salt's generation)
        self._adapter_loads: Dict[str, int] = {}
        if scfg.lora_rank > 0:
            if tp_axis is not None:
                raise NotImplementedError(
                    "paged LoRA adapters are single-device for now — the "
                    "AdapterPool is not TP-sharded (lora_rank needs "
                    "tp_axis=None)")
            self._lora_pool = init_adapter_pool(
                cfg, scfg.lora_rank, scfg.max_adapters, device=self.device)
            self.adapters = AdapterRegistry(scfg.max_adapters)
        n = scfg.num_slots
        self._block_tables = np.zeros((n, self._blocks_per_slot), np.int32)
        self._seq_lens = np.zeros((n,), np.int32)
        self._last_tokens = np.zeros((n,), np.int32)
        self._active = np.zeros((n,), bool)
        self._keys = np.zeros((n,), np.int64)
        self._adapter_ids = np.zeros((n,), np.int32)
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
        self._sink = sink
        self._peak = peak_flops_per_s
        # one clock: the EventLog's when given, so event stamps and the
        # latencies folded into the histograms agree
        self._events = events
        self._t_anchor = time.perf_counter()
        if chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self._chunk_tokens = int(chunk_tokens)
        self._t_start: Optional[float] = None
        self._step_idx = 0
        self._tokens_generated = 0
        self._rejected = 0
        self._completed = 0
        hspec = hist_spec or DEFAULT_LATENCY_SPEC
        self.hists: Dict[str, Histogram] = {
            name: Histogram(hspec) for name in _HIST_NAMES}
        # the engine-local latency attribution: queue + prefill + decode
        # partition each request's end-to-end time
        self._attrib_hists: Dict[str, Histogram] = {
            c: Histogram(hspec) for c in ("queue", "prefill", "decode")}
        self._attrib_n = 0
        self._meter = meter
        self._meter_worker = meter_worker
        # the tracker shares the engine's histograms: one fold per
        # retirement feeds both the stats() quantiles and the slo_report
        self._slo = (SloTracker(slo, hists={
            d: self.hists[d]
            for d in ("ttft_ms", "tpot_ms", "queue_ms", "e2e_ms")})
            if slo is not None else None)
        self._prefix_blocks_hit = 0
        self._prefix_blocks_needed = 0
        self._prefill_tokens_saved = 0
        self._prefill_flops_saved = 0.0
        self._cow_copies = 0
        self._chunks_run = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._verify_steps = 0
        self._decode_steps = 0
        self._n_params = sum(t.numel() for _, t in named_leaves(params))
        # the plan-sharded engines' stats hook (serve.sharded): the fields
        # stats() merges; None on the plain engine
        self.plan_stats: Optional[Callable[[], Dict[str, Any]]] = None
        self._gather_layer = gather_layer
        self._use_pallas = use_pallas
        self._megakernel = self._resolve_megakernel()

    @property
    def _kernels(self) -> bool:
        """Whether the engine's calls launch the kernels (a CUDA engine
        not asked for the plain versions)."""
        return self.device.type == "cuda" and self._use_pallas is not False

    def _resolve_megakernel(self) -> bool:
        """``ServeConfig.megakernel`` -> whether the decode AND verify calls
        run the fused layer, gated on the verify call's spec_k + 1 rows per
        slot so speculation never flips the choice. ``gather_layer`` and
        LoRA adapters take the per-op path with JAX's reasons, as does a
        tensor-parallel engine. ``auto``
        needs the kernel itself (a CUDA engine with the kernels on): there
        it falls back to the per-op path only with a reason, logged once;
        elsewhere it means per-op. ``on`` raises with the reason on an
        unsupported configuration."""
        mode = self.serve_cfg.megakernel
        if mode == "off":
            return False
        if self._tp_axis is not None:
            reason = "TP-sharded programs ride the per-op layer body"
        elif self._gather_layer is not None:
            reason = ("plan-sharded (FSDP weight-resident) params ride "
                      "the per-op layer body")
        elif self.serve_cfg.lora_rank > 0:
            reason = ("per-slot LoRA adapters (lora_rank > 0) ride the "
                      "per-op layer body")
        elif mode == "auto" and not self._kernels:
            return False
        else:
            reason = megakernel_refusal(
                self.cfg, self.kv_cfg, allow_interpret=not self._kernels,
                q=self.serve_cfg.spec_k + 1, slots=self.serve_cfg.num_slots)
        if mode == "on":
            if reason is not None:
                raise ValueError(
                    f"megakernel='on' but the fused decode layer does not "
                    f"support this configuration: {reason} — use "
                    f"megakernel='off'/'auto'")
            return True
        if reason is not None:
            if self._kernels:
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
        megakernel, or its plain version), else the per-op path's ``cuda``
        (the paged-attention and LayerNorm kernels) or ``plain`` (their
        PyTorch versions: a CPU engine, or ``use_pallas=False``)."""
        if self._megakernel:
            return "fused"
        return "cuda" if self._kernels else "plain"

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
        if request.adapter is not None and self.adapters is None:
            raise ValueError(
                f"{request.uid}: adapter {request.adapter!r} requested "
                f"but adapters are disabled (ServeConfig.lora_rank == 0)")
        t = self._now_ms()
        self._pending.append((request, t))
        if self._events is not None:
            self._events.emit("submitted", request.uid, t_ms=t,
                              prompt_tokens=p,
                              max_new_tokens=request.max_new_tokens)
            self._events.gauge("queue_depth", len(self._pending), t_ms=t)

    def _now_ms(self) -> float:
        """Ms on the engine's one monotonic clock (the EventLog's when
        events are wired, so both share timestamps)."""
        if self._events is not None:
            return self._events.now_ms()
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

    def _prefix_salt(self, request: Request):
        """The prefix-cache chain salt of a request: none for the base
        model; for an adapter, its name and load generation, so cached
        blocks are shared only between requests whose K/V came from the
        same weights (a reload under the same name starts a new chain).
        JAX's engine hashes tokens alone, and so lets a base request hit
        blocks an adapter wrote."""
        if request.adapter is None:
            return None
        return (request.adapter, self._adapter_loads.get(request.adapter, 0))

    def _resolve_adapter(self, request: Request) -> Optional[int]:
        """Bind the head request to its adapter's pool slot (a ref, given
        back at retirement or eviction). None: the request was shed (not
        resident, ``on_reject`` wired) and popped. Without a hook an
        unknown adapter raises."""
        if request.adapter is None:
            return 0
        aid = self.adapters.acquire(request.adapter)
        if aid is not None:
            return aid
        self._pending.popleft()
        self._rejected += 1
        info = {"reason": "unknown_adapter", "adapter": request.adapter,
                "resident": sorted(self.adapters.resident())}
        if self._on_reject is not None:
            self._on_reject(request, info)
            if self._events is not None:
                self._events.emit("shed", request.uid,
                                  reason="unknown_adapter",
                                  adapter=request.adapter)
            return None
        raise KeyError(
            f"{request.uid}: unknown adapter {request.adapter!r} "
            f"(resident: {info['resident']}) — load_adapter() it first "
            f"or wire on_reject to shed")

    def _try_admit(self) -> int:
        admitted = 0
        while self._pending:
            slot = self._free_slot()
            if slot is None:
                break
            request, t_submit = self._pending[0]
            aid = self._resolve_adapter(request)
            if aid is None:
                continue  # shed: head popped, try the next request
            n_blocks = self.kv_cfg.blocks_for_tokens(
                self._total_tokens(request))
            bs = self.kv_cfg.block_size
            hashes = (prefix_block_hashes(request.tokens, bs,
                                          self._prefix_salt(request))
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
                if aid and request.adapter is not None:
                    # drop the adapter pin too: re-acquired on retry
                    self.adapters.release(request.adapter)
                break  # pool full: wait for a retirement
            self._pending.popleft()
            self._admit(slot, request, hit, fresh, cow, hashes, t_submit,
                        aid)
            admitted += 1
        return admitted

    def _admit(self, slot: int, request: Request, hit: List[int],
               fresh: List[int], cow: bool, hashes: List[int],
               t_submit_ms: float, adapter_id: int = 0) -> None:
        p = len(request.tokens)
        bs = self.kv_cfg.block_size
        n_hit = len(hit)
        if cow:
            # fresh[0] replaces the last matched block: copy the shared
            # content on device, drop OUR ref on the source
            src, dst = hit[-1], fresh[0]
            self._copy_block(src, dst)
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
        # modeled flops the cache saved: decode_flops_per_token summed over
        # the skipped positions
        self._prefill_flops_saved += (
            2.0 * self._n_params * cached
            + 4.0 * self.cfg.num_layers * self.cfg.hidden
            * (cached * (cached + 1)) / 2.0)
        t_adm = self._now_ms()
        queue_ms = t_adm - t_submit_ms
        if self._events is not None:
            self._events.emit("admitted", request.uid, t_ms=t_adm,
                              slot=slot, queue_ms=round(queue_ms, 3),
                              cached_tokens=cached)
            self._events.emit("prefill_start", request.uid, t_ms=t_adm,
                              slot=slot, prompt_tokens=p,
                              chunk=self.serve_cfg.prefill_chunk)
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
            queue_ms=queue_ms, adapter_id=adapter_id)
        self._block_tables[slot] = row
        self._keys[slot] = request_key(self._base_seed,
                                       request.sampling_seed())
        self._dirty("block_tables", "keys")
        if self._adapter_ids[slot] != adapter_id:
            self._adapter_ids[slot] = adapter_id
            self._dirty("adapter_ids")
        self._prefill_queue.append(slot)

    # -- chunked prefill ---------------------------------------------------
    def _prefill_backlog_tokens(self) -> int:
        return sum(s.prompt_len - s.prefill_pos for s in self._slots
                   if s is not None and s.prefill_pos < s.prompt_len)

    def _lora_kw(self, slot: Optional[int] = None) -> Dict[str, Any]:
        """The adapter keywords of a per-op call: none without adapters;
        the pool and the slots' (or one slot's) pool ids with them."""
        if self._lora_pool is None:
            return {}
        ids = self._dev("adapter_ids")
        if slot is None:
            return {"adapters": self._lora_pool, "adapter_ids": ids}
        return {"adapters": self._lora_pool,
                "adapter_id": ids[slot:slot + 1]}

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
        with span("prefill"):
            logits = self._prefill_logits(slot, self._upload(tokens), c,
                                          n_valid)
            state.prefill_pos = c + n_valid
            self._chunks_run += 1
            done = state.prefill_pos >= p
            if done:
                pos = torch.full((1,), p, dtype=torch.int64,
                                 device=self.device)
                tok = sample(logits[None], self._dev("keys")[slot:slot + 1],
                             pos, self.serve_cfg.sampling)
                first = int(tok[0])  # fence: TTFT includes the round trip
        while (state.pending_commits
               and state.pending_commits[0][2] <= state.prefill_pos):
            b, h, _ = state.pending_commits.pop(0)
            self.allocator.commit(b, h)
        if not done:
            return True
        self._prefill_queue.popleft()
        t_first = self._now_ms()
        ttft_ms = t_first - state.t_submit_ms
        if self._events is not None:
            self._events.emit("prefill_end", state.request.uid,
                              t_ms=t_first, slot=slot)
            self._events.emit("first_token", state.request.uid,
                              t_ms=t_first, slot=slot,
                              ttft_ms=round(ttft_ms, 3))
        if self._t_start is None:
            self._t_start = time.perf_counter()
        self._tokens_generated += 1
        state.generated.append(first)
        state.history.append(first)
        state.t_first_ms = t_first
        state.ttft_ms = ttft_ms
        state.chunk_start_ms = t_first
        state.chunk_done = 1
        self._seq_lens[slot] = p
        self._last_tokens[slot] = first
        self._active[slot] = True
        self._dirty("seq_lens", "last_tokens", "active")
        if self._events is not None:
            self._events.gauge("occupancy", self.occupancy(), t_ms=t_first)
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
        """Fold the request's latencies into the histograms (and the SLO
        tracker), charge the meter once, and drop every per-request entry:
        with ``retain_streams=False`` the engine's state stays O(slots +
        backlog) (:meth:`per_request_state_count`)."""
        state = self._slots[slot]
        uid = state.request.uid
        now = self._now_ms()
        n_gen = len(state.generated)
        e2e_ms = now - state.t_submit_ms
        tpot_ms = ((now - state.t_first_ms) / (n_gen - 1)
                   if n_gen > 1 else None)
        if self._slo is not None:
            # the tracker folds into the same shared histograms
            self._slo.observe(ttft_ms=state.ttft_ms, tpot_ms=tpot_ms,
                              queue_ms=state.queue_ms, e2e_ms=e2e_ms)
        else:
            self.hists["ttft_ms"].add([state.ttft_ms])
            self.hists["queue_ms"].add([state.queue_ms])
            self.hists["e2e_ms"].add([e2e_ms])
            if tpot_ms is not None:
                self.hists["tpot_ms"].add([tpot_ms])
        if self._events is not None:
            if n_gen > state.chunk_done:  # the final partial decode chunk
                self._events.emit(
                    "decode_chunk", uid, t_ms=now, slot=slot,
                    start_ms=round(state.chunk_start_ms, 3),
                    n_tokens=n_gen - state.chunk_done)
            self._events.emit(
                "retired", uid, t_ms=now, slot=slot, n_tokens=n_gen,
                ttft_ms=round(state.ttft_ms, 3), e2e_ms=round(e2e_ms, 3),
                tpot_ms=(round(tpot_ms, 3) if tpot_ms is not None
                         else None))
        self._attrib_hists["queue"].add([max(0.0, state.queue_ms)])
        self._attrib_hists["prefill"].add(
            [max(0.0, state.ttft_ms - state.queue_ms)])
        self._attrib_hists["decode"].add([max(0.0, e2e_ms - state.ttft_ms)])
        self._attrib_n += 1
        if self._meter is not None:
            # charged once, at retirement: an evicted request is charged by
            # whichever engine retires it
            held_s = max(0.0, now - (state.t_submit_ms
                                     + state.queue_ms)) / 1e3
            usage = {
                "flops": modeled_request_flops(
                    self._n_params, self.cfg.num_layers, self.cfg.hidden,
                    state.prompt_len, n_gen, state.cached_tokens),
                "kv_block_s": len(state.blocks) * held_s,
            }
            if state.adapter_id and state.request.adapter is not None:
                usage["adapter_s"] = held_s
            self._meter.charge(state.request.tenant,
                               worker=self._meter_worker, t_ms=now,
                               tokens=n_gen, requests=1, **usage)
        self._completed += 1
        if self._retain_streams:
            self._finished[uid] = state.generated
        if self._on_retire is not None:
            self._on_retire(uid, state.generated)
        # cached blocks park in the allocator's LRU: the prefix cache
        # outlives its requests
        self.allocator.free(state.blocks)
        if state.adapter_id and state.request.adapter is not None:
            self.adapters.release(state.request.adapter)
        self._release_slot(slot, now)

    def _release_slot(self, slot: int, now: float) -> None:
        """Clear one slot's grid state (the shared tail of retirement and
        eviction; the caller owns the blocks)."""
        self._slots[slot] = None
        self._active[slot] = False
        self._seq_lens[slot] = 0
        self._last_tokens[slot] = 0
        self._block_tables[slot] = 0
        self._dirty("block_tables", "seq_lens", "last_tokens", "active")
        if self._adapter_ids[slot]:
            self._adapter_ids[slot] = 0
            self._dirty("adapter_ids")
        if self._events is not None:
            self._events.gauge("occupancy", self.occupancy(), t_ms=now)

    # -- live-slot eviction ------------------------------------------------
    def evict_slot(self, uid: str) -> Dict[str, Any]:
        """Take a decoding request out of the grid and free its slot; the
        request is neither retired nor forgotten. The record holds all the
        decode call reads (the written length ``seq_len``, the next token
        ``last_token``, the request, whose seed gives the sampling key, and
        the block ids holding its K/V) plus its adapter's name, so
        :meth:`restore_slot` resumes the stream bit for bit. The record
        owns its blocks: they stay allocated until the request is restored
        or the caller frees them (``engine.allocator.free(record
        ["blocks"])``). Only a fully prefilled slot can be evicted."""
        for slot, state in enumerate(self._slots):
            if state is not None and state.request.uid == uid:
                break
        else:
            raise KeyError(f"no occupied slot holds request {uid!r}")
        if state.prefill_pos < state.prompt_len or not self._active[slot]:
            raise RuntimeError(
                f"{uid}: slot is mid-prefill — only decoding slots are "
                f"evictable (re-enqueue the request instead)")
        record: Dict[str, Any] = {
            "request": state.request,
            "blocks": list(state.blocks),
            "generated": list(state.generated),
            "history": list(state.history),
            "prompt_len": state.prompt_len,
            "cached_tokens": state.cached_tokens,
            "seq_len": int(self._seq_lens[slot]),
            "last_token": int(self._last_tokens[slot]),
            "t_submit_ms": state.t_submit_ms,
            "t_first_ms": state.t_first_ms,
            "queue_ms": state.queue_ms,
            "ttft_ms": state.ttft_ms,
            # the adapter binding travels by name: the restoring engine
            # resolves it against its own registry
            "adapter": state.request.adapter,
        }
        if state.adapter_id and state.request.adapter is not None:
            self.adapters.release(state.request.adapter)
        self._release_slot(slot, self._now_ms())
        return record

    def restore_slot(self, record: Dict[str, Any],
                     blocks: Optional[List[int]] = None) -> int:
        """Put an :meth:`evict_slot` record back into a free slot.
        ``blocks=None`` reuses the record's own block ids (a local evict +
        restore changes no bit of the stream); a caller that moved the
        blocks passes their new ids. Returns the slot; raises when no slot
        is free or the record's adapter is not resident."""
        slot = self._free_slot()
        if slot is None:
            raise RuntimeError(
                f"{record['request'].uid}: no free slot to restore into")
        blocks = list(record["blocks"] if blocks is None else blocks)
        now = self._now_ms()
        aname = record.get("adapter")
        aid = 0
        if aname is not None:
            if self.adapters is None:
                raise RuntimeError(
                    f"{record['request'].uid}: record is bound to adapter "
                    f"{aname!r} but this engine has adapters disabled")
            aid = self.adapters.acquire(aname)
            if aid is None:
                raise RuntimeError(
                    f"{record['request'].uid}: adapter {aname!r} is not "
                    f"resident on the restore target — load_adapter() it "
                    f"before restoring")
        self._slots[slot] = _SlotState(
            request=record["request"], blocks=blocks,
            generated=list(record["generated"]),
            history=list(record["history"]),
            prompt_len=record["prompt_len"],
            prefill_pos=record["prompt_len"],
            cached_tokens=record.get("cached_tokens", 0),
            pending_commits=[],
            t_submit_ms=record["t_submit_ms"],
            t_first_ms=record["t_first_ms"],
            queue_ms=record["queue_ms"], ttft_ms=record["ttft_ms"],
            chunk_start_ms=now, chunk_done=len(record["generated"]),
            adapter_id=aid)
        row = np.zeros((self._blocks_per_slot,), np.int32)
        row[:len(blocks)] = blocks
        self._block_tables[slot] = row
        self._keys[slot] = request_key(self._base_seed,
                                       record["request"].sampling_seed())
        self._seq_lens[slot] = record["seq_len"]
        self._last_tokens[slot] = record["last_token"]
        self._active[slot] = True
        self._dirty("block_tables", "keys", "seq_lens", "last_tokens",
                    "active")
        if self._adapter_ids[slot] != aid:
            self._adapter_ids[slot] = aid
            self._dirty("adapter_ids")
        if self._t_start is None:
            self._t_start = time.perf_counter()
        if self._events is not None:
            self._events.gauge("occupancy", self.occupancy(), t_ms=now)
        return slot

    # -- adapter lifecycle -------------------------------------------------
    def load_adapter(self, name: str, weights: Dict[str, Any], *,
                     scale: float = 1.0) -> int:
        """Install (or refresh) a named LoRA adapter: its factors are
        written into the pool on the device in place. Under pool pressure
        the registry evicts the least recently idle adapter; loading while
        every slot is pinned raises. Returns the pool slot."""
        if self.adapters is None:
            raise RuntimeError(
                "adapters are disabled (ServeConfig.lora_rank == 0) — "
                "construct the engine with lora_rank > 0 to load adapters")
        t0 = time.perf_counter()
        slot = self.adapters.load(name)
        write_adapter(self._lora_pool, slot, weights, scale=scale)
        self._adapter_loads[name] = self._adapter_loads.get(name, 0) + 1
        ms = (time.perf_counter() - t0) * 1e3
        self._adapter_load_ms_total += ms
        if self._meter is not None:
            # install time precedes any tenant binding: _fleet pays
            self._meter.charge("_fleet", worker=self._meter_worker,
                               adapter_load_ms=ms)
        if self._events is not None:
            self._events.emit("adapter_load", name, slot=slot,
                              load_ms=round(ms, 3))
        return slot

    def unload_adapter(self, name: str) -> None:
        """Drop a named idle adapter (refcount 0) from the pool. Its
        weights stay in the slot until the next load overwrites them; no
        slot's adapter id points at a free pool slot."""
        if self.adapters is None:
            raise RuntimeError("adapters are disabled")
        self.adapters.unload(name)
        if self._events is not None:
            self._events.emit("adapter_unload", name)

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

    # -- the model calls (a pipeline-staged engine overrides these) ------
    def _per_op_kw(self) -> Dict[str, Any]:
        return {"tp_axis": self._tp_axis, "use_pallas": self._use_pallas,
                "gather_layer": self._gather_layer}

    def _prefill_logits(self, slot: int, tokens: torch.Tensor, start: int,
                        n_valid: int) -> torch.Tensor:
        """One prefill chunk of ``slot``'s prompt into the pools; the
        (vocab,) fp32 logits after its last valid token."""
        self.cache, logits = gpt_prefill_chunk(
            self.params, tokens, start, n_valid, self.cache,
            self._dev("block_tables")[slot], self.cfg, self.kv_cfg,
            **self._per_op_kw(), **self._lora_kw(slot))
        return logits

    def _decode_logits(self) -> torch.Tensor:
        """One token for every slot: (n, vocab) fp32 logits."""
        args = (self.params, self._dev("last_tokens"), self._dev("seq_lens"),
                self._dev("active"), self.cache, self._dev("block_tables"),
                self.cfg, self.kv_cfg)
        if self._megakernel:
            self.cache, logits = gpt_decode_step_fused(
                *args, use_pallas=self._use_pallas)
        else:
            self.cache, logits = gpt_decode_step(
                *args, **self._per_op_kw(), **self._lora_kw())
        return logits

    def _verify_logits(self, fed: torch.Tensor,
                       n_fed: torch.Tensor) -> torch.Tensor:
        """The q = spec_k + 1 verify call: (n, q, vocab) fp32 logits."""
        args = (self.params, fed, self._dev("seq_lens"), n_fed,
                self._dev("active"), self.cache, self._dev("block_tables"),
                self.cfg, self.kv_cfg)
        if self._megakernel:
            self.cache, logits = gpt_verify_step_fused(
                *args, use_pallas=self._use_pallas)
        else:
            self.cache, logits = gpt_verify_step(
                *args, **self._per_op_kw(), **self._lora_kw())
        return logits

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write of one pool block (every layer)."""
        copy_block(self.cache, src, dst)

    # -- stepping ----------------------------------------------------------
    def _decode(self) -> torch.Tensor:
        logits = self._decode_logits()
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
        logits = self._verify_logits(self._upload(fed), self._upload(n_fed))
        offs = torch.arange(k1, device=self.device)
        draw_pos = seq_lens.long()[:, None] + 1 + offs[None, :]
        return sample(logits, self._dev("keys"), draw_pos,
                      self.serve_cfg.sampling)

    def step(self) -> bool:
        """Admit what fits, run one prefill chunk if a prompt is mid-
        prefill, then advance every decoding slot — one token via the
        decode program, or up to spec_k+1 via the verify program when the
        drafter proposed. Returns False when nothing happened; a request
        shed at admission counts as progress (the queue moved)."""
        shed0 = self._rejected
        admitted = self._try_admit()
        chunked = self._run_prefill_chunk()
        if not self._active.any():
            if self._sink is not None and chunked:
                self._sink.write(step=self._step_idx,
                                 phase="prefill_chunk",
                                 prefill_backlog_tokens=(
                                     self._prefill_backlog_tokens()))
            if chunked:
                self._step_idx += 1
            return admitted > 0 or chunked or self._rejected > shed0
        t0 = time.perf_counter()
        drafts = self._collect_drafts()
        if drafts is None:
            self._decode_steps += 1
            with span("decode"):
                toks = self._decode()
                toks = toks.cpu().numpy()  # fence — the iteration-level sync
        else:
            self._verify_steps += 1
            with span("verify"):
                toks = self._verify(drafts)
                toks = toks.cpu().numpy()
        dt = time.perf_counter() - t0
        self.hists["decode_step_ms"].add([dt * 1e3])
        if drafts is not None:
            # a verify step is one engine iteration too: it also lands in
            # decode_step_ms, as in JAX
            self.hists["verify_step_ms"].add([dt * 1e3])
        telemetry = self._sink is not None
        if telemetry:
            # the step record's inputs, read before the slots advance (JAX
            # computes active_slots / context_tokens in its decode program
            # from the same pre-step state)
            active_lens = [int(s) + 1 for s, a
                           in zip(self._seq_lens, self._active) if a]
            fed_counts = [1 + len(drafts.get(i, [])) if drafts is not None
                          else 1
                          for i in range(len(self._slots))
                          if self._active[i]]
        now_ms = self._now_ms() if self._events is not None else 0.0
        step_proposed = step_accepted = step_emitted = 0
        for i in range(len(self._slots)):
            if not self._active[i]:
                continue
            state = self._slots[i]
            if drafts is None:
                emitted = [int(toks[i])]
            else:
                d = drafts.get(i, [])
                step_proposed += len(d)
                a = 1
                while a <= len(d) and int(toks[i, a - 1]) == d[a - 1]:
                    a += 1
                emitted = [int(toks[i, j]) for j in range(a)]
                step_accepted += a - 1
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
            step_emitted += n_emit
            self._seq_lens[i] += n_emit
            self._last_tokens[i] = state.generated[-1]
            if (self._events is not None and not retired
                    and len(state.generated) - state.chunk_done
                    >= self._chunk_tokens):
                self._events.emit(
                    "decode_chunk", state.request.uid, t_ms=now_ms,
                    slot=i, start_ms=round(state.chunk_start_ms, 3),
                    n_tokens=len(state.generated) - state.chunk_done)
                state.chunk_start_ms = now_ms
                state.chunk_done = len(state.generated)
            if retired:
                self._retire(i)
        self._dirty("seq_lens", "last_tokens")
        self._spec_proposed += step_proposed
        self._spec_accepted += step_accepted
        self._step_idx += 1
        if telemetry:
            self._emit_metrics(dt, active_lens, fed_counts, step_proposed,
                               step_accepted, step_emitted)
        return True

    def _emit_metrics(self, dt: float, active_lens: List[int],
                      fed_counts: List[int], step_proposed: int,
                      step_accepted: int, step_emitted: int) -> None:
        """One sink record for a decode / verify step, JAX's fields. A
        verify step feeds (writes K/V for and gathers context per)
        1 + len(drafts) tokens a slot, so the byte and flop models count
        fed rows."""
        if self._sink is None:
            return
        flops = sum(f * decode_flops_per_token(
            self._n_params, self.cfg.num_layers, self.cfg.hidden, s)
            for s, f in zip(active_lens, fed_counts))
        fed_total = sum(fed_counts)
        read_lens = [s for s, f in zip(active_lens, fed_counts)
                     for _ in range(f)]  # one gather per fed row
        n_active = len(active_lens)
        metrics = Metrics().record(active_slots=n_active,
                                   context_tokens=sum(active_lens))
        rec = {
            "phase": "decode",
            "step_ms": round(dt * 1e3, 3),
            "occupancy": n_active / self.serve_cfg.num_slots,
            "tokens_per_s": round(step_emitted / dt, 3) if dt else 0.0,
            "kv_read_bytes": kv_read_bytes(self.kv_cfg, read_lens),
            "kv_write_bytes": fed_total * kv_write_bytes_per_token(
                self.kv_cfg),
            "decode_flops_modeled": flops,
            "prefill_backlog_tokens": self._prefill_backlog_tokens(),
            "spec_proposed": step_proposed,
            "spec_accepted": step_accepted,
            "prefix_blocks_hit_total": self._prefix_blocks_hit,
            "prefix_blocks_needed_total": self._prefix_blocks_needed,
            "prefill_flops_saved_total": self._prefill_flops_saved,
        }
        if self._peak:
            rec["decode_mfu"] = (flops / dt) / self._peak if dt else 0.0
        self._sink.write(step=self._step_idx, metrics=metrics, **rec)

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
                    if self._events is not None:
                        self._events.emit("shed", request.uid,
                                          reason="pool_exhausted")
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
    def finished(self) -> Dict[str, List[int]]:
        return dict(self._finished)

    @property
    def completed(self) -> int:
        """Requests retired so far (counted even when streams are not
        retained)."""
        return self._completed

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

    def kv_budget_bytes(self) -> int:
        return kv_cache_bytes(self.kv_cfg)

    def per_request_state_count(self) -> int:
        """Per-request entries the engine is holding: retained streams +
        queued submissions + occupied slots. With ``retain_streams=False``
        this is O(slots + backlog) however many requests went through."""
        return (len(self._finished) + len(self._pending)
                + sum(s is not None for s in self._slots))

    def stats(self) -> Dict[str, Any]:
        """One JSON-serializable snapshot, JAX's keys, nesting and
        roundings (plus ``device``): counts, tokens/s, latency quantiles
        (``<name>_p50`` / ``_p99`` from the streaming histograms) and the
        attribution components, the meter, the prefix-cache, prefill,
        speculation and adapter counters, the histogram dumps and, with an
        ``SloSpec``, the SLO report."""
        out: Dict[str, Any] = {
            "completed": self._completed,
            "rejected": self._rejected,
            "steps": self._step_idx,
            "generated_tokens": self._tokens_generated,
            "queue_depth": len(self._pending),
            "occupancy": self.occupancy(),
            "device": str(self.device),
        }
        tput = self.throughput()
        out["tokens_per_s"] = round(tput, 3) if tput else None
        for name in _HIST_NAMES:
            h = self.hists[name]
            if h.total:
                out[f"{name}_p50"] = round(h.quantile(0.5), 3)
                out[f"{name}_p99"] = round(h.quantile(0.99), 3)
        for c, h in self._attrib_hists.items():
            if h.total:
                out[f"{c}_component_ms_p50"] = round(h.quantile(0.5), 3)
                out[f"{c}_component_ms_p99"] = round(h.quantile(0.99), 3)
        if self._completed:
            out["attrib_coverage"] = round(
                self._attrib_n / self._completed, 4)
        if self._meter is not None:
            m = self._meter.stats(completed=self._completed)
            out["meter"] = m
            out["cost_per_token"] = m["cost_per_token"]
            out["cost_per_request"] = m["cost_per_request"]
            out["meter_coverage"] = m["meter_coverage"]
        out["prefix_cache"] = {
            "enabled": self.serve_cfg.prefix_cache,
            "blocks_hit": self._prefix_blocks_hit,
            "blocks_needed": self._prefix_blocks_needed,
            "hit_rate": round(
                self._prefix_blocks_hit / self._prefix_blocks_needed, 4)
            if self._prefix_blocks_needed else None,
            "tokens_saved": self._prefill_tokens_saved,
            "prefill_flops_saved": self._prefill_flops_saved,
            "cow_copies": self._cow_copies,
            "cached_blocks": self.allocator.cached_count,
            "evictions": self.allocator.blocks_evicted_total,
        }
        out["megakernel"] = self._megakernel
        out["decode_kernel"] = self.decode_kernel
        out["verify_kernel"] = self.verify_kernel
        out["kv_bits"] = (self.kv_cfg.bits if self.kv_cfg.quantized else
                          8 * torch.empty((), dtype=self.kv_cfg.dtype)
                          .element_size())
        out["kv_cache_bytes"] = kv_cache_bytes(self.kv_cfg)
        out["contexts_max"] = self.kv_cfg.tokens_capacity // self.max_context
        out["prefill"] = {
            "chunk": self.serve_cfg.prefill_chunk,
            "chunks_run": self._chunks_run,
            "backlog_tokens": self._prefill_backlog_tokens(),
        }
        out["speculative"] = {
            "k": self.serve_cfg.spec_k,
            "proposed": self._spec_proposed,
            "accepted": self._spec_accepted,
            "acceptance_rate": round(
                self._spec_accepted / self._spec_proposed, 4)
            if self._spec_proposed else None,
            "verify_steps": self._verify_steps,
            "decode_steps": self._decode_steps,
        }
        if self.adapters is not None:
            a = self.adapters
            lookups = a.hits_total + a.misses_total
            out["adapters"] = {
                "rank": self.serve_cfg.lora_rank,
                "max_adapters": self.serve_cfg.max_adapters,
                "resident": a.resident_count,
                "pool_bytes": adapter_pool_bytes(
                    self.cfg, self.serve_cfg.lora_rank,
                    self.serve_cfg.max_adapters),
                "hits": a.hits_total,
                "misses": a.misses_total,
                "loads": a.loads_total,
                "unloads": a.unloads_total,
                "evictions": a.evictions_total,
            }
            out["adapter_hit_rate"] = (
                round(a.hits_total / lookups, 4) if lookups else None)
            out["adapter_evictions"] = a.evictions_total
            out["adapter_load_ms"] = round(self._adapter_load_ms_total, 3)
        # flat aliases of the two headline rates
        out["prefix_hit_rate"] = out["prefix_cache"]["hit_rate"]
        out["spec_acceptance_rate"] = out["speculative"]["acceptance_rate"]
        # the plan-sharded engines' fields (serve.sharded): plan,
        # plan_world, hbm_model_bytes, hbm_chip_bytes and the strategy's own
        if self.plan_stats is not None:
            out.update(self.plan_stats())
        out["hists"] = {k: v.to_dict() for k, v in self.hists.items()}
        if self._slo is not None:
            out["slo_report"] = self._slo.report()
        return out

    # -- fleet exposition --------------------------------------------------
    def collect_registry(self, reg, worker: str = "engine",
                         t_ms: Optional[float] = None,
                         include_hists: bool = False) -> None:
        """Populate a ``monitor.MetricsRegistry`` with this engine's live
        series, labelled ``worker=``: counters cumulative at the scrape,
        gauges stamped ``t_ms``; ``include_hists`` adds the latency
        histograms."""
        if t_ms is None:
            t_ms = self._now_ms()
        L = {"worker": worker}
        reg.gauge("worker_up", 1.0, t_ms=t_ms, **L)
        reg.counter("requests_completed_total", self._completed, **L)
        reg.counter("requests_rejected_total", self._rejected, **L)
        reg.counter("tokens_generated_total", self._tokens_generated, **L)
        reg.counter("decode_steps_total",
                    self._decode_steps + self._verify_steps, **L)
        reg.gauge("occupancy", self.occupancy(), t_ms=t_ms, **L)
        reg.gauge("queue_depth", float(len(self._pending)), t_ms=t_ms, **L)
        reg.gauge("backlog_tokens", float(self._prefill_backlog_tokens()),
                  t_ms=t_ms, **L)
        if self._slo is not None:
            reg.counter("slo_good_total", self._slo.good, **L)
        if self.adapters is not None:
            reg.gauge("adapters_resident", float(
                self.adapters.resident_count), t_ms=t_ms, **L)
            reg.counter("adapter_hits_total", self.adapters.hits_total, **L)
            reg.counter("adapter_misses_total",
                        self.adapters.misses_total, **L)
            reg.counter("adapter_loads_total",
                        self.adapters.loads_total, **L)
            reg.counter("adapter_evictions_total",
                        self.adapters.evictions_total, **L)
        if include_hists:
            for name, h in self.hists.items():
                reg.set_histogram(name, h, **L)

    def scrape(self, worker: str = "engine", t_ms: Optional[float] = None,
               include_hists: bool = False) -> Dict[str, Any]:
        """One ``MetricsRegistry`` snapshot of this engine (what a
        ``FleetScraper`` target returns)."""
        from apex_tpu_torch.monitor.registry import MetricsRegistry

        reg = MetricsRegistry()
        if t_ms is None:
            t_ms = self._now_ms()
        self.collect_registry(reg, worker=worker, t_ms=t_ms,
                              include_hists=include_hists)
        return reg.snapshot(t_ms)


def decode_flops_per_token(n_params: int, num_layers: int, hidden: int,
                           context: int) -> float:
    """Modeled forward flops to decode ONE token at the given context:
    ``2N`` matmul flops plus paged attention ``4·L·hidden·context`` (JAX's
    model)."""
    return float(2 * n_params + 4 * num_layers * hidden * context)
