"""Plan-driven model-parallel serving (counterpart of
``apex_tpu/serve/sharded.py``): one ``ParallelismPlan`` from training to
serving a model that does not fit one device.

:func:`build_engine` reads ``ServeConfig.plan`` and builds an
:class:`~apex_tpu_torch.serve.engine.InferenceEngine` whose calls run one
of three residency strategies:

``tp`` (``ParallelismPlan(tp=N)``)
    Megatron weight shards. JAX wraps one engine's programs in
    ``shard_map``; the port runs one engine per rank of the plan's mesh
    (each rank calls :func:`build_engine` with the same merged params and
    the same requests), holding its ``gpt_param_specs`` shards and pools
    of ``num_heads / tp`` local heads. The q > 1 calls (chunked prefill,
    speculative verify) put their row-parallel exits on ``comm.overlap``'s
    ring when the plan sets ``overlap_comm``; q = 1 decode keeps the
    monolithic all-reduce. The logits equal the single-device ones up to
    the order of the tp sum.

``pp`` (``ParallelismPlan(pp=S)``)
    :class:`PPStagedEngine`, in one process: stage s holds layers ``[s·L/S,
    (s+1)·L/S)`` and the pools for exactly those layers (the engine's
    block ids, one host allocator), on its own device — a list of devices
    may repeat one (both stages of a one-card run sit on it). Activations
    stream between the stages; decode and verify split the slot grid into
    microbatches and tick a 1F schedule bounded by a per-stage handoff
    window, whose stalls are counted. Bitwise the plain engine's streams:
    splitting the layer loop reorders no op, and every projection and
    attention row is computed alone.

``fsdp`` (``ParallelismPlan("fsdp")``)
    Weight residency: each layer's leaves stay as this rank's flat
    block-aligned shards ((L, k) leaves in the model dtype) and each layer
    of each call gathers its full weights (``fsdp.FSDP.gather_leaf``; with
    the plan's ``weight_gather`` codec the quantize and dequantize kernels
    on the card), dropped after the layer. The embedding and head stay
    whole. Bitwise the plain engine's streams without a codec.

``fsdp.accounting.hbm_serve_bytes`` prices each strategy; ``stats()``
carries the plan's fields. JAX's ``program_hlo`` and its ``shard_map``
shim read XLA's compiled programs and have no counterpart here: the
port's ``comm.record_collectives`` / ``record_overlap`` records show
which exits ride the ring.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.optimizers._sharding import slice_leaf
from apex_tpu_torch.fsdp import accounting as _acct
from apex_tpu_torch.fsdp.core import FSDP, LeafMeta, dtype_name
from apex_tpu_torch.parallel.mesh import TP_AXIS
from apex_tpu_torch.serve.decode import (
    _embed,
    paged_layer_stack,
    serve_logits,
)
from apex_tpu_torch.serve.engine import InferenceEngine
from apex_tpu_torch.serve.kv_cache import copy_block, init_kv_cache, \
    kv_cache_bytes

Pytree = Any

__all__ = ["build_engine", "PPStagedEngine", "plan_world"]


# ---------------------------------------------------------------------------
# shared plumbing


def plan_world(plan, devices: Optional[Sequence[Any]] = None) -> int:
    """Devices (ranks) the plan's serve strategy spans: ``tp`` / ``pp``
    read their own degree; ``fsdp`` reads ``dp`` (-1: every device given,
    else every rank of the default process group)."""
    s = plan.serve_strategy()
    if s == "tp":
        return plan.tp
    if s == "pp":
        return plan.pp
    if plan.dp > 0:
        return plan.dp
    if devices is not None:
        return len(devices)
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _apply_overrides(cfg, plan):
    if not hasattr(plan, "serve_overrides"):
        raise ValueError(f"plan must be a ParallelismPlan (apex_tpu_torch."
                         f"parallel.plan), got {type(plan)!r}")
    ov = plan.serve_overrides()
    if cfg.overlap_comm != ov["overlap_comm"]:
        cfg = dataclasses.replace(cfg, overlap_comm=ov["overlap_comm"])
    return cfg, ov


def _n_params(params) -> int:
    from apex_tpu_torch.convert import named_leaves

    return sum(t.numel() for _, t in named_leaves(params))


def _plan_mesh(plan, mesh, world: int, devices):
    """The plan's mesh (``mesh`` when given): installed over the first
    ``world`` ranks of ``devices`` (default: the process group's)."""
    if mesh is not None:
        from apex_tpu_torch.parallel.mesh import set_mesh

        set_mesh(mesh)
        return mesh
    return plan.mesh(list(devices)[:world] if devices is not None else None)


# ---------------------------------------------------------------------------
# (a) tp: Megatron shards, one engine a rank


def _build_tp_engine(params, cfg, serve_cfg, plan, mesh, devices,
                     **engine_kw) -> InferenceEngine:
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        gpt_param_specs,
        shard_params,
    )

    tp = plan.tp
    _plan_mesh(plan, mesh, tp, devices)
    local = shard_params(params, gpt_param_specs(cfg))
    engine = InferenceEngine(local, cfg, serve_cfg, tp_axis=TP_AXIS,
                             tp_size=tp, **engine_kw)
    # the flops models count the model's parameters, not this shard's
    engine._n_params = _n_params(params)
    model_bytes = _acct.hbm_model_bytes(params)
    chip = _acct.hbm_serve_bytes(
        params, strategy="tp", world=tp,
        kv_bytes=kv_cache_bytes(engine.kv_cfg), num_layers=cfg.num_layers)

    def plan_stats() -> Dict[str, Any]:
        return {"plan": "tp", "plan_world": tp,
                "hbm_model_bytes": model_bytes,
                "hbm_chip_bytes": chip["total"]}

    engine.plan_stats = plan_stats
    return engine


# ---------------------------------------------------------------------------
# (c) fsdp: resident shards, gathered a layer at a time


def _layer_shard_meta(layers: Dict[str, torch.Tensor]
                      ) -> Dict[str, LeafMeta]:
    """Each stacked leaf's per-layer :class:`LeafMeta` (the shape without
    the leading L): what one layer's gather rebuilds."""
    return {k: LeafMeta(tuple(v.shape[1:]), dtype_name(v.dtype))
            for k, v in layers.items()}


def _build_fsdp_engine(params, cfg, serve_cfg, plan, mesh, devices,
                       **engine_kw) -> InferenceEngine:
    world = plan_world(plan, devices)
    _plan_mesh(plan, mesh, world, devices)
    axis = plan.dp_axis
    fsdp = FSDP(axis_name=axis, weight_gather=plan.weight_gather)
    mult = fsdp.shard_multiple
    layers = params["layers"]
    metas = _layer_shard_meta(layers)
    # resident (L, k) model-dtype rows, block-aligned so no codec block
    # straddles two ranks (without a codec, pad + slice + gather + unpad
    # is the identity)
    shards = {k: torch.stack([slice_leaf(row, axis, multiple=mult)
                              for row in v.unbind(0)])
              for k, v in layers.items()}
    serve_params = {"embed": params["embed"], "head": params["head"],
                    "layers": shards}

    def gather_layer(lp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: fsdp.gather_leaf(v, metas[k]) for k, v in lp.items()}

    engine = InferenceEngine(serve_params, cfg, serve_cfg,
                             gather_layer=gather_layer, **engine_kw)
    engine._n_params = _n_params(params)
    measured: Dict[str, float] = {}

    def _gather_all() -> None:
        for li in range(cfg.num_layers):
            gather_layer({k: v[li] for k, v in shards.items()})

    def _measure_gather_ms() -> float:
        # every layer's gather, as a call runs them, timed end to end once
        # (after a warm run), on the first stats() that asks
        if "ms" not in measured:
            sync = (torch.cuda.synchronize if engine.device.type == "cuda"
                    else (lambda: None))
            _gather_all()
            sync()
            t0 = time.perf_counter()
            _gather_all()
            sync()
            measured["ms"] = (time.perf_counter() - t0) * 1e3
        return measured["ms"]

    model_bytes = _acct.hbm_model_bytes(params)
    chip = _acct.hbm_serve_bytes(
        params, strategy="fsdp", world=world,
        kv_bytes=kv_cache_bytes(engine.kv_cfg), num_layers=cfg.num_layers,
        shard_multiple=mult)
    wire = cfg.num_layers * _acct.param_gather_wire_bytes(
        metas, world, plan.weight_gather, mult)

    def plan_stats() -> Dict[str, Any]:
        return {"plan": "fsdp", "plan_world": world,
                "hbm_model_bytes": model_bytes,
                "hbm_chip_bytes": chip["total"],
                "weight_gather_ms": _measure_gather_ms(),
                "weight_gather_wire_bytes": wire}

    engine.plan_stats = plan_stats
    return engine


# ---------------------------------------------------------------------------
# (b) pp: activations stream between layer slices


class PPStagedEngine(InferenceEngine):
    """Pipeline-staged engine: stage s owns layers ``[s·L/S, (s+1)·L/S)``
    and the pools for exactly those layers, on ``devices[s]`` (a device may
    repeat). The public surface is the base engine's; its model calls
    become a host driver over the stages: decode and verify split the slot
    grid into M microbatches and tick a 1F schedule in which stage s runs
    microbatch ``t - s``, bounded by a per-stage handoff window (a stage
    whose downstream buffer is full idles the tick, and the stall is
    counted). A prefill chunk (one prompt) runs straight through. The
    engine's own device (sampling, host copies) is ``devices[0]``.

    Bitwise the plain engine's streams: splitting the layer loop at stage
    boundaries reorders no per-layer op, every row is computed alone, and
    the draws are keyed by request and position."""

    def __init__(self, params, cfg, serve_cfg, *,
                 devices: Optional[Sequence[Any]] = None,
                 microbatches: Optional[int] = None,
                 stage_window: int = 1,
                 **engine_kw):
        plan = serve_cfg.plan
        if plan is None or plan.serve_strategy() != "pp":
            raise ValueError("PPStagedEngine needs ServeConfig.plan with "
                             "pp > 1 (and nothing else sharding)")
        S = plan.pp
        if cfg.num_layers % S:
            raise ValueError(
                f"pp={S} stages need num_layers ({cfg.num_layers}) "
                f"divisible by the stage count")
        n = serve_cfg.num_slots
        if microbatches is None:
            # the largest count <= S dividing the slot grid: more adds
            # handoffs without shrinking the bubble below (S-1)/(M+S-1)'s
            # knee
            microbatches = next(m for m in range(min(S, n), 0, -1)
                                if n % m == 0)
        if n % microbatches:
            raise ValueError(
                f"microbatches ({microbatches}) must divide num_slots "
                f"({n}) — ragged microbatches would retrace per step")
        if stage_window < 1:
            raise ValueError(
                f"stage_window must be >= 1, got {stage_window}")
        for bad in ("transform", "tp_axis", "tp_size", "gather_layer"):
            if engine_kw.get(bad):
                raise ValueError(f"{bad} is owned by the PP engine")
        if devices is None:
            devices = [resolve_device(engine_kw.get("device"))] * S
        devices = [torch.device(d) for d in devices]
        if len(devices) < S:
            raise ValueError(
                f"pp={S} stages need {S} devices, have {len(devices)}")
        self._pp_stages = S
        self._pp_mb = microbatches
        self._pp_window = stage_window
        self._pp_devs = devices[:S]
        self._pp_busy_cells = 0
        self._pp_total_cells = 0
        self._pp_credit_waits = 0
        engine_kw["device"] = self._pp_devs[0]
        super().__init__(params, cfg, serve_cfg, **engine_kw)
        self._build_stages()
        self._pp_model_bytes = _acct.hbm_model_bytes(params)
        self._pp_chip_bytes = _acct.hbm_serve_bytes(
            params, strategy="pp", world=S,
            kv_bytes=kv_cache_bytes(self._stage_kv),
            num_layers=cfg.num_layers)["total"]
        self.plan_stats = self._pp_plan_stats

    def _resolve_megakernel(self) -> bool:
        """The stages ride the per-op layer body (``megakernel="on"``
        raises, naming it)."""
        if self.serve_cfg.megakernel == "on":
            raise ValueError(
                "megakernel='on' but the fused decode layer does not support "
                "this configuration: pipeline-staged programs ride the "
                "per-op layer body — use megakernel='off'/'auto'")
        return False

    # -- stage construction ------------------------------------------------
    def _build_stages(self) -> None:
        cfg = self.cfg
        S = self._pp_stages
        Ls = cfg.num_layers // S
        self._stage_kv = dataclasses.replace(self.kv_cfg, num_layers=Ls)
        layers = self.params["layers"]
        stages: List[Pytree] = []
        for s, dev in enumerate(self._pp_devs):
            pd: Dict[str, Any] = {"layers": {
                k: v[s * Ls:(s + 1) * Ls].to(dev) for k, v in layers.items()}}
            if s == 0 or s == S - 1:
                # the last stage's tied logits read the token table: it
                # holds a replica (the accounting model's assumption too)
                pd["embed"] = {k: v.to(dev)
                               for k, v in self.params["embed"].items()}
            if s == S - 1:
                pd["head"] = {k: v.to(dev)
                              for k, v in self.params["head"].items()}
            stages.append(pd)
        self.params = stages
        # per-stage pools: stage s writes and reads its layers under the
        # engine-global block ids and allocator
        self.cache = [init_kv_cache(self._stage_kv, dev)
                      for dev in self._pp_devs]

    def _stage_fwd(self, s: int, x, start_lens, n_valid, active,
                   block_tables):
        cfg, dev = self.cfg, self._pp_devs[s]
        pd = self.params[s]
        start_lens, n_valid, active, block_tables = (
            t.to(dev) for t in (start_lens, n_valid, active, block_tables))
        if s == 0:
            offs = torch.arange(x.shape[1], device=dev)
            positions = start_lens.long()[:, None] + offs[None, :]
            x = _embed(pd["embed"], x.to(dev),
                       torch.clamp(positions, max=cfg.max_seq - 1))
        x, _ = paged_layer_stack(
            x, pd["layers"], start_lens, n_valid, active, self.cache[s],
            block_tables, cfg, self._stage_kv, use_pallas=self._use_pallas)
        if s == self._pp_stages - 1:
            x = serve_logits(pd, x, cfg, self._use_pallas)
        return x

    # -- the pipeline tick loop ---------------------------------------------
    def _pp_forward(self, tokens, start_lens, n_valid, active, block_tables,
                    microbatches: int) -> torch.Tensor:
        """Drive (n, q) token rows through the stages in ``microbatches``
        row slices; returns (n, q, vocab) fp32 logits on the engine's
        device. The stage pools are written in place."""
        S = self._pp_stages
        n = tokens.shape[0]
        nmb = n // microbatches
        ready: List[collections.deque] = [collections.deque()
                                          for _ in range(S)]
        for m in range(microbatches):
            sl = slice(m * nmb, (m + 1) * nmb)
            ready[0].append((m, tokens[sl], (start_lens[sl], n_valid[sl],
                                             active[sl], block_tables[sl])))
        out: List[Any] = [None] * microbatches
        pending = microbatches
        while pending:
            self._pp_total_cells += S
            progressed = False
            # downstream first: a handoff made this tick is taken next tick
            # (the 1F timing the bubble model prices)
            for s in reversed(range(S)):
                if not ready[s]:
                    continue
                if s < S - 1 and len(ready[s + 1]) >= self._pp_window:
                    # the downstream buffer is full: this stage idles
                    self._pp_credit_waits += 1
                    continue
                m, x, rows = ready[s].popleft()
                if s > 0:  # the activation handoff between stages
                    x = x.to(self._pp_devs[s], non_blocking=True)
                y = self._stage_fwd(s, x, *rows)
                self._pp_busy_cells += 1
                progressed = True
                if s == S - 1:
                    out[m] = y
                    pending -= 1
                else:
                    ready[s + 1].append((m, y, rows))
            if not progressed:  # pragma: no cover - schedule invariant
                raise RuntimeError("pipeline deadlock: no stage ran")
        return torch.cat([o.to(self.device) for o in out], dim=0)

    # -- the engine's model calls, as drivers over the stages ---------------
    def _prefill_logits(self, slot, tokens, start, n_valid):
        dev = self.device
        one = torch.ones((1,), dtype=torch.int32, device=dev)
        logits = self._pp_forward(
            tokens[None, :], one * int(start), one * int(n_valid),
            one.bool(), self._dev("block_tables")[slot:slot + 1], 1)
        return logits[0, max(int(n_valid) - 1, 0)]

    def _decode_logits(self):
        n = self.serve_cfg.num_slots
        ones = torch.ones((n,), dtype=torch.int32, device=self.device)
        return self._pp_forward(
            self._dev("last_tokens")[:, None], self._dev("seq_lens"), ones,
            self._dev("active"), self._dev("block_tables"),
            self._pp_mb)[:, 0]

    def _verify_logits(self, fed, n_fed):
        return self._pp_forward(fed, self._dev("seq_lens"), n_fed,
                                self._dev("active"),
                                self._dev("block_tables"), self._pp_mb)

    def _copy_block(self, src: int, dst: int) -> None:
        for c in self.cache:
            copy_block(c, src, dst)

    # -- surfaces ------------------------------------------------------------
    def kv_budget_bytes(self) -> int:
        return self._pp_stages * kv_cache_bytes(self._stage_kv)

    def pp_bubble_fraction(self) -> float:
        """Measured idle share of the stage·tick cells of every pipeline
        drive so far (0.0 before any)."""
        if not self._pp_total_cells:
            return 0.0
        return 1.0 - self._pp_busy_cells / self._pp_total_cells

    def _pp_plan_stats(self) -> Dict[str, Any]:
        S, M = self._pp_stages, self._pp_mb
        return {
            "plan": "pp",
            "plan_world": S,
            "hbm_model_bytes": self._pp_model_bytes,
            "hbm_chip_bytes": self._pp_chip_bytes,
            "pp_microbatches": M,
            "pp_bubble_fraction": self.pp_bubble_fraction(),
            "pp_bubble_fraction_modeled": (S - 1) / (M + S - 1),
            "pp_credit_waits": self._pp_credit_waits,
        }


# ---------------------------------------------------------------------------
# front door


def build_engine(params, cfg, serve_cfg, *,
                 devices: Optional[Sequence[Any]] = None,
                 mesh=None, **engine_kw) -> InferenceEngine:
    """One constructor for every residency: the plain
    :class:`InferenceEngine` when ``serve_cfg.plan`` is None, else the
    strategy the plan's ``serve_overrides()`` resolves (tp / pp / fsdp).

    ``params`` is always the merged single-device tree
    (``init_gpt_params``' layout) on the engine's device; the plan's
    resident layout is cut here. tp and fsdp run one engine a rank:
    every rank calls this with the same params and requests, and the
    plan's mesh is installed over the process group's ranks (``devices``:
    the ranks to lay out; ``mesh``: one already built). pp takes
    ``devices`` as its stage devices (default: the engine's device for
    every stage)."""
    plan = serve_cfg.plan
    if plan is None:
        return InferenceEngine(params, cfg, serve_cfg, **engine_kw)
    cfg, ov = _apply_overrides(cfg, plan)
    strategy = ov["strategy"]
    devs = list(devices) if devices is not None else None
    if strategy == "tp":
        return _build_tp_engine(params, cfg, serve_cfg, plan, mesh, devs,
                                **engine_kw)
    if strategy == "fsdp":
        return _build_fsdp_engine(params, cfg, serve_cfg, plan, mesh, devs,
                                  **engine_kw)
    return PPStagedEngine(params, cfg, serve_cfg, devices=devs, **engine_kw)

