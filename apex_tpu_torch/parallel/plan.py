"""ParallelismPlan — every parallelism decision as one declarative object
(counterpart of ``apex_tpu/parallel/plan.py``).

A plan holds the mesh shape (dp / tp / pp / sp, validated against
``mesh.AXIS_ORDER`` and, at :meth:`mesh`, the rank count), the data
strategy (``"ddp"``: replicated params and an all-reduce; ``"zero1"``:
``DistributedFusedAdam`` / ``LAMB``, sharded optimizer state; ``"fsdp"``:
sharded parameters gathered on demand), the wire policies (the gradient
leg's ``CompressionConfig``, FSDP's ``weight_gather`` codec, ZeRO-1's
``e5m2_allgather``), overlap flags and the fused-tail mode, and builds the
components from them::

    plan = ParallelismPlan.preset("fsdp")
    mesh = plan.mesh()                  # over the default process group
    opt = plan.build_optimizer(lr=1e-3)   # FSDPAdam over plan.fsdp()
    print(plan.describe())

The field checks, presets, accounting and :meth:`describe`'s text are
JAX's. :meth:`checkpoint_manager` sits on the resilience package (ROADMAP
A8); the serving hooks (:meth:`serve_strategy`, :meth:`serve_overrides`)
validate and return what a sharded engine would take, whose engine is
ROADMAP A8 too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from apex_tpu_torch.parallel.mesh import AXIS_ORDER, DP_AXIS, build_mesh

DATA_STRATEGIES = ("ddp", "zero1", "fsdp")
PRESETS = ("ddp", "zero1", "fsdp", "fsdp+tp")
OPTIMIZERS = ("adam", "lamb")
# inference residency strategies: which term of the plan carries the
# model when it does not fit one chip
SERVE_STRATEGIES = ("tp", "pp", "fsdp")


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    """Declarative parallelism config; every field is checked at
    construction (JAX's messages)."""

    data: str = "ddp"
    dp: int = -1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    dp_axis: str = DP_AXIS
    compression: Optional[Any] = None     # the gradient leg's codec
    weight_gather: Optional[Any] = None   # FSDP's parameter-gather codec
    e5m2_allgather: bool = False          # ZeRO-1's gather transport
    overlap_comm: bool = False
    bidirectional: bool = False
    fused_update: str = "auto"
    optimizer: str = "adam"

    def __post_init__(self):
        if self.data not in DATA_STRATEGIES:
            raise ValueError(
                f"data must be one of {DATA_STRATEGIES}, got {self.data!r}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {OPTIMIZERS}, "
                f"got {self.optimizer!r}")
        if self.dp_axis not in AXIS_ORDER:
            raise ValueError(
                f"dp_axis {self.dp_axis!r} is not a mesh axis; the mesh "
                f"vocabulary is {AXIS_ORDER}")
        for name in ("tp", "pp", "sp"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not isinstance(self.dp, int) or (self.dp < 1 and self.dp != -1):
            raise ValueError(
                f"dp must be a positive int or -1 (all remaining devices), "
                f"got {self.dp!r}")
        if self.e5m2_allgather and self.data != "zero1":
            raise ValueError(
                "e5m2_allgather is the ZeRO-1 param-gather transport; "
                f"data={self.data!r} does not gather from a ZeRO-1 "
                "optimizer (FSDP's analogue is weight_gather=)")
        if self.weight_gather is not None and self.data != "fsdp":
            raise ValueError(
                "weight_gather is the FSDP param-gather codec; it has no "
                f"wire to ride under data={self.data!r}")
        if self.data == "fsdp" and self.optimizer != "adam":
            raise ValueError(
                "fsdp currently ships an Adam(W) shard optimizer only "
                "(FSDPAdam); optimizer='lamb' is a ZeRO-1 recipe")
        from apex_tpu_torch.ops.fused_update import resolve_fused

        resolve_fused(self.fused_update)
        if self.data == "fsdp":
            self.fsdp()  # the FSDP codec checks, eagerly

    # -- presets -----------------------------------------------------------
    @classmethod
    def preset(cls, name: str, **overrides) -> "ParallelismPlan":
        """``ddp`` | ``zero1`` | ``fsdp`` | ``fsdp+tp`` (fsdp over dp with
        tensor parallelism and overlapped rings; tp=2 unless given)."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown plan preset {name!r}; presets: {PRESETS}")
        base = {
            "ddp": dict(data="ddp"),
            "zero1": dict(data="zero1"),
            "fsdp": dict(data="fsdp"),
            "fsdp+tp": dict(data="fsdp", tp=2, overlap_comm=True),
        }[name]
        base.update(overrides)
        return cls(**base)

    # -- mesh --------------------------------------------------------------
    def mesh(self, devices: Optional[Sequence[int]] = None):
        """The dp × pp × sp × tp mesh over the default process group's
        ranks (or ``devices``), installed as the current mesh; raises
        with the divisibility arithmetic when the ranks do not fit."""
        return build_mesh(tp=self.tp, pp=self.pp, sp=self.sp, dp=self.dp,
                          devices=devices)

    def model_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in AXIS_ORDER if a != self.dp_axis)

    # -- component builders ------------------------------------------------
    def ddp(self, **kw):
        """The bucketed all-reduce DDP (data='ddp')."""
        if self.data != "ddp":
            raise ValueError(
                f"plan.data={self.data!r}: gradients ride the sharded "
                "optimizer's reduce-scatter, not a DDP allreduce")
        from apex_tpu_torch.parallel.distributed import (
            DistributedDataParallel,
        )

        return DistributedDataParallel(
            axis=self.dp_axis, compression=self.compression, **kw)

    def fsdp(self, **kw):
        """The ZeRO-3 engine (data='fsdp')."""
        if self.data != "fsdp":
            raise ValueError(f"plan.data={self.data!r} is not fsdp")
        from apex_tpu_torch.fsdp import FSDP

        return FSDP(axis_name=self.dp_axis, compression=self.compression,
                    weight_gather=self.weight_gather,
                    bidirectional=self.bidirectional, **kw)

    def build_optimizer(self, lr: float = 1e-3, params=None, **kw):
        """The plan's optimizer: ``zero1`` → ``DistributedFusedAdam`` /
        ``LAMB``; ``fsdp`` → ``FSDPAdam``; ``ddp`` → ``FusedAdam`` /
        ``FusedLAMB``, which are ``torch.optim`` optimizers over tensors:
        pass them as ``params`` (the port's one addition to JAX's
        signature)."""
        if self.data == "zero1":
            from apex_tpu_torch.contrib.optimizers import (
                DistributedFusedAdam,
                DistributedFusedLAMB,
            )

            cls = (DistributedFusedAdam if self.optimizer == "adam"
                   else DistributedFusedLAMB)
            kwargs = dict(lr=lr, axis_name=self.dp_axis,
                          compression=self.compression,
                          fused_update=self.fused_update, **kw)
            if self.optimizer == "adam":
                kwargs["e5m2_allgather"] = self.e5m2_allgather
            elif self.e5m2_allgather:
                raise ValueError(
                    "e5m2_allgather is a DistributedFusedAdam option")
            return cls(**kwargs)
        if self.data == "fsdp":
            from apex_tpu_torch.fsdp import FSDPAdam

            return FSDPAdam(fsdp=self.fsdp(), lr=lr,
                            fused_update=self.fused_update, **kw)
        from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB

        if params is None:
            raise ValueError(
                "data='ddp' builds FusedAdam / FusedLAMB, torch optimizers "
                "over the model's tensors: pass params=")
        cls = FusedAdam if self.optimizer == "adam" else FusedLAMB
        return cls(params, lr=lr, **kw)

    def checkpoint_manager(self, directory: str,
                           allow_reshard: bool = False, **kw):
        raise NotImplementedError(
            "ParallelismPlan.checkpoint_manager builds the resilience "
            "package's CheckpointManager (sharded manifests, elastic "
            "restores), which the port has not ported yet: ROADMAP A8")

    def gpt_overrides(self) -> dict:
        """``GPTConfig`` fields this plan pins."""
        out = {}
        if self.tp > 1:
            out["megatron_sp"] = True
            out["overlap_comm"] = self.overlap_comm
        return out

    # -- serving -----------------------------------------------------------
    def serve_strategy(self) -> str:
        """Which residency strategy carries the model at inference:
        ``"tp"``, ``"pp"`` or ``"fsdp"``; exactly one plan term may shard
        the model, and a plan that shards nothing is refused."""
        sharded = []
        if self.tp > 1:
            sharded.append("tp")
        if self.pp > 1:
            sharded.append("pp")
        if self.data == "fsdp":
            sharded.append("fsdp")
        if len(sharded) > 1:
            raise NotImplementedError(
                f"plan shards the model {len(sharded)} ways at once "
                f"({'+'.join(sharded)}); serve.sharded composes ONE "
                "residency strategy per engine — split tp/pp/fsdp into "
                "separate plans (composed-strategy serving is future "
                "work; 'fsdp+tp' is a TRAINING preset)")
        if not sharded:
            raise ValueError(
                f"plan (data={self.data!r}, tp=1, pp=1) shards nothing "
                "at inference — the model fits or it doesn't, and this "
                "plan keeps it whole either way. Use the plain "
                "InferenceEngine, or set tp=/pp= or data='fsdp'")
        return sharded[0]

    def serve_overrides(self) -> dict:
        """The engine fields this plan pins at inference; refuses the
        knobs that only feed an optimizer step."""
        if self.e5m2_allgather:
            raise ValueError(
                "e5m2_allgather is the ZeRO-1 optimizer param-gather "
                "transport (master shards -> model params, once per "
                "step); inference gathers from no optimizer — the "
                "serving analogue is weight_gather= on an fsdp plan")
        if self.data == "zero1":
            raise ValueError(
                "data='zero1' shards OPTIMIZER state only — params and "
                "grads stay replicated full-model, so a ZeRO-1 plan "
                "serves nothing a single chip doesn't (inference runs "
                "zero optimizer steps). Use tp=/pp= or data='fsdp'")
        if self.compression is not None and self.compression.error_feedback:
            raise ValueError(
                f"compression policy {self.compression.policy!r} carries "
                "an fp32 error-feedback residual (4 B/element — more HBM "
                "than the int8 wire it compensates saves) that telescopes "
                "into the NEXT optimizer step; inference runs none, so "
                "the residual is dead weight. Use policy 'int8'/'int4' "
                "or compression=None for serving plans")
        strategy = self.serve_strategy()
        out: dict = {"strategy": strategy,
                     "overlap_comm": self.overlap_comm}
        if strategy == "tp":
            out["tp"] = self.tp
        elif strategy == "pp":
            out["pp"] = self.pp
        else:
            out["dp_axis"] = self.dp_axis
            out["weight_gather"] = self.weight_gather
        return out

    def _serve_story(self) -> str:
        """One line of residency story for :meth:`describe` (never
        raises)."""
        wgather = (self.weight_gather.policy if self.weight_gather
                   else "model-dtype")
        if self.tp > 1 and self.pp == 1 and self.data != "fsdp":
            exits = ("overlapped rings" if self.overlap_comm
                     else "monolithic psum")
            return (f"TP — heads/vocab sharded {self.tp}-way, KV pools "
                    f"hold local heads; q_len>1 row exits {exits}, "
                    "q_len=1 monolithic")
        if self.pp > 1 and self.tp == 1 and self.data != "fsdp":
            return (f"PP — {self.pp} staged layer shards stream "
                    "activations (credit-windowed microbatches); each "
                    "stage owns its layers' KV pools")
        if self.data == "fsdp" and self.tp == 1 and self.pp == 1:
            return ("FSDP — block-aligned layer-weight shards resident, "
                    f"gathered on demand per layer ({wgather} wire); "
                    "embed/head + KV replicated")
        if self.tp > 1 or self.pp > 1 or self.data == "fsdp":
            return "composed model sharding — training-only (no serve tier)"
        return "single-chip engine (model unsharded at inference)"

    # -- accounting / description ------------------------------------------
    def hbm_params_bytes(self, params_or_meta, world: int) -> dict:
        """Modeled per-chip param + grad + optimizer-state bytes of this
        plan's data strategy (``fsdp.accounting``)."""
        from apex_tpu_torch.contrib.optimizers._sharding import (
            shard_multiple_lcm,
        )
        from apex_tpu_torch.fsdp.accounting import hbm_params_bytes

        return hbm_params_bytes(
            params_or_meta, strategy=self.data, world=world,
            shard_multiple=shard_multiple_lcm(self.compression,
                                              self.weight_gather))

    def hbm_serve_bytes(self, params_or_meta, world: int,
                        kv_bytes: float = 0.0,
                        num_layers: Optional[int] = None) -> dict:
        """Modeled per-chip bytes of this plan's serving residency
        strategy: params and this chip's KV pool."""
        from apex_tpu_torch.contrib.optimizers._sharding import (
            shard_multiple_lcm,
        )
        from apex_tpu_torch.fsdp.accounting import hbm_serve_bytes

        return hbm_serve_bytes(
            params_or_meta, strategy=self.serve_strategy(), world=world,
            kv_bytes=kv_bytes, num_layers=num_layers,
            shard_multiple=shard_multiple_lcm(None, self.weight_gather))

    def describe(self) -> str:
        """The resolved plan, printable (JAX's text)."""
        wire = self.compression.policy if self.compression else "fp32"
        wgather = (self.weight_gather.policy if self.weight_gather
                   else ("e5m2" if self.e5m2_allgather else "model-dtype"))
        lines = [
            f"ParallelismPlan(data={self.data}, optimizer={self.optimizer})",
            f"  mesh: dp={self.dp if self.dp != -1 else 'auto'} pp={self.pp}"
            f" sp={self.sp} tp={self.tp} (axes {AXIS_ORDER})",
            f"  grad wire: {wire}; param gather: "
            + (wgather if self.data != "ddp" else "n/a (replicated)"),
            f"  overlap_comm={self.overlap_comm}"
            f" bidirectional={self.bidirectional}"
            f" fused_update={self.fused_update}",
            f"  serve: {self._serve_story()}",
        ]
        return "\n".join(lines)
