"""Rank functions of the port's plan-sharded serving tests
(``tests/test_torch_serve_sharded.py``).

Each runs in a process that ``apex_tpu_torch.parallel.multiproc.spawn``
started, as one rank of a ``gloo`` group; every rank builds the same
engine through ``serve.build_engine`` and serves the same requests. This
module imports torch, numpy and the port only (a spawned rank never
imports JAX); every result of :func:`several` carries ``jax_loaded``.
"""

from __future__ import annotations

import sys

import torch


def several(rank, world, calls):
    """Each ``(function name, args)`` of this module in turn -> their
    results by name, and ``jax_loaded``."""
    mod = sys.modules[__name__]
    out = {name: getattr(mod, fn)(rank, world, *args)
           for name, (fn, args) in calls.items()}
    out["jax_loaded"] = any(m in sys.modules for m in
                            ("jax", "jaxlib", "flax", "apex_tpu"))
    return out


PLAN_FIELDS = ("plan", "plan_world", "hbm_model_bytes", "hbm_chip_bytes",
               "weight_gather_ms", "weight_gather_wire_bytes")


def make_plan(plan_kw):
    """A ``ParallelismPlan`` from keyword args (``weight_gather`` as the
    ``CompressionConfig`` keywords)."""
    from apex_tpu_torch.comm import CompressionConfig
    from apex_tpu_torch.parallel import ParallelismPlan

    kw = dict(plan_kw)
    if kw.get("weight_gather") is not None:
        kw["weight_gather"] = CompressionConfig(**kw["weight_gather"])
    return ParallelismPlan(**kw)


def serve_config(plan, scfg_kw):
    from apex_tpu_torch.serve import SamplingConfig, ServeConfig

    kw = dict(scfg_kw)
    if "sampling" in kw:
        kw["sampling"] = SamplingConfig(**kw["sampling"])
    return ServeConfig(num_slots=4, block_size=8, prefill_chunk=8,
                       plan=plan, **kw)


def requests(reqs):
    from apex_tpu_torch.serve import Request

    return [Request(u, list(p), max_new_tokens=m) for u, p, m in reqs]


def serve(rank, world, cfg_fields, params, cases, reqs):
    """For each ``name: (plan keywords, ServeConfig keywords)``: the
    streams of ``build_engine`` on this rank and the plan fields of its
    ``stats()``."""
    from apex_tpu_torch.convert import params_from_numpy
    from apex_tpu_torch.serve import build_engine
    from apex_tpu_torch.transformer.testing import GPTConfig

    cfg = GPTConfig(**cfg_fields)
    p = params_from_numpy(params, "cpu")
    out = {}
    for name, (plan_kw, scfg_kw) in cases.items():
        eng = build_engine(p, cfg, serve_config(make_plan(plan_kw), scfg_kw),
                           device="cpu")
        streams = eng.run(requests(reqs))
        st = eng.stats()
        out[name] = (streams, {k: st[k] for k in PLAN_FIELDS if k in st},
                     st["decode_kernel"], eng.kv_cfg.num_heads)
    return out


def tp_exits(rank, world, cfg_fields, params, plan_kw):
    """The collectives each call of a tp engine issues (the counterpart of
    JAX's HLO gates): for a decode (q = 1), a verify (q = spec_k + 1 = 4)
    and a prefill chunk (q = 8), the ring ops posted
    (``comm.record_overlap``: ops, hops, hidden fraction) and the
    collective kinds (``comm.record_collectives``)."""
    from apex_tpu_torch.comm.accounting import (overlap_report,
                                                record_collectives,
                                                record_overlap)
    from apex_tpu_torch.convert import params_from_numpy
    from apex_tpu_torch.serve import build_engine
    from apex_tpu_torch.transformer.testing import GPTConfig

    cfg = GPTConfig(**cfg_fields)
    eng = build_engine(params_from_numpy(params, "cpu"), cfg,
                       serve_config(make_plan(plan_kw), {"spec_k": 3}),
                       device="cpu")
    n = eng.serve_cfg.num_slots
    calls = {
        "decode": lambda: eng._decode_logits(),
        "verify": lambda: eng._verify_logits(
            torch.zeros((n, 4), dtype=torch.int32),
            torch.ones((n,), dtype=torch.int32)),
        "chunk_prefill": lambda: eng._prefill_logits(
            0, torch.zeros((8,), dtype=torch.int32), 0, 1),
    }
    out = {}
    for name, call in calls.items():
        with record_collectives() as coll, record_overlap() as rings:
            call()
        rep = overlap_report(rings)
        out[name] = dict(ring_ops=len(rings), permutes=rep.permutes,
                         hidden_fraction=rep.hidden_fraction,
                         kinds=sorted({c.kind for c in coll}))
    return out
