"""Plan-sharded serving (``serve/sharded.py``, the engine's tensor
parallelism) against the JAX package's.

The counterparts of ``tests/test_serve_sharded.py``, at JAX's config
(vocab 64, max_seq 64, hidden 32, 4 layers, 4 heads, fp32) on JAX's
initialization and its four requests. Streams: ``build_engine`` with
``ParallelismPlan(tp=4, overlap_comm=True)`` and ``ParallelismPlan("fsdp",
dp=4)`` on 4 ``gloo`` ranks (one spawn, every rank serving the same
requests; rank functions in ``tests/torch_serve_workers.py``) and
``ParallelismPlan(pp=2)`` in this process, greedy, int8 and int4 KV and
``spec_k = 3`` equal to JAX's single-device engine's streams, and every
stream (sampled included: the port's draws are its own counter hash)
equal to the port's plain engine's; the int8 ``weight_gather`` stream; the
plan fields of ``stats()``; the pp bubble accounting and validation
(JAX's messages); the counterpart of JAX's HLO gates from the port's
collective records (the q > 1 calls' exits ride the ring, decode only
all-reduces); and the plan checks ``tests/test_torch_plan.py`` does not
hold. JAX's compile-count gate has no counterpart (no compiled programs;
ROADMAP §C).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.parallel import ParallelismPlan as JPlan
from apex_tpu.serve import InferenceEngine as JEngine
from apex_tpu.serve import Request as JRequest
from apex_tpu.serve import ServeConfig as JServeConfig
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jinit_gpt
from apex_tpu_torch.comm import CompressionConfig
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.fsdp.accounting import (hbm_serve_bytes,
                                            param_gather_wire_bytes)
from apex_tpu_torch.fsdp.core import LeafMeta
from apex_tpu_torch.parallel import ParallelismPlan
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.serve import (InferenceEngine, PPStagedEngine,
                                  ServeConfig, build_engine, plan_world)
from apex_tpu_torch.transformer.testing import GPTConfig

import torch_serve_workers as workers

WORLD = 4
SIZES = dict(vocab_size=64, max_seq=64, hidden=32, num_layers=4,
             num_heads=4, fused_loss=False)
CFG = GPTConfig(dtype=torch.float32, **SIZES)
JCFG = JGPTConfig(dtype=jnp.float32, **SIZES)
NP_PARAMS = jax.tree.map(np.asarray, jinit_gpt(jax.random.PRNGKey(0), JCFG))
PARAMS = params_from_numpy(NP_PARAMS, "cpu")
REQS = (("a", (1, 2, 3, 4, 5), 6), ("b", (7, 8, 9), 4),
        ("c", tuple(range(10, 22)), 5), ("d", (5, 4, 3), 5))
SAMPLED = dict(temperature=0.8, top_k=16)
# the ServeConfig variants: name -> (keywords, held to JAX's oracle)
VARIANTS = {
    "greedy": ({}, True),
    "sampled": ({"sampling": SAMPLED}, False),
    "int8": ({"kv_quant": "int8"}, True),
    "int4": ({"kv_quant": "int4"}, True),
    "spec3": ({"spec_k": 3}, True),
}
PLANS = {"tp": dict(tp=4, overlap_comm=True),
         "fsdp": dict(data="fsdp", dp=4),
         "pp": dict(pp=2)}
WG8 = dict(data="fsdp", dp=4, weight_gather=dict(policy="int8"))


def _scfg(plan=None, **kw):
    return workers.serve_config(plan, kw)


@functools.lru_cache(maxsize=None)
def _oracle(variant):
    """JAX's single-device engine's streams."""
    kw = dict(VARIANTS[variant][0])
    eng = JEngine(jax.tree.map(jnp.asarray, NP_PARAMS), JCFG,
                  JServeConfig(num_slots=4, block_size=8, prefill_chunk=8,
                               **kw))
    return eng.run([JRequest(u, list(p), max_new_tokens=m)
                    for u, p, m in REQS])


@functools.lru_cache(maxsize=None)
def _plain(variant):
    """The port's plain engine's streams."""
    return InferenceEngine(PARAMS, CFG, _scfg(**VARIANTS[variant][0]),
                           device="cpu").run(workers.requests(REQS))


@functools.lru_cache(maxsize=None)
def _spawned():
    cases = {f"{s}_{v}": (PLANS[s], kw) for s in ("tp", "fsdp")
             for v, (kw, _) in VARIANTS.items()}
    cases["fsdp_wg8"] = (WG8, {})
    fields = dict(dtype=torch.float32, **SIZES)
    return spawn(workers.several, WORLD, {
        "serve": ("serve", (fields, NP_PARAMS, cases, REQS)),
        "exits": ("tp_exits", (fields, NP_PARAMS, PLANS["tp"]))})


@functools.lru_cache(maxsize=None)
def _pp(variant):
    eng = build_engine(PARAMS, CFG, _scfg(workers.make_plan(PLANS["pp"]),
                                          **VARIANTS[variant][0]),
                       device="cpu")
    return eng.run(workers.requests(REQS)), eng


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _spawned())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_engine_matches_jax_oracle(variant):
    if VARIANTS[variant][1]:
        assert _plain(variant) == _oracle(variant)
    if variant == "spec3":
        assert _oracle("spec3") == _oracle("greedy")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("strategy", sorted(PLANS))
def test_stream_parity(strategy, variant):
    """Each strategy's streams on every rank: JAX's oracle's (greedy, int8
    and int4 KV, spec_k = 3; the tp logits differ from one device's by the
    order of the tp sum, the streams do not) and the plain engine's."""
    if strategy == "pp":
        streams, eng = _pp(variant)
        got = [(streams, eng.stats())]
    else:
        got = [(r["serve"][f"{strategy}_{variant}"][0],
                r["serve"][f"{strategy}_{variant}"][1]) for r in _spawned()]
    for streams, st in got:
        assert streams == _plain(variant)
        if VARIANTS[variant][1]:
            assert streams == _oracle(variant)
        assert st["plan"] == strategy


def test_tp_engine_holds_local_heads_and_rides_the_per_op_body():
    for r in _spawned():
        _, st, kernel, heads = r["serve"]["tp_greedy"]
        assert heads == 1 and kernel == "plain"
        assert st["plan_world"] == 4
        assert st["hbm_chip_bytes"] < st["hbm_model_bytes"]


def test_tp_exits_ride_the_ring_for_q_above_one():
    """The counterpart of JAX's HLO gates: the verify (q = 4) and prefill
    chunk (q = 8) calls put their row-parallel exits on the
    ``comm.overlap`` ring, at least half the hop bytes behind partial
    products; decode (q = 1) posts no ring hop and keeps all-reduce
    exits."""
    for r in _spawned():
        ex = r["exits"]
        for name in ("verify", "chunk_prefill"):
            assert ex[name]["ring_ops"] == 2 * CFG.num_layers, name
            assert ex[name]["permutes"] > 0
            assert ex[name]["hidden_fraction"] >= 0.5
        assert ex["decode"]["ring_ops"] == 0
        assert "collective-permute" not in ex["decode"]["kinds"]
        assert "all-reduce" in ex["decode"]["kinds"]


def test_fsdp_gather_stats_and_codec_stream():
    for r in _spawned():
        _, st, kernel, _ = r["serve"]["fsdp_greedy"]
        assert st["plan"] == "fsdp" and st["plan_world"] == 4
        assert st["weight_gather_ms"] > 0.0
        assert st["weight_gather_wire_bytes"] > 0
        assert kernel == "plain"
        # the int8 weight_gather codec serves the same greedy stream here
        streams8, st8, _, _ = r["serve"]["fsdp_wg8"]
        assert streams8 == _oracle("greedy")
        assert st8["weight_gather_wire_bytes"] < st["weight_gather_wire_bytes"]


def test_pp_bubble_and_stats():
    _, eng = _pp("greedy")
    assert isinstance(eng, PPStagedEngine)
    st = eng.stats()
    assert st["plan"] == "pp" and st["plan_world"] == 2
    S, M = 2, st["pp_microbatches"]
    assert st["pp_bubble_fraction_modeled"] == (S - 1) / (M + S - 1)
    assert 0.0 < st["pp_bubble_fraction"] < 1.0
    # a stage's bytes: its layers, the edge stages' embed / head replica
    # and its pools (JAX's accounting model)
    from apex_tpu_torch.serve.kv_cache import kv_cache_bytes

    assert st["hbm_chip_bytes"] == hbm_serve_bytes(
        PARAMS, strategy="pp", world=2,
        kv_bytes=kv_cache_bytes(eng._stage_kv),
        num_layers=CFG.num_layers)["total"] > 0
    assert st["decode_kernel"] == "plain"
    assert len(eng.cache) == 2
    assert eng.cache[0]["k"].shape[0] == CFG.num_layers // 2


def test_pp_engine_validation():
    pp = workers.make_plan(PLANS["pp"])
    with pytest.raises(ValueError, match="divisible by the stage count"):
        PPStagedEngine(PARAMS, dataclasses.replace(CFG, num_layers=3),
                       _scfg(plan=pp), device="cpu")
    with pytest.raises(ValueError, match="must divide num_slots"):
        PPStagedEngine(PARAMS, CFG, _scfg(plan=pp), microbatches=3,
                       device="cpu")
    with pytest.raises(ValueError, match="stage_window"):
        PPStagedEngine(PARAMS, CFG, _scfg(plan=pp), stage_window=0,
                       device="cpu")
    with pytest.raises(ValueError, match="needs ServeConfig.plan"):
        PPStagedEngine(PARAMS, CFG, _scfg(
            plan=workers.make_plan(PLANS["tp"])), device="cpu")
    with pytest.raises(ValueError, match="stages need 2 devices"):
        PPStagedEngine(PARAMS, CFG, _scfg(plan=pp), devices=["cpu"],
                       device="cpu")
    with pytest.raises(ValueError, match="owned by the PP engine"):
        PPStagedEngine(PARAMS, CFG, _scfg(plan=pp), tp_axis="tp",
                       device="cpu")
    with pytest.raises(ValueError, match="per-op"):
        PPStagedEngine(PARAMS, CFG, _scfg(plan=pp, megakernel="on"),
                       device="cpu")


def test_pp_window_and_microbatches_keep_the_streams():
    """A wider handoff window and one microbatch change the schedule (and
    the measured bubble), not the streams."""
    pp = workers.make_plan(PLANS["pp"])
    for kw in (dict(stage_window=2), dict(microbatches=1)):
        eng = PPStagedEngine(PARAMS, CFG, _scfg(plan=pp), device="cpu", **kw)
        assert eng.run(workers.requests(REQS)) == _plain("greedy")
        assert eng.stats()["pp_microbatches"] == kw.get("microbatches", 2)


def test_build_engine_plan_none_is_plain_engine():
    eng = build_engine(PARAMS, CFG, _scfg(), device="cpu")
    assert type(eng) is InferenceEngine
    assert "plan" not in eng.stats()


def test_plan_world():
    plans = {k: workers.make_plan(v) for k, v in PLANS.items()}
    assert plan_world(plans["tp"]) == 4
    assert plan_world(plans["pp"]) == 2
    assert plan_world(plans["fsdp"]) == 4
    assert plan_world(ParallelismPlan("fsdp"), devices=list(range(6))) == 6
    assert plan_world(ParallelismPlan("fsdp")) == 1   # no process group


def test_serve_config_plan_validation():
    """JAX's checks and messages (``ServeConfig.validate``)."""
    for bad, jbad, err, msg in (
            (object(), object(), ValueError, "must be a ParallelismPlan"),
            (ParallelismPlan("zero1"), JPlan("zero1"), ValueError,
             "zero1")):
        with pytest.raises(err, match=msg):
            _scfg(plan=bad).validate()
        with pytest.raises(err, match=msg):
            JServeConfig(plan=jbad).validate()
    with pytest.raises(NotImplementedError, match="LoRA") as pe:
        _scfg(plan=workers.make_plan(PLANS["pp"]), lora_rank=4,
              max_adapters=1).validate()
    with pytest.raises(NotImplementedError) as je:
        JServeConfig(plan=JPlan(pp=2), lora_rank=4,
                     max_adapters=1).validate()
    assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="must be a ParallelismPlan"):
        build_engine(PARAMS, CFG, dataclasses.replace(_scfg(), plan="tp"),
                     device="cpu")


def test_engine_tp_arguments_checked_as_jax():
    with pytest.raises(ValueError, match="tp_axis together with tp_size"):
        InferenceEngine(PARAMS, CFG, _scfg(), device="cpu", tp_size=2)
    with pytest.raises(ValueError, match="tp_axis together with tp_size"):
        InferenceEngine(PARAMS, CFG, _scfg(), device="cpu", tp_axis="tp")
    with pytest.raises(ValueError, match="not divisible by tp_size"):
        InferenceEngine(PARAMS, CFG, _scfg(), device="cpu", tp_axis="tp",
                        tp_size=3)
    with pytest.raises(NotImplementedError, match="not TP-sharded"):
        InferenceEngine(PARAMS, CFG, _scfg(lora_rank=4, max_adapters=1),
                        device="cpu", tp_axis="tp", tp_size=2)
    # the fused layer is refused under tp with JAX's reason ("auto"
    # resolves to the per-op body)
    with pytest.raises(ValueError, match="TP-sharded programs ride"):
        InferenceEngine(PARAMS, CFG, _scfg(megakernel="on"), device="cpu",
                        tp_axis="tp", tp_size=2)
    assert not InferenceEngine(PARAMS, CFG, _scfg(), device="cpu",
                               tp_axis="tp", tp_size=2).megakernel_enabled


def test_param_gather_codec_halves_wire_at_size():
    big = {"qkv": LeafMeta((1024, 3, 1024), "float32"),
           "fc1": LeafMeta((1024, 4096), "float32")}
    wg = CompressionConfig(policy="int8")
    full = param_gather_wire_bytes(big, 8, None, 1)
    coded = param_gather_wire_bytes(big, 8, wg, 128)
    assert coded < 0.5 * full
    tiny = {"ln": LeafMeta((32,), "float32")}
    assert (param_gather_wire_bytes(tiny, 8, wg, 128)
            > param_gather_wire_bytes(tiny, 8, None, 1))


def test_hbm_serve_accounting_splits_strategies():
    kv = 1000.0
    single = hbm_serve_bytes(PARAMS, strategy="single", world=1, kv_bytes=kv)
    tp = hbm_serve_bytes(PARAMS, strategy="tp", world=4, kv_bytes=kv / 4,
                         num_layers=CFG.num_layers)
    pp = hbm_serve_bytes(PARAMS, strategy="pp", world=2, kv_bytes=kv / 2,
                         num_layers=CFG.num_layers)
    fsdp = hbm_serve_bytes(PARAMS, strategy="fsdp", world=8, kv_bytes=kv,
                           num_layers=CFG.num_layers)
    assert single["total"] > max(tp["total"], pp["total"])
    assert tp["params_bytes"] == pytest.approx(single["params_bytes"] / 4)
    assert pp["params_bytes"] > single["params_bytes"] / 2 / 2
    assert fsdp["gather_workspace_bytes"] > 0
    assert single["gather_workspace_bytes"] == 0
    with pytest.raises(ValueError, match="strategy"):
        hbm_serve_bytes(PARAMS, strategy="zz", world=2, kv_bytes=0.0)
