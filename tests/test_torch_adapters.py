"""apex_tpu_torch.serve.adapters (per-tenant paged LoRA) on the CPU, against
apex_tpu.serve.adapters and JAX's adapter engine.

Small fp32 GPTs as in ``tests/test_serve_adapters.py`` (vocab 97, hidden
32, 2 layers, 4 heads); JAX's weights and JAX's ``make_adapter_weights``
output are carried across as numpy (``params_from_numpy`` /
``adapter_weights_from_numpy``), so both packages serve the same tenants.
JAX runs as its own tests run it on the CPU (the reference paged
attention, no Pallas).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.serve import AdapterRegistry as JRegistry
from apex_tpu.serve import InferenceEngine as JEngine
from apex_tpu.serve import KVCacheConfig as JKV
from apex_tpu.serve import Request as JRequest
from apex_tpu.serve import ServeConfig as JServeConfig
from apex_tpu.serve import init_adapter_pool as jax_pool
from apex_tpu.serve import init_kv_cache as jax_init_cache
from apex_tpu.serve import lora_delta as jax_lora_delta
from apex_tpu.serve import make_adapter_weights as jax_make_weights
from apex_tpu.serve import write_adapter as jax_write_adapter
from apex_tpu.serve.decode import gpt_prefill_chunk as jax_chunk
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.convert import (adapter_weights_from_numpy,
                                    params_from_numpy)
from apex_tpu_torch.serve import (ADAPTER_TARGETS, AdapterRegistry,
                                  InferenceEngine, KVCacheConfig, Request,
                                  SamplingConfig, ServeConfig,
                                  adapter_pool_bytes, gpt_prefill_chunk,
                                  init_adapter_pool, init_kv_cache,
                                  lora_delta, make_adapter_weights,
                                  merge_adapter_params, write_adapter)
from apex_tpu_torch.serve import adapters as pad
from apex_tpu_torch.serve import decode as pdec
from apex_tpu_torch.transformer.testing import GPTConfig

JCFG = JGPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                  num_heads=4, dtype=jnp.float32, fused_loss=False)
CFG = GPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                num_heads=4, dtype=torch.float32)
JPARAMS = jax_init(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")
JKVC = JKV(num_layers=2, num_heads=4, head_dim=8, num_blocks=8,
           block_size=8, dtype=jnp.float32)
KV = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8, num_blocks=8,
                   block_size=8, dtype=torch.float32)

JW1 = jax_make_weights(JCFG, 4, jax.random.PRNGKey(42), std=0.05)
JW2 = jax_make_weights(JCFG, 4, jax.random.PRNGKey(43), std=0.05)
W1 = adapter_weights_from_numpy(jax.tree.map(np.asarray, JW1), "cpu")
W2 = adapter_weights_from_numpy(jax.tree.map(np.asarray, JW2), "cpu")

REQS = [("a", [1, 2, 3, 4, 5], 6), ("b", [7, 8, 9], 4),
        ("c", list(range(10, 22)), 5), ("d", ([5, 6, 7, 8] * 4)[:14], 8)]


def _scfg(**kw):
    return dict(num_slots=3, block_size=8, prefill_chunk=8, **kw)


def _port(lora=True, **kw):
    extra = dict(lora_rank=4, max_adapters=3) if lora else {}
    return InferenceEngine(PARAMS, CFG, ServeConfig(**_scfg(**extra, **kw)),
                           device="cpu")


def _jax(lora=True, **kw):
    extra = dict(lora_rank=4, max_adapters=3) if lora else {}
    return JEngine(JPARAMS, JCFG, JServeConfig(**_scfg(**extra, **kw)))


def _reqs(cls, adapters=None):
    adapters = adapters or {}
    return [cls(u, p, max_new_tokens=m, adapter=adapters.get(u))
            for u, p, m in REQS]


# ---------------------------------------------------------------------------
# the pool, write_adapter, lora_delta


def test_pool_shapes_bytes_and_zero_base_slot():
    """The pool's leaves, shapes, device bytes and the all-zero slot 0 are
    JAX's; the row tile is decode's GEMM tile."""
    pool = init_adapter_pool(CFG, 4, 3, device="cpu")
    jp = jax_pool(JCFG, 4, 3)
    assert set(pool) == set(jp) == {f"{t}_{ab}" for t in ADAPTER_TARGETS
                                     for ab in ("a", "b")}
    for k in pool:
        assert tuple(pool[k].shape) == tuple(jp[k].shape), k
        assert not pool[k][:, 0].any()
    assert adapter_pool_bytes(CFG, 4, 3) == sum(
        v.numel() * v.element_size() for v in pool.values())
    assert adapter_pool_bytes(CFG, 4, 3, torch.bfloat16) * 2 == \
        adapter_pool_bytes(CFG, 4, 3)
    assert pad.LORA_ROW_TILE == pdec.GEMM_ROW_TILE
    with pytest.raises(ValueError, match="rank"):
        init_adapter_pool(CFG, 0, 3, device="cpu")


def test_write_adapter_folds_scale_in_place_and_guards_slot0():
    """Writing slot 1 (scale 2) gives JAX's pool bitwise, in place; slot 0
    and a slot past max_adapters refuse; a missing key or a wrong shape
    raises."""
    pool = init_adapter_pool(CFG, 4, 2, device="cpu")
    leaf = pool["qkv_b"]
    out = write_adapter(pool, 1, W1, scale=2.0)
    assert out is pool and out["qkv_b"] is leaf
    jp = jax_write_adapter(jax_pool(JCFG, 4, 2), 1, JW1, scale=2.0)
    for k in pool:
        np.testing.assert_array_equal(pool[k].numpy(), np.asarray(jp[k]))
    with pytest.raises(ValueError, match="slot 0"):
        write_adapter(pool, 0, W1)
    with pytest.raises(ValueError):
        write_adapter(pool, 3, W1)
    with pytest.raises(ValueError, match="missing"):
        write_adapter(pool, 1, {k: v for k, v in W1.items()
                                if k != "fc2_b"})
    with pytest.raises(ValueError, match="shape"):
        write_adapter(pool, 1, {**W1, "out_a": W1["out_a"][:1]})
    with pytest.raises(ValueError, match="keys"):
        adapter_weights_from_numpy({"qkv_a": np.zeros(1)}, "cpu")


def test_lora_delta_matches_jax_and_slot0_is_exact_zero():
    """The gathered BGMV on rows of three adapters (ids 1, 0, 2, 1) against
    JAX's: fp32, atol 1e-6; slot 0's rows are exactly zero."""
    pool = init_adapter_pool(CFG, 4, 2, device="cpu")
    write_adapter(pool, 1, W1, scale=1.5)
    write_adapter(pool, 2, W2)
    jp = jax_write_adapter(jax_write_adapter(jax_pool(JCFG, 4, 2), 1, JW1,
                                             scale=1.5), 2, JW2)
    x = np.random.default_rng(7).standard_normal((4, 3, 32)).astype(
        np.float32)
    ids = np.array([1, 0, 2, 1], np.int32)
    for t, d_in in (("qkv", 32), ("fc2", 128)):
        xt = np.random.default_rng(8).standard_normal(
            (4, 3, d_in)).astype(np.float32)
        got = lora_delta(torch.from_numpy(xt), pool[f"{t}_a"][0],
                         pool[f"{t}_b"][0], torch.from_numpy(ids))
        want = jax_lora_delta(jnp.asarray(xt), jp[f"{t}_a"][0],
                              jp[f"{t}_b"][0], jnp.asarray(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
        assert not got[1].any()
    zero = lora_delta(torch.from_numpy(x), pool["qkv_a"][0],
                      pool["qkv_b"][0], torch.zeros(4, dtype=torch.int32))
    assert not zero.any()


def test_lora_delta_rows_do_not_depend_on_the_batch():
    """A slot's delta rows are bitwise the same alone, among 8 slots and
    among 40 (more than one 64-row tile at q = 5): the fixed-tile
    products."""
    pool = init_adapter_pool(CFG, 4, 2, device="cpu")
    write_adapter(pool, 1, W1)
    write_adapter(pool, 2, W2)
    rng = np.random.default_rng(9)
    for q in (1, 5):
        x = torch.from_numpy(rng.standard_normal((40, q, 32)).astype(
            np.float32))
        ids = torch.from_numpy(rng.integers(0, 3, 40).astype(np.int32))
        full = lora_delta(x, pool["fc1_a"][1], pool["fc1_b"][1], ids)
        for n in (1, 8):
            part = lora_delta(x[:n], pool["fc1_a"][1], pool["fc1_b"][1],
                              ids[:n])
            assert torch.equal(part, full[:n])


def test_merge_adapter_params_and_prefill_match_merged_weights():
    """A prefill chunk through the adapter pool equals the same chunk
    through the merged weights (fp32, atol 1e-4, JAX's tolerance) and
    JAX's adapter prefill (atol 1e-5); the merged kernels equal JAX's
    (atol 1e-6)."""
    merged = merge_adapter_params(PARAMS, W1, scale=2.0)
    pool = write_adapter(init_adapter_pool(CFG, 4, 2, device="cpu"), 1, W1,
                         scale=2.0)
    toks = np.zeros(8, np.int32)
    toks[:6] = np.arange(1, 7)
    row = np.arange(8, dtype=np.int32)[:2]
    _, got = gpt_prefill_chunk(PARAMS, torch.from_numpy(toks), 0, 6,
                               init_kv_cache(KV, "cpu"),
                               torch.from_numpy(row), CFG, KV,
                               adapters=pool, adapter_id=1)
    _, want = gpt_prefill_chunk(merged, torch.from_numpy(toks), 0, 6,
                                init_kv_cache(KV, "cpu"),
                                torch.from_numpy(row), CFG, KV)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    jp = jax_write_adapter(jax_pool(JCFG, 4, 2), 1, JW1, scale=2.0)
    _, jl = jax_chunk(JPARAMS, jnp.asarray(toks), jnp.int32(0),
                      jnp.int32(6), jax_init_cache(JKVC), jnp.asarray(row),
                      JCFG, JKVC, adapters=jp, adapter_id=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    from apex_tpu.serve import merge_adapter_params as jax_merge

    jm = jax_merge(JPARAMS, JW1, scale=2.0)
    for k in ("qkv_kernel", "out_kernel", "fc1_kernel", "fc2_kernel"):
        np.testing.assert_allclose(merged["layers"][k].numpy(),
                                   np.asarray(jm["layers"][k]), atol=1e-6,
                                   rtol=0)


def test_make_adapter_weights_is_seeded():
    """The port's own random adapters: shapes, the model dtype, and one
    generator seed giving one set of weights."""
    a = make_adapter_weights(CFG, 4, torch.Generator().manual_seed(3))
    b = make_adapter_weights(CFG, 4, torch.Generator().manual_seed(3))
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
        assert tuple(a[k].shape) == tuple(W1[k].shape)


# ---------------------------------------------------------------------------
# the registry


def _registry_ops(seed, n=400):
    rng = random.Random(seed)
    names = [f"t{i}" for i in range(8)]
    return [(rng.choice(("load", "unload", "acquire", "release")),
             rng.choice(names)) for _ in range(n)]


def _apply(reg, op, name):
    try:
        out = getattr(reg, op)(name)
    except (KeyError, RuntimeError) as e:
        return type(e).__name__
    return out


@pytest.mark.parametrize("seed", [7, 8])
def test_registry_matches_jax_over_a_random_sequence(seed):
    """The same seeded load / unload / acquire / release sequence through
    both registries: the same returned slots, the same refusals, the same
    residents, refcounts and counters after every op, and consistent
    bookkeeping throughout."""
    p, j = AdapterRegistry(4), JRegistry(4)
    for op, name in _registry_ops(seed):
        assert _apply(p, op, name) == _apply(j, op, name), (op, name)
        assert p.resident() == j.resident()
        assert p.counters() == j.counters()
        p.assert_consistent()
    for name in p.resident():
        assert p.refcount(name) == j.refcount(name)
    assert (p.free_count, p.resident_count) == (j.free_count,
                                                j.resident_count)


# ---------------------------------------------------------------------------
# the adapter engine


@pytest.mark.parametrize("spec_k", [0, 3])
def test_adapter_engine_streams_match_jax(spec_k):
    """Two tenants and base traffic in one continuous batch: the port's
    greedy streams equal JAX's adapter engine's token for token, and so do
    the adapter counters."""
    adapters = {"a": "t1", "b": "t2", "d": "t1"}
    p, j = _port(spec_k=spec_k), _jax(spec_k=spec_k)
    for e, w1, w2 in ((p, W1, W2), (j, JW1, JW2)):
        assert e.load_adapter("t1", w1, scale=2.0) == 1
        assert e.load_adapter("t2", w2) == 2
    got = p.run(_reqs(Request, adapters))
    assert got == j.run(_reqs(JRequest, adapters))
    ps, js = p.stats(), j.stats()
    for k in ("adapters", "adapter_hit_rate", "adapter_evictions"):
        assert ps[k] == js[k], k
    assert ps["decode_kernel"] == "plain" and not ps["megakernel"]
    p.adapters.assert_consistent()
    assert all(p.adapters.refcount(n) == 0 for n in ("t1", "t2"))


@pytest.mark.parametrize("extra", [{}, {"spec_k": 4},
                                   {"kv_quant": "int8"},
                                   {"sampling": SamplingConfig(
                                       temperature=0.8, top_k=20,
                                       top_p=0.9)}],
                         ids=["greedy", "spec_k", "int8_kv", "sampled"])
def test_slot0_streams_bitwise_equal_engine_without_adapters(extra):
    """Base traffic on an adapter engine (an adapter loaded, none bound)
    is bitwise the engine without adapters: slot 0 adds an exact zero."""
    base = _port(lora=False, **extra).run(_reqs(Request))
    eng = _port(**extra)
    eng.load_adapter("t1", W1)
    assert eng.run(_reqs(Request)) == base


def test_multi_tenant_batch_no_cross_contamination():
    """t1, t2 and base interleaved in one batch: each stream equals its
    request served alone on the same engine setup, and a t1 stream equals
    the merged-weight engine's (greedy, fp32)."""
    adapters = {"a": "t1", "b": "t2", "d": "t1"}
    eng = _port()
    eng.load_adapter("t1", W1, scale=2.0)
    eng.load_adapter("t2", W2)
    mixed = eng.run(_reqs(Request, adapters))
    for u, prompt, m in REQS:
        solo = _port()
        solo.load_adapter("t1", W1, scale=2.0)
        solo.load_adapter("t2", W2)
        got = solo.run([Request(u, prompt, max_new_tokens=m,
                                adapter=adapters.get(u))])
        assert got[u] == mixed[u], u
    merged = InferenceEngine(merge_adapter_params(PARAMS, W1, scale=2.0),
                             CFG, ServeConfig(**_scfg()), device="cpu")
    assert merged.run([Request("a", REQS[0][1], max_new_tokens=6)])["a"] \
        == mixed["a"]


def test_spec_streams_equal_plain_streams_under_adapters():
    """Speculative decode with adapter traffic gives the non-speculative
    streams (per-row math, fixed tiles)."""
    adapters = {"a": "t1", "c": "t2", "d": "t2"}
    outs = []
    for k in (0, 4):
        eng = _port(spec_k=k)
        eng.load_adapter("t1", W1, scale=2.0)
        eng.load_adapter("t2", W2)
        outs.append(eng.run(_reqs(Request, adapters)))
    assert outs[0] == outs[1]


def test_unknown_adapter_sheds_or_raises_and_eviction_keeps_binding():
    """An adapter that is not resident is shed through on_reject (with an
    event) or raises; an adapter-bound request evicted and restored keeps
    its stream; LRU load pressure evicts an idle adapter; unloading a
    pinned one refuses."""
    from apex_tpu_torch.monitor import EventLog

    shed = []
    ev = EventLog(keep=True)
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(**_scfg(
        lora_rank=4, max_adapters=1)), device="cpu", events=ev,
        on_reject=lambda r, info: shed.append((r.uid, info["reason"])))
    eng.load_adapter("t1", W1)
    out = eng.run([Request("x", [1, 2, 3], max_new_tokens=3,
                           adapter="nope"),
                   Request("y", [1, 2, 3], max_new_tokens=3, adapter="t1")])
    assert shed == [("x", "unknown_adapter")] and list(out) == ["y"]
    assert any(r.get("event") == "shed" for r in ev.records)
    assert any(r.get("event") == "adapter_load" for r in ev.records)
    with pytest.raises(KeyError, match="unknown adapter"):
        _port().run([Request("z", [1, 2], max_new_tokens=2,
                             adapter="nope")])
    with pytest.raises(ValueError, match="adapters are disabled"):
        _port(lora=False).submit(Request("z", [1], adapter="t1"))
    # evict + restore an adapter-bound request
    ref = _port()
    ref.load_adapter("t1", W1, scale=2.0)
    want = ref.run([Request("a", REQS[0][1], max_new_tokens=8,
                            adapter="t1")])
    e2 = _port()
    e2.load_adapter("t1", W1, scale=2.0)
    e2.submit(Request("a", REQS[0][1], max_new_tokens=8, adapter="t1"))
    while not (e2._active.any() and len(e2._slots[0].generated) >= 3):
        e2.step()
    rec = e2.evict_slot("a")
    assert rec["adapter"] == "t1" and e2.adapters.refcount("t1") == 0
    e2.restore_slot(rec)
    assert e2.adapters.refcount("t1") == 1
    with pytest.raises(RuntimeError, match="decoding slot"):
        e2.unload_adapter("t1")
    while e2.active:
        e2.step()
    assert e2.finished == want
    e2.load_adapter("t2", W2)
    e2.load_adapter("t3", W1)
    e2.load_adapter("t4", W2)      # pool full: evicts idle t1 (LRU)
    assert e2.adapters.lookup("t1") is None
    assert e2.stats()["adapter_evictions"] == 1


def test_megakernel_and_pallas_refusals_name_their_reasons():
    """megakernel='on' with adapters or a gather_layer hook raises with
    JAX's reason; 'auto' on the CPU takes the per-op path quietly;
    use_pallas=True on a CPU engine raises; use_pallas=False reports the
    plain versions."""
    with pytest.raises(ValueError, match="LoRA adapters"):
        _port(megakernel="on")
    with pytest.raises(ValueError, match="FSDP"):
        InferenceEngine(PARAMS, CFG, ServeConfig(**_scfg(megakernel="on")),
                        device="cpu", gather_layer=lambda lp: lp)
    assert not _port(megakernel="auto").megakernel_enabled
    with pytest.raises(ValueError, match="use_pallas=True"):
        InferenceEngine(PARAMS, CFG, ServeConfig(**_scfg()), device="cpu",
                        use_pallas=True)
    e = InferenceEngine(PARAMS, CFG, ServeConfig(**_scfg()), device="cpu",
                        use_pallas=False)
    assert e.decode_kernel == "plain"


def test_gather_layer_hook_sees_every_layer():
    """gather_layer is applied to each layer's dict before use (an
    identity hook leaves the streams unchanged)."""
    seen = []

    def hook(lp):
        seen.append(lp["qkv_kernel"].shape)
        return lp

    base = _port(lora=False).run(_reqs(Request))
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(**_scfg()),
                          device="cpu", gather_layer=hook)
    assert eng.run(_reqs(Request)) == base
    assert seen and len(seen) % CFG.num_layers == 0


def test_prefix_cache_never_crosses_adapters():
    """One prompt of three full blocks served on the base model, on t1,
    on the base model again and on t1 after t1 was reloaded with other
    weights, in one engine with the prefix cache: every stream equals its
    own oracle (the engine without adapters; the merged-weight engines),
    and only same-weights requests hit the cache. (JAX's engine hashes
    tokens alone: there the base request would reuse t1's blocks.)"""
    prompt = list(range(3, 27))
    eng = _port()
    eng.load_adapter("t1", W1, scale=2.0)
    got = {}
    for uid, adapter in (("base", None), ("t1", "t1"), ("base2", None),
                         ("t1b", "t1")):
        got[uid] = eng.run([Request(uid, prompt, max_new_tokens=6,
                                    adapter=adapter)])[uid]
    hits = eng.stats()["prefix_cache"]["blocks_hit"]
    eng.load_adapter("t1", W2)
    got["t1_reloaded"] = eng.run([Request("t1r", prompt, max_new_tokens=6,
                                          adapter="t1")])["t1r"]
    assert eng.stats()["prefix_cache"]["blocks_hit"] == hits == 6
    base = _port(lora=False).run([Request("x", prompt,
                                          max_new_tokens=6)])["x"]

    def merged(w, scale):
        return InferenceEngine(merge_adapter_params(PARAMS, w, scale=scale),
                               CFG, ServeConfig(**_scfg()),
                               device="cpu").run(
            [Request("x", prompt, max_new_tokens=6)])["x"]

    assert got["base"] == got["base2"] == base
    assert got["t1"] == got["t1b"] == merged(W1, 2.0)
    assert got["t1_reloaded"] == merged(W2, 1.0)
    assert got["t1"] != base
