"""apex_tpu_torch.serve on the CPU, against apex_tpu.serve.

Tiny GPT (vocab 256, hidden 128, 2 layers, 4 heads, max_seq 128, fp32).
JAX params are drawn by ``apex_tpu``'s ``init_gpt_params`` and carried
across with ``params_from_numpy``; both engines run their default
single-device paths (XLA reference attention on the JAX side, the plain
PyTorch versions of the kernels on the port's).
"""

import collections

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from apex_tpu.serve import BlockAllocator as JAlloc
from apex_tpu.serve import InferenceEngine as JEngine
from apex_tpu.serve import KVCacheConfig as JKV
from apex_tpu.serve import NGramDrafter as JDrafter
from apex_tpu.serve import Request as JRequest
from apex_tpu.serve import ServeConfig as JServeConfig
from apex_tpu.serve import copy_block as jax_copy_block
from apex_tpu.serve import gather_kv as jax_gather
from apex_tpu.serve import init_kv_cache as jax_init_cache
from apex_tpu.serve import kv_cache_bytes as jax_cache_bytes
from apex_tpu.serve import kv_read_bytes as jax_read_bytes
from apex_tpu.serve import kv_write_bytes_per_token as jax_write_bytes
from apex_tpu.serve import paged_write as jax_write
from apex_tpu.serve import prefix_block_hashes as jax_hashes
from apex_tpu.serve.decode import gpt_decode_step as jax_decode
from apex_tpu.serve.decode import gpt_prefill_chunk as jax_chunk
from apex_tpu.serve.decode import gpt_verify_step as jax_verify
from apex_tpu.serve.sampling import _top_k_mask as jax_top_k
from apex_tpu.serve.sampling import _top_p_mask as jax_top_p
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.monitor.hist import DEFAULT_LATENCY_SPEC as JSPEC
from apex_tpu.monitor.hist import HistSpec as JHistSpec
from apex_tpu.monitor.hist import Histogram as JHistogram
from apex_tpu.monitor.hist import bucket_indices as jax_bucket_indices
from apex_tpu.monitor.hist import hist_counts as jax_hist_counts
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.monitor.hist import (DEFAULT_LATENCY_SPEC, HistSpec,
                                         Histogram, bucket_indices,
                                         hist_counts)
from apex_tpu_torch.serve import (BlockAllocator, InferenceEngine,
                                  KVCacheConfig, NGramDrafter, Request,
                                  SamplingConfig, ServeConfig, copy_block,
                                  gather_kv, gpt_decode_step,
                                  gpt_prefill_chunk, gpt_verify_step,
                                  init_kv_cache, kv_cache_bytes,
                                  kv_read_bytes, kv_write_bytes_per_token,
                                  paged_write, prefix_block_hashes, sample)
from apex_tpu_torch.serve.sampling import _top_k_mask, _top_p_mask
from apex_tpu_torch.transformer.testing import GPTConfig

JCFG = JGPTConfig(vocab_size=256, max_seq=128, hidden=128, num_layers=2,
                  num_heads=4, dtype=jnp.float32, fused_loss=False)
CFG = GPTConfig(vocab_size=256, max_seq=128, hidden=128, num_layers=2,
                num_heads=4, dtype=torch.float32)
JPARAMS = jax_init(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _kv_pair(num_layers=1, heads=2, hd=8, blocks=6, bs=4):
    j = JKV(num_layers=num_layers, num_heads=heads, head_dim=hd,
            num_blocks=blocks, block_size=bs, dtype=jnp.float32)
    p = KVCacheConfig(num_layers=num_layers, num_heads=heads, head_dim=hd,
                      num_blocks=blocks, block_size=bs, dtype=torch.float32)
    return j, p


# ---------------------------------------------------------------------------
# kv_cache


def test_paged_write_gather_matches_jax():
    """Scattered block tables, a partial block, invalid rows and a position
    past the row's blocks: the pools and the gathered K/V equal JAX's
    exactly (the port's trash block holds what JAX dropped)."""
    jcfg, cfg = _kv_pair()
    rng = np.random.default_rng(0)
    n = 9
    k = rng.standard_normal((2, n, 8)).astype(np.float32)
    v = rng.standard_normal((2, n, 8)).astype(np.float32)
    rows = np.array([[5, 2, 0]] * 7 + [[1, 3, 4]] * 2, np.int32)
    pos = np.array([0, 1, 2, 3, 4, 5, 6, 2, 12], np.int32)  # 12: past mb*bs
    valid = np.array([1, 1, 0, 1, 1, 1, 1, 1, 1], bool)
    jl = {kk: vv[0] for kk, vv in jax_init_cache(jcfg).items()}
    jl = jax_write(jl, jcfg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows),
                   jnp.asarray(pos), jnp.asarray(valid))
    pc = init_kv_cache(cfg, "cpu")
    pl = {kk: vv[0] for kk, vv in pc.items()}
    paged_write(pl, cfg, _t(k), _t(v), _t(rows), _t(pos), _t(valid))
    for name in ("k", "v"):
        np.testing.assert_array_equal(pc[name][0, :, :6].numpy(),
                                      np.asarray(jl[name]))
    tables = np.array([[5, 2, 0], [1, 3, 4]], np.int32)
    jk, jv = jax_gather(jl, jcfg, jnp.asarray(tables))
    gk, gv = gather_kv(pl, cfg, _t(tables))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


def test_copy_block_matches_jax():
    jcfg, cfg = _kv_pair(num_layers=2)
    rng = np.random.default_rng(1)
    jc = {kk: jnp.asarray(rng.standard_normal(vv.shape).astype(np.float32))
          for kk, vv in jax_init_cache(jcfg).items()}
    pc = init_kv_cache(cfg, "cpu")
    for kk in pc:
        pc[kk][:, :, :6] = _t(jc[kk])
    jc = jax_copy_block(jc, 4, 1)
    copy_block(pc, 4, 1)
    for kk in pc:
        np.testing.assert_array_equal(pc[kk][:, :, :6].numpy(),
                                      np.asarray(jc[kk]))


def test_kv_byte_models_match_jax():
    j = JKV(num_layers=2, num_heads=4, head_dim=8, num_blocks=10,
            block_size=4, dtype=jnp.bfloat16)
    p = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8, num_blocks=10,
                      block_size=4, dtype=torch.bfloat16)
    assert kv_cache_bytes(p) == jax_cache_bytes(j)
    assert kv_write_bytes_per_token(p) == jax_write_bytes(j)
    assert kv_read_bytes(p, [5, 0, 9]) == jax_read_bytes(j, [5, 0, 9])


def test_prefix_hashes_match_jax():
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 50000, 70).tolist()
    for bs in (4, 16):
        assert prefix_block_hashes(toks, bs) == jax_hashes(toks, bs)


def test_block_allocator_matches_jax():
    """The same random alloc/free/lookup/commit sequence on both
    allocators: same ids, refcounts, free/cached counts and evictions."""
    rng = np.random.default_rng(3)
    ja, pa = JAlloc(12, prefix_cache=True), BlockAllocator(12,
                                                           prefix_cache=True)
    held = []              # block lists currently owned
    hashes = [hash(("h", i)) for i in range(8)]
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(0, 5))
            a, b = ja.alloc(n), pa.alloc(n)
            assert a == b
            if a:
                held.append(a)
        elif op == 1 and held:
            ids = held.pop(int(rng.integers(0, len(held))))
            ja.free(ids)
            pa.free(ids)
        elif op == 2:
            hs = hashes[:int(rng.integers(1, 5))]
            a, b = ja.lookup(hs), pa.lookup(hs)
            assert a == b
            if a:
                held.append(a)
        elif op == 3 and held:
            blk = held[int(rng.integers(0, len(held)))][0]
            h = hashes[int(rng.integers(0, len(hashes)))]
            assert ja.commit(blk, h) == pa.commit(blk, h)
        assert ja.free_count == pa.free_count
        assert ja.cached_count == pa.cached_count
        assert ja.blocks_evicted_total == pa.blocks_evicted_total
        assert ja.blocks_reused_total == pa.blocks_reused_total
        assert all(ja.refcount(b) == pa.refcount(b) for b in range(12))
        pa.assert_consistent()
    assert pa.blocks_evicted_total > 0 and pa.blocks_reused_total > 0
    with pytest.raises(ValueError):
        pa.free([99])


# ---------------------------------------------------------------------------
# serve programs


def _program_sequence():
    """The same three serve calls on both packages: a prefill chunk per
    slot, one decode step (one slot idle), one verify step. Yields
    (stage, jax logits, port logits, rows to compare) and finally the
    two caches."""
    jkv = JKV(num_layers=2, num_heads=4, head_dim=32, num_blocks=12,
              block_size=8, dtype=jnp.float32)
    kv = KVCacheConfig(num_layers=2, num_heads=4, head_dim=32, num_blocks=12,
                       block_size=8, dtype=torch.float32)
    rng = np.random.default_rng(4)
    tables = rng.permutation(12).reshape(2, 6).astype(np.int32)
    jc, pc = jax_init_cache(jkv), init_kv_cache(kv, "cpu")
    lens = [11, 6]
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in lens]
    for s, p in enumerate(prompts):
        for c in range(0, len(p), 8):
            part = p[c:c + 8]
            chunk = np.zeros(8, np.int32)
            chunk[:len(part)] = part
            jc, jl = jax_chunk(JPARAMS, jnp.asarray(chunk), c, len(part), jc,
                               jnp.asarray(tables[s]), JCFG, jkv)
            pc, pl = gpt_prefill_chunk(PARAMS, _t(chunk), c, len(part), pc,
                                       _t(tables[s]), CFG, kv)
            yield "chunk", np.asarray(jl)[None], pl.numpy()[None], [0]
    last = np.array([3, 7], np.int32)
    seq = np.array(lens, np.int32)
    active = np.array([True, False])
    jc, jl = jax_decode(JPARAMS, jnp.asarray(last), jnp.asarray(seq),
                        jnp.asarray(active), jc, jnp.asarray(tables), JCFG,
                        jkv)
    pc, pl = gpt_decode_step(PARAMS, _t(last), _t(seq), _t(active), pc,
                             _t(tables), CFG, kv)
    yield "decode", np.asarray(jl), pl.numpy(), [0]
    seq = seq + np.array([1, 0], np.int32)
    fed = rng.integers(0, 256, (2, 4)).astype(np.int32)
    n_fed = np.array([4, 2], np.int32)
    active = np.array([True, True])
    jc, jl = jax_verify(JPARAMS, jnp.asarray(fed), jnp.asarray(seq),
                        jnp.asarray(n_fed), jnp.asarray(active), jc,
                        jnp.asarray(tables), JCFG, jkv)
    pc, pl = gpt_verify_step(PARAMS, _t(fed), _t(seq), _t(n_fed), _t(active),
                             pc, _t(tables), CFG, kv)
    jl, pl = np.asarray(jl), pl.numpy()
    # compare the valid (slot, position) rows only: padding is junk
    yield "verify", jl[0], pl[0], list(range(4))
    yield "verify", jl[1], pl[1], list(range(2))
    yield "cache", jc, pc, None


@pytest.mark.parametrize("stage", ["chunk", "decode", "verify", "cache"])
def test_gpt_paged_forward_matches_jax(stage):
    """Logits of the prefill chunk (q=chunk), decode (q=1) and verify
    (q=k+1) programs vs JAX on the same weights and cache state: atol
    1e-4 (fp32 matmuls in two libraries). The pools after the sequence:
    atol 1e-5, with every position JAX dropped untouched in the port."""
    seen = 0
    for name, jl, pl, rows in _program_sequence():
        if name != stage:
            continue
        seen += 1
        if name == "cache":
            for kk in ("k", "v"):
                np.testing.assert_allclose(pl[kk][:, :, :12].numpy(),
                                           np.asarray(jl[kk]), atol=1e-5,
                                           rtol=0)
            continue
        assert np.isfinite(pl).all()
        np.testing.assert_allclose(pl[rows], jl[rows], atol=1e-4, rtol=0)
    assert seen


# ---------------------------------------------------------------------------
# engine


def _workload(seed=5):
    """Mixed prompt lengths; later requests share a 16-token prefix (two
    full blocks at block_size 8), one is exactly that prefix (a full hit:
    copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, 16).tolist()
    prompts = [prefix + rng.integers(0, 256, 5).tolist(),
               rng.integers(0, 256, 3).tolist(),
               rng.integers(0, 256, 30).tolist(),
               prefix + rng.integers(0, 256, 9).tolist(),
               list(prefix),
               prefix + rng.integers(0, 256, 1).tolist(),
               rng.integers(0, 256, 17).tolist()]
    return [(f"r{i}", p, 6 + i % 3) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_greedy_streams_match_jax(spec_k):
    """Greedy streams token for token equal to the JAX engine's, through
    chunked prefill, prefix hits, copy-on-write and speculative verify."""
    work = _workload()
    scfg = dict(num_slots=2, block_size=8, prefill_chunk=8, spec_k=spec_k)
    jeng = JEngine(JPARAMS, JCFG, JServeConfig(**scfg))
    want = jeng.run([JRequest(u, p, max_new_tokens=m) for u, p, m in work])
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(**scfg), device="cpu")
    got = eng.run([Request(u, p, max_new_tokens=m) for u, p, m in work])
    assert got == want
    st = eng.stats()
    jst = jeng.stats()
    assert st["prefix_cache"]["blocks_hit"] > 0
    assert st["prefix_cache"]["cow_copies"] >= 1
    for key in ("blocks_hit", "blocks_needed", "tokens_saved",
                "cow_copies"):
        assert st["prefix_cache"][key] == jst["prefix_cache"][key], key
    assert st["completed"] == len(work) and st["decode_kernel"] == "plain"
    if spec_k:
        assert st["speculative"]["verify_steps"] > 0
        assert (st["speculative"]["accepted"]
                == jst["speculative"]["accepted"])
    eng.allocator.assert_consistent()


SAMPLED = SamplingConfig(temperature=0.9, top_k=40, top_p=0.95)


def _sampled_run(order, spec_k=0, num_slots=3):
    work = _workload(seed=6)
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(
        num_slots=num_slots, block_size=8, prefill_chunk=8, spec_k=spec_k,
        sampling=SAMPLED), device="cpu", base_seed=11)
    return eng.run([Request(*work[i][:2], max_new_tokens=8) for i in order])


def test_sampled_streams_request_order_invariant():
    """A draw depends only on (request, position): any admission order and
    slot count gives the same sampled streams."""
    a = _sampled_run(range(7))
    b = _sampled_run([6, 2, 4, 0, 5, 1, 3], num_slots=2)
    assert a == b
    assert len({tuple(s) for s in a.values()}) > 1


def test_sampled_spec_equals_nonspec():
    """Speculative verify keeps exactly the draws plain decode makes."""
    assert _sampled_run(range(7), spec_k=3) == _sampled_run(range(7))


def test_sampling_distribution_matches_softmax():
    """Gumbel-max draws over many (key, position) pairs at one fixed logit
    row: chi-square against softmax(logits / T), p > 1e-3 (fixed seed)."""
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    n = 40000
    keys = torch.arange(n, dtype=torch.int64) % 97
    pos = torch.arange(n, dtype=torch.int64) // 97
    cfg = SamplingConfig(temperature=0.8)
    toks = sample(logits.expand(n, 12), keys, pos, cfg).numpy()
    counts = np.bincount(toks, minlength=12)
    probs = torch.softmax(logits / 0.8, dim=0).double().numpy()
    expected = probs / probs.sum() * counts.sum()
    p_value = stats.chisquare(counts, expected).pvalue
    assert p_value > 1e-3, (counts, expected)


def test_sampling_filters_match_jax():
    """Greedy argmax and the top-k / top-p masks equal JAX's exactly."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    x[0, 3] = x[0, 9] = x[0].max() + 1          # a tie: first index wins
    np.testing.assert_array_equal(
        _top_k_mask(_t(x), 7).numpy(), np.asarray(jax_top_k(jnp.asarray(x),
                                                            7)))
    np.testing.assert_array_equal(
        _top_p_mask(_t(x), 0.8).numpy(),
        np.asarray(jax_top_p(jnp.asarray(x), 0.8)))
    greedy = sample(_t(x), torch.zeros(5, dtype=torch.int64),
                    torch.zeros(5, dtype=torch.int64), SamplingConfig())
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jnp.argmax(x, axis=-1)))
    assert greedy[0] == 3


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(9)
    jd, pd = JDrafter(ngram=2), NGramDrafter(ngram=2)
    for _ in range(50):
        hist = rng.integers(0, 5, int(rng.integers(0, 30))).tolist()
        k = int(rng.integers(0, 5))
        assert pd.propose(hist, k) == jd.propose(hist, k)


@pytest.mark.parametrize("field,value", [
    ("lora_rank", 4), ("plan", object())])
def test_serve_config_refuses_unported_fields(field, value):
    """Both are ported and validate as JAX's do: a plan that is not a
    ``ParallelismPlan`` raises JAX's ValueError (plan-sharded serving,
    ``serve.sharded``, takes a real one); lora_rank > 0 without
    max_adapters, or max_adapters without a rank, raises JAX's ValueError,
    both together pass. None is silently ignored."""
    kw = {field: value}
    if field == "lora_rank":
        for bad, msg in (({"lora_rank": value}, "needs max_adapters"),
                         ({"max_adapters": 1}, "needs lora_rank"),
                         ({"lora_rank": -1}, "lora_rank must be")):
            with pytest.raises(ValueError, match=msg):
                ServeConfig(**bad).validate()
            with pytest.raises(ValueError, match=msg):
                JServeConfig(**bad).validate()
        ServeConfig(lora_rank=value, max_adapters=1).validate()
    else:
        with pytest.raises(ValueError, match="must be a ParallelismPlan"):
            ServeConfig(**kw).validate()
        with pytest.raises(ValueError, match="must be a ParallelismPlan"):
            JServeConfig(**kw).validate()
    ServeConfig(megakernel="auto").validate()
    ServeConfig(megakernel="off").validate()


def test_engine_device_rule():
    """Without CUDA, an engine that was not asked for the CPU raises; the
    params must live where the engine does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(PARAMS, CFG, ServeConfig())
    meta = params_from_numpy({"embed": {"tok": np.zeros((2, 2))}}, "cpu")
    meta["embed"]["tok"] = meta["embed"]["tok"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        InferenceEngine(meta, CFG, ServeConfig(), device="cpu")


def test_engine_stall_raises_and_on_reject_sheds():
    """A request the pool can never hold: run() raises, or with on_reject
    the request is handed back and the rest are served."""
    scfg = ServeConfig(num_slots=2, block_size=8, num_blocks=3,
                       prefill_chunk=8)
    big = Request("big", list(range(40)), max_new_tokens=4)
    small = Request("small", [1, 2, 3], max_new_tokens=3)
    with pytest.raises(RuntimeError, match="stalled"):
        InferenceEngine(PARAMS, CFG, scfg, device="cpu").run([big, small])
    shed = []
    eng = InferenceEngine(PARAMS, CFG, scfg, device="cpu",
                          on_reject=lambda r, info: shed.append(
                              (r.uid, info["reason"])))
    out = eng.run([big, small])
    assert shed == [("big", "pool_exhausted")]
    assert list(out) == ["small"] and len(out["small"]) == 3
    assert eng.stats()["rejected"] == 1


def test_engine_eos_retain_and_stats():
    """EOS retires early; retain_streams=False hands streams to on_retire;
    stats() carries counts and the histograms' quantiles."""
    work = _workload()
    ref = InferenceEngine(PARAMS, CFG, ServeConfig(
        num_slots=2, block_size=8, prefill_chunk=8), device="cpu").run(
        [Request(u, p, max_new_tokens=m) for u, p, m in work])
    eos = ref["r2"][2]
    got = {}
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(
        num_slots=2, block_size=8, prefill_chunk=8, eos_id=eos),
        device="cpu", retain_streams=False,
        on_retire=lambda uid, toks: got.__setitem__(uid, toks))
    assert eng.run([Request(u, p, max_new_tokens=m)
                    for u, p, m in work]) == {}
    assert got["r2"] == ref["r2"][:ref["r2"].index(eos) + 1]
    st = eng.stats()
    assert st["completed"] == len(work)
    assert st["generated_tokens"] == sum(len(s) for s in got.values())
    for key in ("ttft_ms_p50", "ttft_ms_p99", "decode_step_ms_p50",
                "decode_step_ms_p99"):
        assert st[key] > 0
    assert st["prefill"]["chunks_run"] > 0
    counts = collections.Counter(eng.transfer_counts)
    assert counts["keys"] <= len(work)           # uploaded on change only


# ---------------------------------------------------------------------------
# bounded latency records: histograms and the O(slots) leak gate


def test_engine_state_stays_o_slots():
    """JAX's leak gate (``tests/test_serve.py``): with retain_streams=False,
    per-request state after 10x slot-count requests is zero — retirement
    folded every timeline into the constant-size histograms and dropped
    the per-uid entries; the streams equal a retained run's."""
    n_slots = 3
    scfg = ServeConfig(num_slots=n_slots, block_size=8, prefill_chunk=8)
    got = {}
    eng = InferenceEngine(PARAMS, CFG, scfg, device="cpu",
                          retain_streams=False,
                          on_retire=lambda uid, toks: got.__setitem__(
                              uid, toks))
    n = 10 * n_slots
    reqs = [Request(f"r{i:03d}", [1 + i % 7, 2, 3], max_new_tokens=3)
            for i in range(n)]
    out = eng.run(reqs)
    assert out == {}                       # streams not retained...
    assert len(got) == n                   # ...but delivered via callback
    assert eng.per_request_state_count() == 0
    assert eng.hists["ttft_ms"].total == n
    assert eng.hists["e2e_ms"].total == n
    assert eng.hists["tpot_ms"].total == n
    # no container of the engine grows with requests or steps: each holds
    # at most one entry per slot or per fixed name
    sizes = {k: len(v) for k, v in vars(eng).items()
             if isinstance(v, (list, dict, collections.deque))}
    assert max(sizes.values()) <= 6, sizes
    st = eng.stats()
    assert st["completed"] == n and st["ttft_ms_p99"] > 0
    base = InferenceEngine(PARAMS, CFG, scfg, device="cpu").run(reqs)
    assert got == base


def test_engine_stats_quantiles_come_from_the_histograms():
    """stats()' p50/p99 are the histograms' quantiles rounded to 3 places
    (JAX's ``stats()``), one pair per dimension recorded; with speculation
    the verify steps get their own dimension and also count as engine
    steps in decode_step_ms."""
    reqs = [Request(f"s{i}", [5, 6, 7, 5, 6, 7, 5, 6], max_new_tokens=6)
            for i in range(4)]
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(
        num_slots=2, block_size=8, prefill_chunk=8, spec_k=2), device="cpu")
    eng.run(reqs)
    st = eng.stats()
    assert eng.hists["verify_step_ms"].total > 0
    assert (eng.hists["decode_step_ms"].total
            == st["speculative"]["decode_steps"]
            + st["speculative"]["verify_steps"])
    assert eng.hists["verify_step_ms"].total == st["speculative"][
        "verify_steps"]
    for name, h in eng.hists.items():
        assert st[f"{name}_p50"] == round(h.quantile(0.5), 3)
        assert st[f"{name}_p99"] == round(h.quantile(0.99), 3)


@pytest.mark.parametrize("spec", [None, (0.5, 1e4, 1.05)])
def test_histogram_matches_jax_bit_for_bit(spec):
    """The port's ``monitor.hist`` gives JAX's ``Histogram`` quantiles,
    counts, mean and JSON dump bit for bit on the same values (the
    default latency ladder and a finer one), merge included; the
    torch bucket indices and count vector equal JAX's in-graph ones."""
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.lognormal(2.0, 1.5, 500), [0.0, -1.0, 1e9,
                                                           0.01, 6e5]])
    ours = Histogram(None if spec is None else HistSpec(*spec))
    theirs = JHistogram(None if spec is None else JHistSpec(*spec))
    if spec is None:
        assert ours.spec.to_dict() == JSPEC.to_dict()
        assert DEFAULT_LATENCY_SPEC.num_buckets == JSPEC.num_buckets
    for chunk in np.array_split(vals, 7):
        ours.add(chunk)
        theirs.add(chunk)
    np.testing.assert_array_equal(ours.counts, theirs.counts)
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    assert ours.quantiles(qs) == theirs.quantiles(qs)
    assert ours.mean() == theirs.mean()
    assert ours.to_dict() == theirs.to_dict()
    merged = ours.merge(Histogram.from_dict(ours.to_dict()))
    jmerged = theirs.merge(JHistogram.from_dict(theirs.to_dict()))
    assert merged.quantiles(qs) == jmerged.quantiles(qs)
    jspec = theirs.spec
    np.testing.assert_array_equal(
        bucket_indices(torch.tensor(vals, dtype=torch.float32),
                       ours.spec).numpy(),
        np.asarray(jax_bucket_indices(jnp.asarray(vals, jnp.float32),
                                      jspec)))
    valid = rng.random(vals.shape) < 0.7
    np.testing.assert_array_equal(
        hist_counts(torch.tensor(vals, dtype=torch.float32), ours.spec,
                    valid=torch.tensor(valid)).numpy(),
        np.asarray(jax_hist_counts(jnp.asarray(vals, jnp.float32), jspec,
                                   valid=jnp.asarray(valid))))
