"""fp16 serving and the fp16 codec (ROADMAP C6), the port against apex_tpu
on the CPU.

JAX's paged attention, fused decode layer and codec compute fp16 in
interpret mode; the port's plain versions (what its wrappers run for CPU
tensors, and what the card's fp16 kernels are held to) take the same fp16
inputs from numpy seeds. Gates, bf16's (as the training kernels' fp16
cases are held): paged attention atol 1e-3 (fp pools) or 1e-2 (quantized
pools) + rtol 2**-7 (JAX rounds p to fp16 before P·V, the plain version
keeps it fp32); the fused layer and the serve programs' logits atol 2e-2
+ rtol 2**-6 (the fused layer's bf16 gate); codes and scales bitwise
(fp16 -> fp32 is exact and both sides then run the same fp32
operations).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.comm import quantize as jq
from apex_tpu.serve import KVCacheConfig as JKV
from apex_tpu.serve import init_kv_cache as jax_init_cache
from apex_tpu.serve import paged_attention as jax_paged
from apex_tpu.serve import paged_write as jax_write
from apex_tpu.serve.decode import gpt_decode_step as jax_decode
from apex_tpu.serve.decode import gpt_prefill_chunk as jax_chunk
from apex_tpu.serve.decode import gpt_verify_step as jax_verify
from apex_tpu.serve.megakernel import fused_layer_decode as jax_layer_decode
from apex_tpu.serve.megakernel import gpt_decode_step_fused as jax_decode_f
from apex_tpu.serve.megakernel import gpt_verify_step_fused as jax_verify_f
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.comm import quantize as pq
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.serve import (InferenceEngine, KVCacheConfig, Request,
                                  ServeConfig, fused_layer_decode,
                                  gpt_decode_step, gpt_decode_step_fused,
                                  gpt_prefill_chunk, gpt_verify_step,
                                  gpt_verify_step_fused, init_kv_cache,
                                  megakernel_refusal, paged_attention,
                                  paged_write)
from apex_tpu_torch.serve import decode as dec
from apex_tpu_torch.transformer.testing import GPTConfig

H, JH = torch.float16, jnp.float16
POOLS = {"none": {}, "int8": dict(quantized=True, bits=8),
         "int4": dict(quantized=True, bits=4)}
# the bf16 gates the fp16 cases are held to
PAGED_GATE = {"none": (1e-3, 2 ** -7), "int8": (1e-2, 2 ** -7),
              "int4": (1e-2, 2 ** -7)}
LAYER_GATE = (2e-2, 2 ** -6)

JCFG = JGPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                  num_heads=4, dtype=JH, fused_loss=False)
CFG = GPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                num_heads=4, dtype=H)
JPARAMS = jax_init(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, gate, what=""):
    atol, rtol = gate
    np.testing.assert_allclose(got.float().numpy(), _np32(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _kv_pair(mode, num_layers=1, heads=2, hd=8, blocks=12, bs=4):
    kw = dict(num_layers=num_layers, num_heads=heads, head_dim=hd,
              num_blocks=blocks, block_size=bs, **POOLS[mode])
    return JKV(dtype=JH, **kw), KVCacheConfig(dtype=H, **kw)


# ---------------------------------------------------------------------------
# paged attention (#19)


@pytest.mark.parametrize("mode", list(POOLS))
def test_fp16_paged_attention_matches_jax_kernel(mode):
    """The port's plain version and its split emulation (the kernels'
    walk) on fp16 q and pools both sides wrote through their own paged
    writes, against JAX's Pallas kernel in interpret mode; fp16 out on
    both sides; a ctx == 0 row is zeros."""
    heads, hd, bs, blocks = 2, 16, 4, 12
    jcfg, cfg = _kv_pair(mode, heads=heads, hd=hd, blocks=blocks, bs=bs)
    rng = np.random.default_rng(5)
    n_tok = blocks * bs
    k = rng.standard_normal((heads, n_tok, hd)).astype(np.float16)
    v = rng.standard_normal((heads, n_tok, hd)).astype(np.float16)
    perm = rng.permutation(blocks).astype(np.int32)
    pos = np.arange(n_tok, dtype=np.int32)
    rows = np.tile(perm, (n_tok, 1))
    valid = np.ones(n_tok, bool)
    jl = {kk: vv[0] for kk, vv in jax_init_cache(jcfg).items()}
    jl = jax_write(jl, jcfg, jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(valid))
    pl = {kk: vv[0] for kk, vv in init_kv_cache(cfg, "cpu").items()}
    paged_write(pl, cfg, _t(k), _t(v), _t(rows), _t(pos), _t(valid))
    tables = np.stack([perm, np.roll(perm, 3), perm[::-1].copy()])
    ctx = np.array([13, 48, 0], np.int32)
    q = rng.standard_normal((3, heads, hd)).astype(np.float16)
    want = jax_paged(jnp.asarray(q), jl, jcfg, jnp.asarray(tables),
                     jnp.asarray(ctx), use_pallas=True, interpret=True)
    assert want.dtype == JH
    got = paged_attention(_t(q), pl, cfg, _t(tables), _t(ctx))
    split = dec.paged_attention_split_reference(_t(q), pl, cfg, _t(tables),
                                                _t(ctx), parts=4)
    for name, out in (("plain", got), ("split", split)):
        assert out.dtype == H, name
        _close(out[:2], np.asarray(want)[:2], PAGED_GATE[mode], name)
        assert out[2].abs().max() == 0, name


def test_fp16_routes_take_fp16_and_refuse_float64(monkeypatch):
    """The three routes take fp16 where they take bf16: paged attention on
    the tensor cores up to head dim 256 and the wide walk above, the
    fused layer's gate as a card sees it, the codec's type code and plan
    (a resident grid for stochastic rounding of a half type); float64
    raises."""
    for d in (8, 64, 136, 256):
        assert dec._paged_route(H, d) == dec._paged_route(torch.bfloat16, d)
    assert dec._paged_route(H, 320) == "paged_wide_fwd"
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        dec._paged_route(torch.float64, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mode in POOLS:
        kv = KVCacheConfig(num_layers=12, num_heads=12, head_dim=64,
                           num_blocks=64, dtype=H, **POOLS[mode])
        assert megakernel_refusal(GPTConfig(dtype=H), kv,
                                  allow_interpret=False, q=5,
                                  slots=8) is None, mode
    assert ku.dtype_code(H) == 2
    with pytest.raises(ValueError):
        ku.dtype_code(torch.float64)
    for block in (128, 256, 1024, 4096):
        for stoch in (False, True):
            assert pq._quant_plan(block, H, stoch) == \
                pq._quant_plan(block, torch.bfloat16, stoch)


# ---------------------------------------------------------------------------
# the fused layer (#20)


def _prefilled(jkv, prompts):
    """JAX prefill of ``prompts`` in fp16, one slot each; the JAX cache,
    the port's copy (one trash block appended) and the block tables."""
    bpslot = jkv.num_blocks // len(prompts)
    bt = np.arange(len(prompts) * bpslot,
                   dtype=np.int32).reshape(len(prompts), bpslot)
    from apex_tpu.serve.decode import gpt_prefill as jax_prefill
    cache = jax_init_cache(jkv)
    for s, pr in enumerate(prompts):
        toks = jnp.zeros((16,), jnp.int32).at[:len(pr)].set(jnp.asarray(pr))
        cache, _ = jax_prefill(JPARAMS, toks, jnp.int32(len(pr)), cache,
                               jnp.asarray(bt[s]), JCFG, jkv)
    port = {}
    for name, leaf in cache.items():
        a = leaf
        if a.dtype == jnp.bfloat16:   # int4 group scales
            t = torch.from_numpy(np.asarray(a.astype(jnp.float32)).copy())
            t = t.to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.asarray(a).copy())
        port[name] = torch.cat([t, torch.zeros_like(t[:, :, :1])], dim=2)
    return cache, port, bt


@pytest.mark.parametrize("mode", list(POOLS))
def test_fp16_fused_layer_matches_jax(mode):
    """One fused decode layer of an fp16 GPT against JAX's
    ``fused_layer_decode`` (interpret) on the same prefilled cache: x' and
    the emitted K/V within the bf16 gate, fp16 out."""
    kw = dict(num_layers=2, num_heads=4, head_dim=8, num_blocks=24,
              block_size=4, **POOLS[mode])
    jkv, kv = JKV(dtype=JH, **kw), KVCacheConfig(dtype=H, **kw)
    jc, pc, bt = _prefilled(jkv, [[5, 6, 7, 8, 9], [11, 12]])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32)).astype(np.float16)
    lp_j = jax.tree.map(lambda a: a[0], JPARAMS["layers"])
    lp = {k: v[0] for k, v in PARAMS["layers"].items()}
    lens = np.array([5, 2], np.int32)
    want = jax_layer_decode(jnp.asarray(x), lp_j,
                            {k: v[0] for k, v in jc.items()}, JCFG, jkv,
                            jnp.asarray(bt), jnp.asarray(lens))
    got = fused_layer_decode(_t(x), lp, {k: v[0].clone() for k, v in
                                         pc.items()}, CFG, kv, _t(bt),
                             _t(lens), _t([True, True]))
    assert got[0].dtype == H and want[0].dtype == JH
    for name, a, b in zip(("x", "k", "v"), got, want):
        _close(a, b, LAYER_GATE, name)


# ---------------------------------------------------------------------------
# the serve programs and the engine


def _programs(fused):
    """A prefill chunk per slot, one decode step (one slot idle) and one
    verify step of the fp16 GPT on both packages (``fused``: JAX's fused
    decode / verify programs and the port's); yields (stage, jax logits,
    port logits, rows to compare)."""
    kw = dict(num_layers=2, num_heads=4, head_dim=8, num_blocks=12,
              block_size=8)
    jkv, kv = JKV(dtype=JH, **kw), KVCacheConfig(dtype=H, **kw)
    rng = np.random.default_rng(4)
    tables = rng.permutation(12).reshape(2, 6).astype(np.int32)
    jc, pc = jax_init_cache(jkv), init_kv_cache(kv, "cpu")
    lens = [11, 6]
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in lens]
    for s, p in enumerate(prompts):
        for c in range(0, len(p), 8):
            part = p[c:c + 8]
            chunk = np.zeros(8, np.int32)
            chunk[:len(part)] = part
            jc, jl = jax_chunk(JPARAMS, jnp.asarray(chunk), c, len(part), jc,
                               jnp.asarray(tables[s]), JCFG, jkv)
            pc, pl = gpt_prefill_chunk(PARAMS, _t(chunk), c, len(part), pc,
                                       _t(tables[s]), CFG, kv)
            yield "chunk", np.asarray(jl)[None], pl[None], [0]
    last = np.array([3, 7], np.int32)
    seq = np.array(lens, np.int32)
    active = np.array([True, False])
    jdec, pdec = ((jax_decode_f, gpt_decode_step_fused) if fused
                  else (jax_decode, gpt_decode_step))
    jc, jl = jdec(JPARAMS, jnp.asarray(last), jnp.asarray(seq),
                  jnp.asarray(active), jc, jnp.asarray(tables), JCFG, jkv)
    pc, pl = pdec(PARAMS, _t(last), _t(seq), _t(active), pc, _t(tables),
                  CFG, kv)
    yield "decode", np.asarray(jl), pl, [0]
    seq = seq + np.array([1, 0], np.int32)
    fed = rng.integers(0, 97, (2, 4)).astype(np.int32)
    n_fed = np.array([4, 2], np.int32)
    active = np.array([True, True])
    jver, pver = ((jax_verify_f, gpt_verify_step_fused) if fused
                  else (jax_verify, gpt_verify_step))
    jc, jl = jver(JPARAMS, jnp.asarray(fed), jnp.asarray(seq),
                  jnp.asarray(n_fed), jnp.asarray(active), jc,
                  jnp.asarray(tables), JCFG, jkv)
    pc, pl = pver(PARAMS, _t(fed), _t(seq), _t(n_fed), _t(active), pc,
                  _t(tables), CFG, kv)
    yield "verify", np.asarray(jl)[0], pl[0], list(range(4))


@pytest.mark.parametrize("fused", [False, True])
def test_fp16_serve_program_logits_match_jax(fused):
    """Every step's logits (prefill chunks, decode, verify; per-op and
    fused) of an fp16 GPT within the bf16 gate of JAX's."""
    stages = 0
    for stage, jl, pl, rows in _programs(fused):
        _close(pl[rows], jl[rows], LAYER_GATE, stage)
        stages += 1
    assert stages == 5


def _engine(megakernel, spec_k=0, kv_quant="none"):
    return InferenceEngine(PARAMS, CFG, ServeConfig(
        num_slots=3, block_size=8, prefill_chunk=8, spec_k=spec_k,
        kv_quant=kv_quant, megakernel=megakernel), device="cpu")


REQS = [("a", [1, 2, 3, 4, 5], 6), ("b", [7, 8, 9], 4),
        ("c", list(range(10, 22)), 5)]


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_fp16_engine_streams_fused_per_op_and_speculative(kv_quant):
    """An fp16 engine serves: the fused layer's plain version and the
    per-op path give the same greedy streams, ``spec_k=2`` the streams of
    ``spec_k=0``, over fp, int8 and int4 pools."""
    reqs = [Request(u, p, max_new_tokens=m) for u, p, m in REQS]
    base = _engine("off", kv_quant=kv_quant).run(reqs)
    assert all(len(base[u]) == m for u, _, m in REQS)
    for mk, k in (("on", 0), ("on", 2), ("off", 2)):
        reqs = [Request(u, p, max_new_tokens=m) for u, p, m in REQS]
        assert _engine(mk, k, kv_quant).run(reqs) == base, (mk, k)


# ---------------------------------------------------------------------------
# the codec (#16-17)


def _x16(seed, rows, block):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(rows * block)
         * rng.choice([1e-3, 1.0, 30.0], rows * block)).astype(np.float16)
    x[:4] = [2.5, -2.5, 0.5, -0.5]
    x[-block:] = 0
    return x


@pytest.mark.parametrize("block", [128, 256, 512])
def test_fp16_int8_codes_bitwise_jax_kernel(block):
    """Nearest int8: the port's kernel path on the CPU (its plain version)
    gives JAX's interpret-mode codes and scales bit for bit from an fp16
    buffer, and the fp32 path's on the same values."""
    x = _x16(block, 32, block)
    jc, js = jq.quantize_blockwise(jnp.asarray(x), block, use_pallas=True)
    c, s = pq.quantize_blockwise(_t(x), block, use_pallas=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    c32, s32 = pq.quantize_blockwise(_t(x).float(), block, use_pallas=True)
    assert torch.equal(c, c32) and torch.equal(s, s32)
    back = pq.dequantize_blockwise(c, s, block, use_pallas=True)
    jback = jq.dequantize_blockwise(jc, js, block, use_pallas=True)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("group", [128, 256])
def test_fp16_int4_codes_bitwise_jax_kernel(group):
    """Nearest int4 (packed nibbles): bitwise JAX's interpret run and the
    fp32 path's."""
    x = _x16(group + 1, 32, group)
    jc, js = jq.quantize_blockwise_int4(jnp.asarray(x), group,
                                        use_pallas=True)
    c, s = pq.quantize_blockwise_int4(_t(x), group, use_pallas=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    c32, s32 = pq.quantize_blockwise_int4(_t(x).float(), group,
                                          use_pallas=True)
    assert torch.equal(c, c32) and torch.equal(s, s32)


@pytest.mark.parametrize("bits", [8, 4])
def test_fp16_stochastic_codes_floor_or_ceil(bits):
    """Stochastic rounding from fp16: each code is floor(y) or ceil(y) of
    y = x / scale, as JAX's are from its own draws and scales (within an
    ulp of the port's: JAX's stochastic kernel divides by qmax where its
    nearest one multiplies); the fp32 path's codes on the same values and
    seed."""
    block = 256
    x = _x16(bits, 32, block)
    qmax = pq.qmax_for_bits(bits)
    fn = pq.quantize_blockwise if bits == 8 else pq.quantize_blockwise_int4
    jfn = jq.quantize_blockwise if bits == 8 else jq.quantize_blockwise_int4
    c, s = fn(_t(x), block, stochastic=True, seed=11, use_pallas=True)
    jc, js = jfn(jnp.asarray(x), block, stochastic=True, seed=11,
                 use_pallas=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2 ** -23,
                               atol=0)
    if bits == 4:
        c, jc = pq.unpack_int4(c), pq.unpack_int4(_t(np.asarray(jc)))
    for codes, sc in ((c, s), (torch.as_tensor(np.asarray(jc)),
                               _t(np.asarray(js)))):
        y = _t(x).float().reshape(-1, block) / sc[:, None]
        lo = torch.clamp(torch.floor(y), -qmax, qmax).reshape(-1)
        hi = torch.clamp(torch.ceil(y), -qmax, qmax).reshape(-1)
        codes = codes.float().reshape(-1)
        assert bool(((codes == lo) | (codes == hi)).all())
    c32, _ = fn(_t(x).float(), block, stochastic=True, seed=11,
                use_pallas=True)
    if bits == 4:
        c32 = pq.unpack_int4(c32)
    assert torch.equal(c, c32)


def test_fp16_engine_takes_the_fused_layer_without_a_warning(monkeypatch,
                                                            caplog):
    """On a CUDA engine (its device and CUDA's presence simulated here)
    ``megakernel="auto"`` resolves an fp16 GPT to the fused layer, for
    fp, int8 and int4 pools, and logs no fallback (before C6 it fell back
    to the per-op path, whose prefill then refused fp16)."""
    import logging

    from apex_tpu_torch.serve import megakernel as mk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mk, "_FALLBACK_WARNED", set())
    for kv_quant in ("none", "int8", "int4"):
        eng = _engine("auto", kv_quant=kv_quant)
        eng.device = torch.device("cuda", 0)
        with caplog.at_level(logging.WARNING, logger="apex_tpu_torch.serve"):
            assert eng._resolve_megakernel() is True, kv_quant
    assert not caplog.records
