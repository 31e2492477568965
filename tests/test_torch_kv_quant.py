"""The port's quantized KV cache on the CPU, against apex_tpu.

The ``comm.quantize`` codec (int8 blockwise, int4 groups, nibble packing),
the int8/int4 pools (``paged_write``, ``gather_kv``, ``copy_block``, the
byte models), quantized paged attention (the port's plain version against
JAX's Pallas kernel in interpret mode) and greedy engine streams with
``kv_quant`` against JAX's engine. Inputs come from numpy seeds. Codes and
scales are held bitwise: both sides run the same fp32 operations (IEEE
division, round-half-to-even); attention and logits at fp32 tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.comm import quantize as jq
from apex_tpu.serve import InferenceEngine as JEngine
from apex_tpu.serve import KVCacheConfig as JKV
from apex_tpu.serve import Request as JRequest
from apex_tpu.serve import ServeConfig as JServeConfig
from apex_tpu.serve import copy_block as jax_copy_block
from apex_tpu.serve import gather_kv as jax_gather
from apex_tpu.serve import init_kv_cache as jax_init_cache
from apex_tpu.serve import kv_cache_bytes as jax_cache_bytes
from apex_tpu.serve import kv_read_bytes as jax_read_bytes
from apex_tpu.serve import kv_write_bytes_per_token as jax_write_bytes
from apex_tpu.serve import paged_attention as jax_paged
from apex_tpu.serve import paged_write as jax_write
from apex_tpu.serve.decode import _nibble_dequant as jax_nibble_dequant
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.comm import quantize as pq
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.serve import (InferenceEngine, KVCacheConfig, Request,
                                  ServeConfig, copy_block, gather_kv,
                                  init_kv_cache, kv_cache_bytes,
                                  kv_read_bytes, kv_write_bytes_per_token,
                                  paged_attention, paged_write)
from apex_tpu_torch.serve.decode import _nibble_dequant
from apex_tpu_torch.transformer.testing import GPTConfig

MODES = {"int8": dict(quantized=True, bits=8),
         "int4": dict(quantized=True, bits=4),
         "int4_g4": dict(quantized=True, bits=4, group_size=4)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed, n, block):
    """Values with tiny and large entries, exact code midpoints and a last
    block of zeros, so rounding, clipping and the scale-1 rule all show."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 30.0], n))
    x = x.astype(np.float32)
    x[:4] = [2.5, -2.5, 0.5, -0.5]
    x[-block:] = 0.0
    return x


def _within_ulps(got, want, deq):
    """The round-trip error x - q·s: XLA's jit fuses and contracts it (its
    dequantized values are not the unjitted ones bit for bit), so the two
    sides agree within 4 ulps of the dequantized value q·s."""
    assert (np.abs(got - want) <= 4 * np.spacing(np.abs(deq))).all()


# ---------------------------------------------------------------------------
# the codec


@pytest.mark.parametrize("block", [8, 16, 64, 256])
def test_int8_codec_matches_jax(block):
    x = _x(block, 512, block)
    jcodes, jscales = jq.quantize_blockwise(jnp.asarray(x), block,
                                            use_pallas=False)
    codes, scales = pq.quantize_blockwise(_t(x), block)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert scales[-1] == 1.0 and codes[-block:].abs().max() == 0
    assert int(codes.abs().max()) == 127        # each block's max hits qmax
    deq = pq.dequantize_blockwise(codes, scales, block).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jq.dequantize_blockwise(jcodes, jscales, block,
                                                use_pallas=False)))
    _within_ulps(pq.quantization_error(_t(x), block).numpy(),
                   np.asarray(jq.quantization_error(jnp.asarray(x), block)),
                   deq)


@pytest.mark.parametrize("group", [2, 8, 128])
def test_int4_codec_matches_jax(group):
    x = _x(group + 1, 512, group)
    jpacked, jscales = jq.quantize_blockwise_int4(jnp.asarray(x), group,
                                                  use_pallas=False)
    packed, scales = pq.quantize_blockwise_int4(_t(x), group)
    assert packed.dtype == torch.uint8 and packed.numel() == 256
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    codes = pq.unpack_int4(packed)
    assert int(codes.abs().max()) == 7 and int(codes.min()) >= -7
    assert scales[-1] == 1.0 and codes[-group:].abs().max() == 0
    deq = pq.dequantize_blockwise_int4(packed, scales, group).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jq.dequantize_blockwise_int4(jpacked, jscales, group,
                                                     use_pallas=False)))
    _within_ulps(
        pq.quantization_error_int4(_t(x), group).numpy(),
        np.asarray(jq.quantization_error_int4(jnp.asarray(x), group)), deq)


def test_nibble_packing_matches_jax():
    """Every code pair in [-8, 7]: pack and unpack bitwise as JAX's (even
    index in the low nibble), and unpack inverts pack."""
    a = np.repeat(np.arange(-8, 8), 16).astype(np.int8)
    b = np.tile(np.arange(-8, 8), 16).astype(np.int8)
    pairs = np.stack([a, b], axis=1).reshape(2, 256)
    packed = pq.pack_int4(_t(pairs))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(pairs))))
    assert int(packed[0, 0]) == ((-8) & 0xF) | (((-8) & 0xF) << 4)
    np.testing.assert_array_equal(pq.unpack_int4(packed).numpy(), pairs)
    np.testing.assert_array_equal(
        pq.unpack_int4(packed).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError, match="even"):
        pq.pack_int4(torch.zeros(3, dtype=torch.int8))


def test_codec_argument_checks():
    """Bad sizes raise as JAX's do; ``use_pallas=True`` where JAX's gate
    refuses the codec kernels (block 10) raises ValueError as JAX's does;
    stochastic rounding with a seed returns codes."""
    x = torch.zeros(100)
    assert pq.qmax_for_bits(8) == jq.qmax_for_bits(8) == 127.0
    assert pq.qmax_for_bits(4) == jq.qmax_for_bits(4) == 7.0
    with pytest.raises(ValueError):
        pq.qmax_for_bits(2)
    assert pq.blocks_for(100, 64) == jq.blocks_for(100, 64) == 2
    assert pq.padded_size(100, 64) == jq.padded_size(100, 64) == 128
    with pytest.raises(ValueError, match="multiple"):
        pq.quantize_blockwise(x, 64)
    with pytest.raises(ValueError, match="flat"):
        pq.quantize_blockwise(x.reshape(10, 10), 10)
    with pytest.raises(ValueError, match="even"):
        pq.quantize_blockwise_int4(x, 5)
    with pytest.raises(ValueError, match="multiple"):
        pq.quantize_blockwise_int4(x, 8)
    with pytest.raises(ValueError, match="seed"):
        pq.quantize_blockwise(x, 10, stochastic=True)
    for call in (lambda: pq.quantize_blockwise(x, 10, use_pallas=True),
                 lambda: pq.quantize_blockwise_int4(x, 10, use_pallas=True),
                 lambda: pq.dequantize_blockwise(x.to(torch.int8),
                                                 torch.ones(10), 10,
                                                 use_pallas=True)):
        with pytest.raises(ValueError, match="pallas .*rows % 32"):
            call()
    q, s = pq.quantize_blockwise(x, 10, stochastic=True, seed=1)
    assert q.dtype == torch.int8 and q.shape == (100,) and s.shape == (10,)


# ---------------------------------------------------------------------------
# the pools


def _kv_pair(mode, num_layers=1, heads=2, hd=8, blocks=6, bs=4):
    j = JKV(num_layers=num_layers, num_heads=heads, head_dim=hd,
            num_blocks=blocks, block_size=bs, dtype=jnp.float32,
            **MODES[mode])
    p = KVCacheConfig(num_layers=num_layers, num_heads=heads, head_dim=hd,
                      num_blocks=blocks, block_size=bs, dtype=torch.float32,
                      **MODES[mode])
    return j, p


def test_quant_config_validation_matches_jax():
    assert KVCacheConfig(1, 2, 8, 4, quantized=True, bits=4).kv_group == 8
    assert KVCacheConfig(1, 2, 8, 4, quantized=True, bits=4,
                         group_size=2).kv_group == 2
    assert KVCacheConfig(1, 2, 8, 4).kv_group == 8
    assert KVCacheConfig(1, 2, 8, 4, block_size=4).tokens_capacity == 16
    for kw in (dict(bits=3), dict(bits=8, group_size=4),
               dict(quantized=True, bits=4, group_size=3),
               dict(quantized=True, bits=4, group_size=16)):
        with pytest.raises(ValueError):
            JKV(1, 2, 8, 4, **kw).validate()
        with pytest.raises(ValueError):
            KVCacheConfig(1, 2, 8, 4, **kw).validate()


@pytest.mark.parametrize("mode", list(MODES))
def test_quant_init_matches_jax(mode):
    """Leaves, shapes (plus the port's trash block), dtypes and initial
    values (zero codes, unit scales) as JAX's."""
    jcfg, cfg = _kv_pair(mode, num_layers=2)
    jc, pc = jax_init_cache(jcfg), init_kv_cache(cfg, "cpu")
    assert sorted(pc) == sorted(jc)
    for name, leaf in jc.items():
        want = np.asarray(leaf)
        got = pc[name]
        assert str(got.dtype).split(".")[1] == str(want.dtype), name
        assert got.shape[:2] + got.shape[3:] == want.shape[:2] + want.shape[3:]
        assert got.shape[2] == want.shape[2] + 1
        np.testing.assert_array_equal(
            got[:, :, :-1].float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("mode", list(MODES))
def test_quant_paged_write_gather_matches_jax(mode):
    """Scattered tables, a partial block, invalid rows and a position past
    the row's blocks: codes, scales and the dequantized gather equal JAX's
    bitwise (the port's trash block holds what JAX dropped)."""
    jcfg, cfg = _kv_pair(mode)
    rng = np.random.default_rng(0)
    n = 9
    k = (rng.standard_normal((2, n, 8)) * 3).astype(np.float32)
    v = rng.standard_normal((2, n, 8)).astype(np.float32)
    k[0, 3] = 0.0                                 # a zero vector: scale 1
    rows = np.array([[5, 2, 0]] * 7 + [[1, 3, 4]] * 2, np.int32)
    pos = np.array([0, 1, 2, 3, 4, 5, 6, 2, 12], np.int32)
    valid = np.array([1, 1, 0, 1, 1, 1, 1, 1, 1], bool)
    jl = {kk: vv[0] for kk, vv in jax_init_cache(jcfg).items()}
    jl = jax_write(jl, jcfg, jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(valid))
    pc = init_kv_cache(cfg, "cpu")
    pl = {kk: vv[0] for kk, vv in pc.items()}
    paged_write(pl, cfg, _t(k), _t(v), _t(rows), _t(pos), _t(valid))
    for name in jl:
        np.testing.assert_array_equal(
            pc[name][0, :, :6].float().numpy(),
            np.asarray(jl[name]).astype(np.float32), err_msg=name)
    tables = np.array([[5, 2, 0], [1, 3, 4]], np.int32)
    jk, jv = jax_gather(jl, jcfg, jnp.asarray(tables))
    gk, gv = gather_kv(pl, cfg, _t(tables))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("mode", list(MODES))
def test_quant_copy_block_matches_jax(mode):
    """copy_block copies codes and scales alike."""
    jcfg, cfg = _kv_pair(mode, num_layers=2)
    rng = np.random.default_rng(1)
    jc = {}
    for kk, vv in jax_init_cache(jcfg).items():
        a = rng.integers(0, 120, vv.shape).astype(np.asarray(vv).dtype)
        jc[kk] = jnp.asarray(a)
    pc = init_kv_cache(cfg, "cpu")
    for kk in pc:
        pc[kk][:, :, :6] = torch.from_numpy(
            np.asarray(jc[kk]).astype(np.float32)).to(pc[kk].dtype)
    jc = jax_copy_block(jc, 4, 1)
    copy_block(pc, 4, 1)
    for kk in pc:
        np.testing.assert_array_equal(pc[kk][:, :, :6].float().numpy(),
                                      np.asarray(jc[kk]).astype(np.float32))
    assert "k_scale" in pc and torch.equal(pc["k_scale"][:, :, 1],
                                           pc["k_scale"][:, :, 4])


@pytest.mark.parametrize("mode", list(MODES))
def test_quant_byte_models_match_jax(mode):
    j = JKV(num_layers=2, num_heads=4, head_dim=8, num_blocks=10,
            block_size=4, dtype=jnp.bfloat16, **MODES[mode])
    p = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8, num_blocks=10,
                      block_size=4, dtype=torch.bfloat16, **MODES[mode])
    assert kv_cache_bytes(p) == jax_cache_bytes(j)
    assert kv_write_bytes_per_token(p) == jax_write_bytes(j)
    assert kv_read_bytes(p, [5, 0, 9]) == jax_read_bytes(j, [5, 0, 9])


def test_nibble_dequant_matches_jax():
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, (3, 4, 16)).astype(np.uint8)
    scales = rng.standard_normal((3, 4, 4)).astype(np.float32)
    s16 = torch.from_numpy(scales).to(torch.bfloat16)
    got = _nibble_dequant(torch.from_numpy(packed), s16, 8)
    want = jax_nibble_dequant(jnp.asarray(packed),
                              jnp.asarray(scales).astype(jnp.bfloat16), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# quantized paged attention


@pytest.mark.parametrize("mode", list(MODES))
def test_quant_paged_attention_matches_jax_kernel(mode):
    """The port's plain version (the CPU route of ``paged_attention``)
    against JAX's Pallas kernel in interpret mode, on pools both sides
    wrote through their codecs: atol 2e-5 (fp32 softmax sums in two
    orders); a ctx == 0 row is zeros in the port (the JAX kernel's)."""
    heads, hd, bs, blocks = 2, 8, 4, 12
    jcfg, cfg = _kv_pair(mode, heads=heads, hd=hd, blocks=blocks, bs=bs)
    rng = np.random.default_rng(3)
    n_tok = blocks * bs
    k = rng.standard_normal((heads, n_tok, hd)).astype(np.float32)
    v = rng.standard_normal((heads, n_tok, hd)).astype(np.float32)
    perm = rng.permutation(blocks).astype(np.int32)
    pos = np.arange(n_tok, dtype=np.int32)
    rows = np.tile(perm, (n_tok, 1))
    valid = np.ones(n_tok, bool)
    jl = {kk: vv[0] for kk, vv in jax_init_cache(jcfg).items()}
    jl = jax_write(jl, jcfg, jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(valid))
    pc = init_kv_cache(cfg, "cpu")
    pl = {kk: vv[0] for kk, vv in pc.items()}
    paged_write(pl, cfg, _t(k), _t(v), _t(rows), _t(pos), _t(valid))
    tables = np.stack([perm, np.roll(perm, 3), perm[::-1].copy()])
    ctx = np.array([13, 48, 0], np.int32)
    q = rng.standard_normal((3, heads, hd)).astype(np.float32)
    want = jax_paged(jnp.asarray(q), jl, jcfg, jnp.asarray(tables),
                     jnp.asarray(ctx), use_pallas=True, interpret=True)
    got = paged_attention(_t(q), pl, cfg, _t(tables), _t(ctx))
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               atol=2e-5, rtol=0)
    assert got[2].abs().max() == 0


# ---------------------------------------------------------------------------
# engine streams


JCFG = JGPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                  num_heads=4, dtype=jnp.float32, fused_loss=False)
CFG = GPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                num_heads=4, dtype=torch.float32)
JPARAMS = jax_init(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")
REQS = [("a", [1, 2, 3, 4, 5], 6), ("b", [7, 8, 9], 4),
        ("c", list(range(10, 22)), 5), ("d", [1, 2, 3, 4, 5, 6, 7, 8, 9], 4)]


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_quant_greedy_streams_match_jax(kv_quant, spec_k):
    """Greedy streams with int8 / int4 pools, the per-op path on both
    sides (JAX's ``auto`` off its TPU, the port's on the CPU), token for
    token equal to JAX's; the pools' byte figures in stats() agree."""
    scfg = dict(num_slots=3, block_size=8, prefill_chunk=8, spec_k=spec_k,
                kv_quant=kv_quant)
    jeng = JEngine(JPARAMS, JCFG, JServeConfig(**scfg))
    want = jeng.run([JRequest(u, p, max_new_tokens=m) for u, p, m in REQS])
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(**scfg), device="cpu")
    got = eng.run([Request(u, p, max_new_tokens=m) for u, p, m in REQS])
    assert got == want
    st, jst = eng.stats(), jeng.stats()
    for key in ("kv_bits", "kv_cache_bytes", "contexts_max"):
        assert st[key] == jst[key], key
    assert st["megakernel"] is False and st["decode_kernel"] == "plain"
    if spec_k:
        assert st["speculative"]["verify_steps"] > 0
