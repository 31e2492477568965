"""Paged attention's routes and split walk on the CPU, against apex_tpu.

On the card ``serve.decode._paged_route`` sends bf16 queries to the
tensor-core kernel (``paged_mma_fwd``) and fp32 ones to the CUDA-core
kernel (``paged_attention_fwd``), every head_dim % 8 == 0 up to 256, and
both types above 256 to the CUDA-core wide walk (``paged_wide_fwd``, the
head dim in chunks); a head_dim that is not a multiple of 8 takes the
plain version with one warning, as JAX's gate sends it to its reference.
All walk a row's context in splits whose length is a function of the block
table's capacity alone (``_paged_splits``), the rows of one group
(``rows_per_table``) sharing each K/V tile, and merge the splits' partials
in order. Here: JAX parity of the port's plain version and of the plain
emulation of that walk (``paged_attention_split_reference``) at head dims
the kernels once refused, for full-precision, int8 and int4 pools (JAX's
Pallas kernel in interpret mode; atol 2e-5: fp32 softmax sums in other
orders); the emulation bitwise equal across group sizes; the route table,
the refusals and the split geometry; and that the serve programs pass
their rows per slot as the group. The kernels themselves are held to the
plain version on the card (``tests/test_torch_kernels_cuda.py``).
"""

import inspect
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.serve import KVCacheConfig as JKV
from apex_tpu.serve import init_kv_cache as jax_init_cache
from apex_tpu.serve import paged_attention as jax_paged
from apex_tpu.serve import paged_write as jax_write

from apex_tpu_torch.serve import (KVCacheConfig, init_kv_cache,
                                  paged_attention, paged_write)
from apex_tpu_torch.serve import decode as dec
from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

POOLS = {"none": {}, "int8": dict(quantized=True, bits=8),
         "int4": dict(quantized=True, bits=4),
         "int4_g8": dict(quantized=True, bits=4, group_size=8)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(mode, hd, heads=2, bs=4, blocks=12, seed=0, jax_too=True):
    """One layer's pools on both sides, every position of every block
    written with the same random K/V through each side's codec."""
    rng = np.random.default_rng(seed)
    n_tok = blocks * bs
    k = rng.standard_normal((heads, n_tok, hd)).astype(np.float32)
    v = rng.standard_normal((heads, n_tok, hd)).astype(np.float32)
    perm = rng.permutation(blocks).astype(np.int32)
    pos = np.arange(n_tok, dtype=np.int32)
    rows = np.tile(perm, (n_tok, 1))
    valid = np.ones(n_tok, bool)
    cfg = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                        num_blocks=blocks, block_size=bs,
                        dtype=torch.float32, **POOLS[mode])
    pl = {kk: vv[0] for kk, vv in init_kv_cache(cfg, "cpu").items()}
    paged_write(pl, cfg, _t(k), _t(v), _t(rows), _t(pos), _t(valid))
    if not jax_too:
        return cfg, pl, perm
    jcfg = JKV(num_layers=1, num_heads=heads, head_dim=hd, num_blocks=blocks,
               block_size=bs, dtype=jnp.float32, **POOLS[mode])
    jl = {kk: vv[0] for kk, vv in jax_init_cache(jcfg).items()}
    jl = jax_write(jl, jcfg, jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(valid))
    return cfg, pl, perm, jcfg, jl


# ---------------------------------------------------------------------------
# JAX parity at the head dims the port's kernels now take


@pytest.mark.parametrize("mode", list(POOLS))
@pytest.mark.parametrize("hd", [40, 80, 96, 136, 256])
def test_paged_attention_matches_jax_at_every_head_dim(mode, hd):
    """Two slots of three rows (a verify call's shape): the plain version
    and the split walk's emulation (four parts a split, groups of 3)
    against JAX's kernel in interpret mode; ctx == 0 rows are zeros."""
    cfg, pl, perm, jcfg, jl = _pools(mode, hd, seed=hd)
    rng = np.random.default_rng(hd + 1)
    slots = np.stack([perm, np.roll(perm, 5)])
    tables = np.repeat(slots, 3, axis=0)
    ctx = np.array([0, 9, 17, 48, 30, 52], np.int32)  # 52: past the blocks
    q = rng.standard_normal((6, 2, hd)).astype(np.float32)
    want = np.asarray(jax_paged(jnp.asarray(q), jl, jcfg,
                                jnp.asarray(tables), jnp.asarray(ctx),
                                use_pallas=True, interpret=True))
    got = paged_attention(_t(q), pl, cfg, _t(tables), _t(ctx),
                          rows_per_table=3)
    split = dec.paged_attention_split_reference(
        _t(q), pl, cfg, _t(tables), _t(ctx), rows_per_table=3, parts=4)
    live = ctx > 0
    for out in (got, split):
        np.testing.assert_allclose(out.numpy()[live], want[live], atol=2e-5,
                                   rtol=0)
        assert not out.numpy()[~live].any()


# ---------------------------------------------------------------------------
# the split walk


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("parts", [1, 4])
def test_split_walk_is_bitwise_whatever_the_group(mode, hd, parts):
    """The emulation of the kernels' walk against the plain version
    (2e-5), and a row's bits equal whether its slot's rows are launched as
    one group of 32 (a prefill chunk), groups of 5 (verify; the first 30
    rows of each slot) or rows of 1 (decode)."""
    cfg, pl, perm = _pools(mode, hd, bs=4, blocks=40, seed=hd,
                           jax_too=False)
    assert dec._paged_splits(160) == (2, 128)   # two splits here
    rng = np.random.default_rng(7)
    tables = _t(np.repeat(np.stack([perm, perm[::-1].copy()]), 32, axis=0))
    ctx = _t(rng.integers(0, 170, 64).astype(np.int32))
    q = _t(rng.standard_normal((64, 2, hd)).astype(np.float32))
    runs = {g: dec.paged_attention_split_reference(
        q, pl, cfg, tables, ctx, rows_per_table=g, parts=parts)
        for g in (32, 1)}
    keep = (torch.arange(64) % 32) < 30
    g5 = dec.paged_attention_split_reference(
        q[keep], pl, cfg, tables[keep], ctx[keep], rows_per_table=5,
        parts=parts)
    assert torch.equal(runs[32], runs[1])
    assert torch.equal(runs[32][keep], g5)
    want = dec.paged_attention_reference(q, pl, cfg, tables, ctx)
    torch.testing.assert_close(runs[32], want, atol=2e-5, rtol=0)


def test_paged_splits_are_a_function_of_the_capacity_alone():
    assert list(inspect.signature(dec._paged_splits).parameters) == [
        "capacity"]
    assert dec._paged_splits(1024) == (8, 128)      # GPT-2's serving table
    assert dec._paged_splits(16) == (1, 128)
    assert dec._paged_splits(32768) == (64, 512)
    for cap in (1, 64, 65, 128, 1000, 4096, 5000, 100_000):
        splits, length = dec._paged_splits(cap)
        assert length % dec.PAGED_TILE == 0 and length >= 128
        assert 1 <= splits <= 64
        assert (splits - 1) * length < cap <= splits * length or cap <= 128


# ---------------------------------------------------------------------------
# routes and refusals


def test_route_table():
    for d in range(8, 257, 8):
        assert dec._paged_route(torch.bfloat16, d) == "paged_mma_fwd"
        assert dec._paged_route(torch.float16, d) == "paged_mma_fwd"
        assert dec._paged_route(torch.float32, d) == "paged_attention_fwd"
    for d in (4, 12, 44, 100, 252):
        with pytest.raises(ValueError, match=f"head_dim {d} is not a "
                                             f"multiple of 8"):
            dec._paged_route(torch.bfloat16, d)
    for d in (264, 512, 1024, 2056, 4096):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            assert dec._paged_route(dt, d) == "paged_wide_fwd"
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        dec._paged_route(torch.float64, 64)
    assert set(dec._ROUTES) == {"paged_mma_fwd", "paged_attention_fwd",
                                "paged_wide_fwd"}
    assert dec._ROUTES["paged_mma_fwd"][0] == "paged_mma"
    assert dec._ROUTES["paged_wide_fwd"][0] == "paged_attention"


def test_rows_per_table_must_make_whole_groups():
    cfg, pl, perm = _pools("none", 16, jax_too=False)
    q = torch.zeros(6, 2, 16)
    tables = _t(np.tile(perm, (6, 1)))
    ctx = torch.full((6,), 5, dtype=torch.int32)
    for g in (3, 6):
        paged_attention(q, pl, cfg, tables, ctx, rows_per_table=g)
    for g in (4, 0):
        with pytest.raises(ValueError, match=f"rows_per_table={g}"):
            paged_attention(q, pl, cfg, tables, ctx, rows_per_table=g)
        with pytest.raises(ValueError, match=f"rows_per_table={g}"):
            dec.paged_attention_split_reference(q, pl, cfg, tables, ctx,
                                                rows_per_table=g)


def test_serve_programs_pass_their_rows_per_slot_as_the_group(monkeypatch):
    """Decode (q = 1), verify (q = k + 1) and a prefill chunk (q = chunk)
    call paged attention with rows_per_table = q on rows whose tables
    repeat each slot's q times."""
    seen = []
    real = dec.paged_attention

    def spy(q, cache_layer, cfg, block_tables, ctx_lens, scale=None, *,
            rows_per_table=1, use_pallas=None):
        g = rows_per_table
        slots = block_tables[::g]
        assert torch.equal(block_tables, slots.repeat_interleave(g, dim=0))
        seen.append(g)
        return real(q, cache_layer, cfg, block_tables, ctx_lens, scale,
                    rows_per_table=g, use_pallas=use_pallas)

    monkeypatch.setattr(dec, "paged_attention", spy)
    cfg = GPTConfig(vocab_size=64, max_seq=64, hidden=32, num_layers=2,
                    num_heads=2, dtype=torch.float32)
    params = init_gpt_params(cfg, seed=0, device="cpu")
    kv = KVCacheConfig(num_layers=2, num_heads=2, head_dim=16,
                       num_blocks=16, block_size=4, dtype=torch.float32)
    cache = init_kv_cache(kv, "cpu")
    tables = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    dec.gpt_prefill_chunk(params, torch.arange(8, dtype=torch.int32), 0, 8,
                          cache, tables[0], cfg, kv)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    on = torch.tensor([True, True])
    dec.gpt_verify_step(params, torch.ones(2, 4, dtype=torch.int32), lens,
                        torch.tensor([4, 2], dtype=torch.int32), on, cache,
                        tables, cfg, kv)
    dec.gpt_decode_step(params, torch.ones(2, dtype=torch.int32), lens, on,
                        cache, tables, cfg, kv)
    assert seen == [8] * 2 + [4] * 2 + [1] * 2      # per call, per layer


# ---------------------------------------------------------------------------
# above head_dim 256, and head dims that are not a multiple of 8


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("hd", [264, 512])
def test_wide_head_dims_match_jax(mode, hd):
    """The wide walk's head dims (``paged_wide_fwd`` on the card): the
    plain version and the split emulation (one part a split, the wide
    walk's) against JAX's kernel in interpret mode, groups of 3, ctx == 0
    rows zeros."""
    assert dec._paged_route(torch.float32, hd) == "paged_wide_fwd"
    cfg, pl, perm, jcfg, jl = _pools(mode, hd, seed=hd)
    rng = np.random.default_rng(hd + 2)
    tables = np.repeat(np.stack([perm, np.roll(perm, 3)]), 3, axis=0)
    ctx = np.array([0, 11, 29, 48, 5, 60], np.int32)
    q = rng.standard_normal((6, 2, hd)).astype(np.float32)
    want = np.asarray(jax_paged(jnp.asarray(q), jl, jcfg,
                                jnp.asarray(tables), jnp.asarray(ctx),
                                use_pallas=True, interpret=True))
    got = paged_attention(_t(q), pl, cfg, _t(tables), _t(ctx),
                          rows_per_table=3)
    split = dec.paged_attention_split_reference(
        _t(q), pl, cfg, _t(tables), _t(ctx), rows_per_table=3, parts=1)
    live = ctx > 0
    for out in (got, split):
        np.testing.assert_allclose(out.numpy()[live], want[live], atol=2e-5,
                                   rtol=0)
        assert not out.numpy()[~live].any()


def test_head_dim_off_the_gate_takes_the_reference_and_warns_once(
        monkeypatch, caplog):
    """head_dim 100 (not a multiple of 8) where the kernels would run: the
    plain version, no kernel reached, one warning for the head dim however
    many calls, as JAX's ``_warn_reference_fallback``; JAX's own dispatch
    gives the same result. The route itself still refuses it."""
    cfg, pl, perm, jcfg, jl = _pools("none", 100, seed=3)
    tables = np.repeat(perm[None], 4, axis=0)
    ctx = np.array([0, 7, 20, 48], np.int32)
    q = np.random.default_rng(4).standard_normal((4, 2, 100)).astype(
        np.float32)

    def refuse(*a, **k):
        raise AssertionError("reached the kernels")

    monkeypatch.setattr(dec.ku, "use_kernel", lambda t: True)
    monkeypatch.setattr(dec, "paged_attention_fwd", refuse)
    monkeypatch.setattr(dec, "_FALLBACK_WARNED", set())
    with caplog.at_level(logging.WARNING, logger="apex_tpu_torch.serve"):
        outs = [paged_attention(_t(q), pl, cfg, _t(tables), _t(ctx))
                for _ in range(3)]
    assert len(caplog.records) == 1
    assert "head_dim 100" in caplog.records[0].getMessage()
    want = dec.paged_attention_reference(_t(q), pl, cfg, _t(tables),
                                         _t(ctx))
    for out in outs:
        assert torch.equal(out, want)
    jax_out = np.asarray(jax_paged(jnp.asarray(q), jl, jcfg,
                                   jnp.asarray(tables), jnp.asarray(ctx)))
    live = ctx > 0
    np.testing.assert_allclose(want.numpy()[live], jax_out[live], atol=2e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="head_dim 100 is not a multiple"):
        dec._paged_route(torch.float32, 100)
