"""The port's fused decode/verify layer on the CPU (its plain version),
against apex_tpu.serve.megakernel and the port's per-op programs.

Tiny GPT as JAX's own tests (vocab 97, hidden 32, 2 layers, 4 heads, fp32,
block_size 4-8); JAX's fused programs run their Pallas block in interpret
mode. Tolerances are JAX's: logits atol 5e-5, fp pools atol 1e-5.
Quantized pools hold identical codes wherever the codec sees the same K/V
values: the port's fused and per-op paths compute K/V with the same fp32
operations on the CPU, so their codes and scales are held bitwise; against
JAX's whole step (XLA's products against PyTorch's, K/V equal to the last
few bits) scales within 1e-6 relative and codes within one step.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.serve import KVCacheConfig as JKV
from apex_tpu.serve import init_kv_cache as jax_init_cache
from apex_tpu.serve.decode import gpt_prefill as jax_prefill
from apex_tpu.serve.megakernel import fused_layer_decode as jax_layer_decode
from apex_tpu.serve.megakernel import fused_layer_verify as jax_layer_verify
from apex_tpu.serve.megakernel import gpt_decode_step_fused as jax_decode_f
from apex_tpu.serve.megakernel import gpt_verify_step_fused as jax_verify_f
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.serve import (InferenceEngine, KVCacheConfig, Request,
                                  SamplingConfig, ServeConfig,
                                  fused_layer_decode, fused_layer_reference,
                                  fused_layer_verify, gpt_decode_step,
                                  gpt_decode_step_fused, gpt_verify_step,
                                  gpt_verify_step_fused, megakernel_ok,
                                  megakernel_refusal)
from apex_tpu_torch.serve import megakernel as mk
from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

JCFG = JGPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                  num_heads=4, dtype=jnp.float32, fused_loss=False)
CFG = GPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                num_heads=4, dtype=torch.float32)
JPARAMS = jax_init(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")

KV_MODES = {"none": {}, "int8": dict(quantized=True, bits=8),
            "int4": dict(quantized=True, bits=4)}
REQS = [("a", [1, 2, 3, 4, 5], 6), ("b", [7, 8, 9], 4),
        ("c", list(range(10, 22)), 5)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _kv(mode, num_blocks=24, block_size=4):
    kw = dict(num_layers=2, num_heads=4, head_dim=8, num_blocks=num_blocks,
              block_size=block_size)
    return (JKV(dtype=jnp.float32, **kw, **KV_MODES[mode]),
            KVCacheConfig(dtype=torch.float32, **kw, **KV_MODES[mode]))


def _prefilled(jkv, prompts):
    """JAX prefill of ``prompts`` into a fresh cache, one slot each, block
    rows carved consecutively; returns the JAX cache, the port's copy of
    it (one trash block appended) and the block tables."""
    bpslot = jkv.num_blocks // len(prompts)
    bt = np.arange(len(prompts) * bpslot,
                   dtype=np.int32).reshape(len(prompts), bpslot)
    cache = jax_init_cache(jkv)
    for s, pr in enumerate(prompts):
        toks = jnp.zeros((16,), jnp.int32).at[:len(pr)].set(jnp.asarray(pr))
        cache, _ = jax_prefill(JPARAMS, toks, jnp.int32(len(pr)), cache,
                               jnp.asarray(bt[s]), JCFG, jkv)
    return cache, _port_cache(cache), bt


def _port_cache(jc):
    out = {}
    for name, leaf in jc.items():
        a = np.asarray(leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16
                       else leaf)
        t = torch.from_numpy(a.copy())
        if leaf.dtype == jnp.bfloat16:
            t = t.to(torch.bfloat16)
        pad = torch.zeros_like(t[:, :, :1])
        out[name] = torch.cat([t, pad], dim=2)
    return out


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _check_pools(port, other, quantized, is_jax):
    """fp pools atol 1e-5 (the port's trash block aside). Quantized pools
    against the port's per-op path: codes and scales bitwise. Against
    JAX's step, whose K/V differ from the port's in the last bits (XLA's
    products against PyTorch's): scales within 1e-6 relative, codes within
    one step and equal in all but 1 % of places."""
    for name, pool in port.items():
        got = pool[:, :, :-1].float().numpy()
        want = (np.asarray(other[name]).astype(np.float32) if is_jax
                else other[name][:, :, :-1].float().numpy())
        if not quantized:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=name)
        elif not is_jax:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            if name in ("k", "v") and pool.dtype == torch.uint8:
                got = _unpack(pool[:, :, :-1])
                want = _unpack(torch.from_numpy(np.array(other[name])))
            diff = np.abs(got - want)
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, name


def _unpack(packed):
    from apex_tpu_torch.comm.quantize import unpack_int4
    return unpack_int4(packed).float().numpy()


@pytest.mark.parametrize("kv_mode", list(KV_MODES))
def test_fused_decode_matches_jax_and_unfused(kv_mode):
    """Four decode steps from one prefilled state on three paths: the
    port's fused step, the port's per-op step and JAX's fused step
    (interpret). Active slots' logits within 5e-5 of both; the pools
    alike (fp atol 1e-5, codes and scales bitwise); an inactive slot (ctx
    0) gives finite junk and writes nothing."""
    quantized = kv_mode != "none"
    jkv, kv = _kv(kv_mode)
    jc, pc, bt = _prefilled(jkv, [[3, 14, 15, 92, 6], [7, 8, 9], [1]])
    pu = _clone(pc)
    lens = np.array([5, 3, 0], np.int32)
    last = np.array([10, 20, 0], np.int32)
    active = np.array([True, True, False])
    for _ in range(4):
        jc, lg_j = jax_decode_f(JPARAMS, jnp.asarray(last), jnp.asarray(lens),
                                jnp.asarray(active), jc, jnp.asarray(bt),
                                JCFG, jkv)
        pc, lg_f = gpt_decode_step_fused(PARAMS, _t(last), _t(lens),
                                         _t(active), pc, _t(bt), CFG, kv)
        pu, lg_u = gpt_decode_step(PARAMS, _t(last), _t(lens), _t(active),
                                   pu, _t(bt), CFG, kv)
        assert torch.isfinite(lg_f).all()
        np.testing.assert_allclose(lg_f[:2].numpy(), np.asarray(lg_j)[:2],
                                   atol=5e-5, rtol=0)
        np.testing.assert_allclose(lg_f[:2].numpy(), lg_u[:2].numpy(),
                                   atol=5e-5, rtol=0)
        _check_pools(pc, jc, quantized, is_jax=True)
        _check_pools(pc, pu, quantized, is_jax=False)
        last = np.asarray(lg_u.argmax(-1)).astype(np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)


@pytest.mark.parametrize("kv_mode", list(KV_MODES))
def test_fused_verify_matches_jax_and_unfused(kv_mode):
    """Three verify rounds that accept fewer tokens than were fed
    (rejected drafts' K/V stay in the pool and are overwritten later —
    the no-rollback contract): valid rows' logits within 5e-5 of JAX's
    fused verify and the port's per-op verify, pools as in the decode
    test."""
    quantized = kv_mode != "none"
    jkv, kv = _kv(kv_mode)
    jc, pc, bt = _prefilled(jkv, [[3, 14, 15, 92, 6], [7, 8, 9], [1]])
    pu = _clone(pc)
    lens = np.array([5, 3, 0], np.int32)
    active = np.array([True, True, False])
    rng = np.random.default_rng(7)
    fed = rng.integers(1, 96, (3, 3)).astype(np.int32)
    for n_fed, accept in [(np.array([3, 2, 0], np.int32), (1, 2)),
                          (np.array([2, 3, 0], np.int32), (2, 1)),
                          (np.array([3, 1, 0], np.int32), (3, 1))]:
        jc, lg_j = jax_verify_f(JPARAMS, jnp.asarray(fed), jnp.asarray(lens),
                                jnp.asarray(n_fed), jnp.asarray(active), jc,
                                jnp.asarray(bt), JCFG, jkv)
        pc, lg_f = gpt_verify_step_fused(PARAMS, _t(fed), _t(lens),
                                         _t(n_fed), _t(active), pc, _t(bt),
                                         CFG, kv)
        pu, lg_u = gpt_verify_step(PARAMS, _t(fed), _t(lens), _t(n_fed),
                                   _t(active), pu, _t(bt), CFG, kv)
        valid = active[:, None] & (np.arange(3)[None, :] < n_fed[:, None])
        assert torch.isfinite(lg_f).all()
        np.testing.assert_allclose(lg_f.numpy()[valid], np.asarray(lg_j)[valid],
                                   atol=5e-5, rtol=0)
        np.testing.assert_allclose(lg_f.numpy()[valid], lg_u.numpy()[valid],
                                   atol=5e-5, rtol=0)
        _check_pools(pc, jc, quantized, is_jax=True)
        _check_pools(pc, pu, quantized, is_jax=False)
        lens = lens + np.array([accept[0], accept[1], 0], np.int32)
        fed = rng.integers(1, 96, (3, 3)).astype(np.int32)


@pytest.mark.parametrize("kv_mode", list(KV_MODES))
def test_fused_verify_single_row_equals_decode(kv_mode):
    """A q=1 verify is the decode step: logits and pools bitwise."""
    jkv, kv = _kv(kv_mode)
    _, pc, bt = _prefilled(jkv, [[3, 14, 15], [7, 8, 9, 10]])
    pv = _clone(pc)
    lens, active, last = _t([3, 4]), _t([True, True]), _t([10, 20])
    pc, lg_d = gpt_decode_step_fused(PARAMS, last, lens, active, pc, _t(bt),
                                     CFG, kv)
    pv, lg_v = gpt_verify_step_fused(PARAMS, last[:, None], lens, _t([1, 1]),
                                     active, pv, _t(bt), CFG, kv)
    assert torch.equal(lg_v[:, 0], lg_d)
    for name in pc:
        assert torch.equal(pc[name], pv[name]), name


def test_fused_layer_rows_independent_of_the_batch():
    """A fed row's output does not depend on the rows beside it: one slot
    verified alone equals the same slot inside a three-slot verify."""
    jkv, kv = _kv("int8")
    _, pc, bt = _prefilled(jkv, [[3, 14, 15, 92, 6], [7, 8, 9], [4, 4]])
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 3, 32)).astype(np.float32))
    lp = {k: v[0] for k, v in PARAMS["layers"].items()}
    c3 = {k: v[0].clone() for k, v in pc.items()}
    c1 = {k: v[0].clone() for k, v in pc.items()}
    lens, n_fed = _t([5, 3, 2]), _t([3, 2, 3])
    active = _t([True, True, True])
    all3 = fused_layer_verify(x, lp, c3, CFG, kv, _t(bt), lens, n_fed, active)
    one = fused_layer_verify(x[1:2], lp, c1, CFG, kv, _t(bt[1:2]), lens[1:2],
                             n_fed[1:2], active[1:2])
    for a, b in zip(all3, one):
        assert torch.equal(a[1:2], b)


def test_fused_layer_matches_jax_layer_and_single_block_table():
    """One fused decode layer against JAX's (interpret), and the nb == 1
    edge (single-block tables): x' within 5e-5, the emitted K/V within
    1e-5; the port wrote the rows' K/V into its pool."""
    jkv, kv = _kv("none", num_blocks=4, block_size=8)
    jc, pc, bt = _prefilled(jkv, [[5, 6, 7], [11]])
    assert bt.shape[1] == 2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], JPARAMS["layers"])
    lp = {k: v[0] for k, v in PARAMS["layers"].items()}
    lens = np.array([3, 1], np.int32)
    for tables in (bt, bt[:, :1].copy()):
        cl_j = {k: v[0] for k, v in jc.items()}
        cl = {k: v[0].clone() for k, v in pc.items()}
        want = jax_layer_decode(jnp.asarray(x), lp_j, cl_j, JCFG, jkv,
                                jnp.asarray(tables), jnp.asarray(lens))
        got = fused_layer_decode(_t(x), lp, cl, CFG, kv, _t(tables),
                                 _t(lens), _t([True, True]))
        assert got[0].shape == (2, 32) and got[1].shape == (2, 4, 8)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=5e-5, rtol=0)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0)
        for i, (blk, off) in enumerate(((tables[0, 0], 3), (tables[1, 0], 1))):
            assert torch.equal(cl["k"][:, blk, off], got[1][i])
            assert torch.equal(cl["v"][:, blk, off], got[2][i])


def _wide_model(heads, head_dim, seed=1):
    """A one-layer GPT of ``heads`` x ``head_dim`` (JAX and port params
    from one JAX init), an fp32 pool of 2 slots x 4 blocks of 4 whose
    positions hold numpy-seeded K/V (JAX's cache and the port's copy),
    and its block tables."""
    h = heads * head_dim
    jcfg = JGPTConfig(vocab_size=97, max_seq=64, hidden=h, num_layers=1,
                      num_heads=heads, dtype=jnp.float32, fused_loss=False)
    cfg = GPTConfig(vocab_size=97, max_seq=64, hidden=h, num_layers=1,
                    num_heads=heads, dtype=torch.float32)
    jp = jax_init(jax.random.PRNGKey(seed), jcfg)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(num_layers=1, num_heads=heads, head_dim=head_dim,
              num_blocks=8, block_size=4)
    jkv = JKV(dtype=jnp.float32, **kw)
    kv = KVCacheConfig(dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)
    jc = {name: jnp.asarray(rng.standard_normal(leaf.shape)
                            .astype(np.float32))
          for name, leaf in jax_init_cache(jkv).items()}
    bt = np.arange(8, dtype=np.int32).reshape(2, 4)[:, ::-1].copy()
    return jcfg, cfg, jp, pp, jkv, kv, jc, _port_cache(jc), bt


@pytest.mark.parametrize("heads,head_dim", [(2, 40), (1, 264)])
def test_fused_layer_matches_jax_at_head_dims_the_first_kernel_refused(
        monkeypatch, heads, head_dim):
    """Head dims outside the first Hopper kernel's 32 / 64 / 128: 40 (2
    heads) and 264 (1 head, above the narrow walks' 256). The port's fused
    layer (its plain version) against JAX's interpret-mode
    fused_layer_decode and fused_layer_verify: x' within 5e-5, the emitted
    K/V within 1e-5, the fed rows' K/V in the port's pool; the fused
    decode program's logits within 5e-5 of JAX's; and the gate admits the
    shape where the kernel itself must run."""
    jcfg, cfg, jp, pp, jkv, kv, jc, pc, bt = _wide_model(heads, head_dim)
    h = cfg.hidden
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, h)).astype(np.float32)
    lens = np.array([5, 9], np.int32)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"])
    lp = {k: v[0] for k, v in pp["layers"].items()}
    for q in (1, 3):
        cl_j = {k: v[0] for k, v in jc.items()}
        cl = {k: v[0].clone() for k, v in pc.items()}
        if q == 1:
            want = jax_layer_decode(jnp.asarray(x[:, 0]), lp_j, cl_j, jcfg,
                                    jkv, jnp.asarray(bt), jnp.asarray(lens))
            got = fused_layer_decode(_t(x[:, 0]), lp, cl, cfg, kv, _t(bt),
                                     _t(lens), _t([True, True]))
        else:
            want = jax_layer_verify(jnp.asarray(x), lp_j, cl_j, jcfg, jkv,
                                    jnp.asarray(bt), jnp.asarray(lens))
            got = fused_layer_verify(_t(x), lp, cl, cfg, kv, _t(bt),
                                     _t(lens), _t([3, 3]), _t([True, True]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=5e-5, rtol=0)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0)
        k_new = got[1].reshape(2, q, heads, head_dim)
        for i in range(2):
            for w in range(q):
                pos = lens[i] + w
                blk, off = bt[i, pos // 4], pos % 4
                assert torch.equal(cl["k"][:, blk, off], k_new[i, w])
    active = np.array([True, True])
    last = np.array([10, 20], np.int32)
    _, lg_j = jax_decode_f(jp, jnp.asarray(last), jnp.asarray(lens),
                           jnp.asarray(active), jc, jnp.asarray(bt), jcfg,
                           jkv)
    _, lg_f = gpt_decode_step_fused(pp, _t(last), _t(lens), _t(active),
                                    _clone(pc), _t(bt), cfg, kv)
    np.testing.assert_allclose(lg_f.numpy(), np.asarray(lg_j), atol=5e-5,
                               rtol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert megakernel_refusal(cfg, kv, allow_interpret=False, q=3,
                              slots=2) is None


def test_fused_layer_rows_independent_of_the_batch_past_128_rows():
    """A call wider than 128 fed rows (33 slots x 4, one launch on the
    card): each slot's rows equal the same slot verified alone, bitwise,
    and its fed rows' K/V are in the pool."""
    jkv, kv = _kv("none", num_blocks=33 * 4, block_size=4)
    rng = np.random.default_rng(4)
    pools = {name: torch.from_numpy(
        rng.standard_normal(leaf.shape).astype(np.float32))
        for name, leaf in jax_init_cache(jkv).items()}
    pc = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], dim=2)
          for k, v in pools.items()}
    bt = torch.from_numpy(rng.permutation(33 * 4).reshape(33, 4)
                          .astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((33, 4, 32)).astype(np.float32))
    lp = {k: v[0] for k, v in PARAMS["layers"].items()}
    lens = torch.from_numpy(rng.integers(0, 12, 33).astype(np.int32))
    n_fed = torch.from_numpy(rng.integers(1, 5, 33).astype(np.int32))
    active = torch.ones(33, dtype=torch.bool)
    active[7] = False
    wide = {k: v[0].clone() for k, v in pc.items()}
    got = fused_layer_verify(x, lp, wide, CFG, kv, bt, lens, n_fed, active)
    assert got[0].shape == (33, 4, 32)
    for i in (0, 7, 16, 32):
        alone = {k: v[0].clone() for k, v in pc.items()}
        one = fused_layer_verify(x[i:i + 1], lp, alone, CFG, kv, bt[i:i + 1],
                                 lens[i:i + 1], n_fed[i:i + 1],
                                 active[i:i + 1])
        for a, b in zip(got, one):
            assert torch.equal(a[i:i + 1], b), i
    for name in wide:
        for i in range(33):
            for w in range(int(n_fed[i]) if active[i] else 0):
                pos = int(lens[i]) + w
                blk, off = int(bt[i, pos // 4]), pos % 4
                assert torch.equal(wide[name][:, blk, off],
                                   got[1 if name == "k" else 2][i, w])


def _c_entry_accepts(cfg, kv_cfg) -> bool:
    """A mirror of what csrc/megakernel.cu's fused_layer_fwd and its
    launch accept, from the constants in that source: the shape rules of
    the C entry, then the shared memory its launch needs (the attention
    walk's layout at the head dim's bucket, the codec's vectors, a GEMM
    phase's fewest rows of the widest K beside the ring and the warp sums)
    within its budget."""
    import pathlib
    import re
    src = (pathlib.Path(mk.__file__).resolve().parent.parent / "csrc"
           / "megakernel.cu").read_text()
    budget = int(re.search(r"kSmemBudget = (\d+);", src).group(1))
    gemm = {}
    for tname, body in re.findall(r"struct Gemm<(\w+)> \{(.*?)\};", src,
                                  re.S):
        vals = dict(re.findall(r"(\w+) = (\d+)", body))
        gemm[tname] = {k: int(v) for k, v in vals.items()}
    # a type that takes another's geometry: struct Gemm<A> : Gemm<B> {};
    for tname, base in re.findall(r"struct Gemm<(\w+)> : Gemm<(\w+)> \{\};",
                                  src):
        gemm[tname] = gemm[base]
    h, heads, d, f = (cfg.hidden, cfg.num_heads, cfg.head_dim,
                      cfg.ffn_hidden)
    if h != heads * d or d % 8 or f % 8 or f <= 0:
        return False
    bf16 = cfg.dtype in (torch.bfloat16, torch.float16)  # a half type
    g = gemm[{torch.float32: "float", torch.bfloat16: "bf16",
              torch.float16: "__half"}[cfg.dtype]]
    esz = 2 if bf16 else 4

    def gemm_bytes(kw, k, rows, ln, raw=False):
        kc = g["KC"]
        as_ = rows * (kw + g["APAD"]) * esz
        ring, red = g["STAGES"] * kc * 16 * esz, 8 * 16 * rows * 4
        lnw = -(-(2 * k * esz) // 16) * 16 if ln else 0
        # an LN of fp32 rows into bf16 stages one raw row at the least
        return (as_ + ring + red + lnw + -(-(4 * rows) // 16) * 16
                + (k * 4 if raw else 0))

    def phase_bytes(k, split, ln):
        kc, nch, s = g["KC"], -(-k // g["KC"]), 1
        while split and s < nch and gemm_bytes(
                -(-nch // s) * kc, k, g["RC_MAX"], False) > budget:
            s += 1
        return gemm_bytes(-(-nch // s) * kc, k, g["RC_MIN"], ln, ln and bf16)

    mode = 0 if not kv_cfg.quantized else (2 if kv_cfg.bits == 4 else 1)
    db = next((b for b in (64, 128, 256) if d <= b), 0)
    if db == 0:
        att = (8 * 128 + 32 * 132) * 4
    else:
        qb, tile, tp = ((2 * 32 * (db + 8) * 2, 64 * (db + 8) * 2, 64)
                        if bf16 else (8 * db * 4, 32 * (db + 4) * 4, 32))
        lim, deep, shallow = map(int, re.search(
            r"kWalkRing = DB <= (\d+) \? (\d+) : (\d+);", src).groups())
        ring = deep if db <= lim else shallow
        att = qb + 2 * (ring if mode == 0 else 1) * tile
        if mode:
            rs = -(-(db if mode == 1 else db // 2) // 16) * 16
            sb = 4 if mode == 1 else 2 * (d // kv_cfg.kv_group)
            sw = -(-(sb + 2) // 4) * 4 if sb % 4 else sb
            att = (-(-(att + 2 * ring * tp * (rs + sw)) // 16) * 16
                   + ring * tp * 4)
    need = max(att, 8 * 2 * d * 4 if mode else 0, phase_bytes(h, False, True),
               phase_bytes(h, True, False), phase_bytes(f, True, False))
    return need <= budget


def test_megakernel_gate_agrees_with_the_kernels_limits(monkeypatch):
    """Over head dims 8-1024, 1-64 heads, the three types and every pool
    format, the gate (where the kernel itself must run) admits exactly
    the shapes the C entry and its launch take, mirrored from the
    source's constants; every refusal names the shared memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = {True: 0, False: 0}
    for d in (8, 16, 40, 64, 80, 96, 128, 136, 200, 256, 264, 320, 512,
              1024):
        for heads in (1, 2, 12, 25, 64):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                for mode in KV_MODES:
                    cfg = GPTConfig(hidden=heads * d, num_heads=heads,
                                    vocab_size=97, dtype=dt)
                    kvc = KVCacheConfig(num_layers=12, num_heads=heads,
                                        head_dim=d, num_blocks=8,
                                        block_size=16, dtype=dt,
                                        **KV_MODES[mode])
                    reason = megakernel_refusal(cfg, kvc,
                                                allow_interpret=False,
                                                q=5, slots=32)
                    ok = _c_entry_accepts(cfg, kvc)
                    assert (reason is None) == ok, (d, heads, dt, mode,
                                                    reason)
                    if reason is not None:
                        assert "shared memory" in reason
                    seen[ok] += 1
    assert seen[True] and seen[False]


def test_fused_layer_reference_keeps_q_and_residual_fp32():
    """bf16: the plain version rounds where the kernel does — K, V and x'
    in bf16 — and keeps q and the residual fp32, so it differs from the
    per-op layer (which rounds both) but not by more than bf16 noise."""
    cfg = GPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=1,
                    num_heads=4, dtype=torch.bfloat16)
    params = init_gpt_params(cfg, seed=1, device="cpu")
    kv = KVCacheConfig(num_layers=1, num_heads=4, head_dim=8, num_blocks=4,
                       block_size=8, dtype=torch.bfloat16)
    cl = {"k": torch.zeros(4, 5, 8, 8, dtype=torch.bfloat16),
          "v": torch.zeros(4, 5, 8, 8, dtype=torch.bfloat16)}
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn(2, 1, 32, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    xo, k, v = fused_layer_reference(x, lp, cl, cfg, kv, _t([[0, 1], [2, 3]]),
                                     _t([0, 0]), None, _t([True, True]))
    assert xo.dtype == k.dtype == v.dtype == torch.bfloat16
    assert torch.equal(cl["k"][:, 0, 0], k[0, 0])
    assert torch.isfinite(xo.float()).all()


# ---------------------------------------------------------------------------
# engine


def _engine(megakernel, sampling=None, **kw):
    scfg = ServeConfig(num_slots=3, block_size=8, prefill_chunk=8,
                       megakernel=megakernel,
                       sampling=sampling or SamplingConfig(), **kw)
    return InferenceEngine(PARAMS, CFG, scfg, device="cpu")


def _run(eng):
    return eng.run([Request(u, p, max_new_tokens=m) for u, p, m in REQS])


@pytest.mark.parametrize("sampling", [
    SamplingConfig(), SamplingConfig(temperature=0.8, top_k=20)])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_streams_equal_megakernel_on_off(sampling, spec_k):
    """Greedy and sampled streams equal request for request between the
    fused and the per-op engine, with and without speculation."""
    outs = {}
    for mode in ("on", "off"):
        eng = _engine(mode, sampling=sampling, spec_k=spec_k)
        outs[mode] = _run(eng)
        assert eng.megakernel_enabled == (mode == "on")
        if spec_k and sampling.temperature == 0.0:
            assert eng.stats()["speculative"]["verify_steps"] > 0
    assert outs["on"] == outs["off"]


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_engine_streams_equal_with_speculation_and_quant_kv(kv_quant):
    outs = {}
    for mode in ("on", "off"):
        outs[mode] = _run(_engine(mode, spec_k=2, kv_quant=kv_quant))
    assert outs["on"] == outs["off"]


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_engine_fused_streams_match_jax_fused_engine(kv_quant):
    """The port's fused engine against JAX's megakernel='on' engine
    (Pallas interpret): greedy streams token for token, spec_k 2."""
    from apex_tpu.serve import InferenceEngine as JEngine
    from apex_tpu.serve import Request as JRequest
    from apex_tpu.serve import ServeConfig as JServeConfig

    scfg = dict(num_slots=3, block_size=8, prefill_chunk=8, spec_k=2,
                megakernel="on", kv_quant=kv_quant)
    jeng = JEngine(JPARAMS, JCFG, JServeConfig(**scfg))
    want = jeng.run([JRequest(u, p, max_new_tokens=m) for u, p, m in REQS])
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(**scfg), device="cpu")
    assert _run(eng) == want
    assert eng.stats()["megakernel"] is jeng.stats()["megakernel"] is True


def test_kernel_fields_report_the_path():
    """decode_kernel / verify_kernel in the engine and its stats()."""
    on = _engine("on", spec_k=2)
    assert on.decode_kernel == on.verify_kernel == "fused"
    st = on.stats()
    assert st["decode_kernel"] == st["verify_kernel"] == "fused"
    assert st["megakernel"] is True
    assert _engine("on").verify_kernel is None
    off = _engine("off", spec_k=2)
    assert off.decode_kernel == off.verify_kernel == "plain"
    assert off.stats()["megakernel"] is False


def test_auto_on_the_cpu_is_per_op_without_a_warning(caplog):
    with caplog.at_level(logging.WARNING, logger="apex_tpu_torch.serve"):
        eng = _engine("auto", spec_k=2)
    assert eng.megakernel_enabled is False and eng.decode_kernel == "plain"
    assert not caplog.records


def test_auto_fallback_on_a_cuda_engine_warns_once(monkeypatch, caplog):
    """On a CUDA engine (its device and CUDA's presence simulated here)
    ``auto`` takes the kernel at every head_dim % 8 (8 here, which the
    first Hopper kernel refused); a shape the kernel refuses (its shared
    memory, at an fp32 hidden of 8,192: 8 normalized rows do not fit)
    falls back to per-op with the reason, logged once per reason."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mk, "_FALLBACK_WARNED", set())
    eng = _engine("auto", spec_k=2)
    eng.device = torch.device("cuda", 0)
    with caplog.at_level(logging.WARNING, logger="apex_tpu_torch.serve"):
        assert eng._resolve_megakernel() is True
    assert not caplog.records
    eng.cfg = GPTConfig(vocab_size=97, max_seq=64, hidden=8192,
                        num_layers=2, num_heads=64, dtype=torch.float32)
    eng.kv_cfg = KVCacheConfig(num_layers=2, num_heads=64, head_dim=128,
                               num_blocks=8, block_size=8,
                               dtype=torch.float32)
    with caplog.at_level(logging.WARNING, logger="apex_tpu_torch.serve"):
        assert eng._resolve_megakernel() is False
        assert eng._resolve_megakernel() is False
    assert len(caplog.records) == 1
    assert "shared memory" in caplog.records[0].getMessage()


def test_megakernel_refusal_reasons(monkeypatch):
    """JAX's shape rules, then (where the kernel itself must run) the
    Hopper kernel's own limits, each with its reason; 'on' raises with
    it."""
    _, kv = _kv("none")
    assert megakernel_ok(CFG, kv)
    moe = GPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                    num_heads=4, num_experts=2, dtype=torch.float32)
    assert "dense FFN" in megakernel_refusal(moe, kv)
    odd = GPTConfig(vocab_size=97, max_seq=64, hidden=36, num_layers=2,
                    num_heads=4, dtype=torch.float32)
    kv9 = KVCacheConfig(num_layers=2, num_heads=4, head_dim=9, num_blocks=8,
                        block_size=8, dtype=torch.float32)
    assert "multiple of 8" in megakernel_refusal(odd, kv9)
    with pytest.raises(ValueError, match="megakernel='on'.*head_dim"):
        InferenceEngine(init_gpt_params(odd, seed=0, device="cpu"), odd,
                        ServeConfig(num_slots=1, block_size=8,
                                    megakernel="on"), device="cpu")
    kv_wide = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                            num_blocks=8, block_size=8, dtype=torch.float32)
    wide = GPTConfig(vocab_size=97, max_seq=64, hidden=32, num_layers=2,
                     num_heads=2, dtype=torch.float32)
    assert "head_dim" in megakernel_refusal(wide, kv_wide)
    if not torch.cuda.is_available():
        assert "no CUDA device" in megakernel_refusal(
            CFG, kv, allow_interpret=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # every head_dim % 8 and any row count: head_dim 8 here, GPT-2-124M at
    # 32 slots of spec_k + 1 = 5 rows (160 a call), head_dim 80 and 2 x 320
    assert megakernel_refusal(CFG, kv, allow_interpret=False) is None
    flag = GPTConfig()                   # GPT-2-124M, bf16
    kv_flag = KVCacheConfig(num_layers=12, num_heads=12, head_dim=64,
                            num_blocks=64, block_size=16)
    assert megakernel_ok(flag, kv_flag, allow_interpret=False, q=5, slots=8)
    assert megakernel_refusal(flag, kv_flag, allow_interpret=False, q=5,
                              slots=32) is None
    for hidden, heads in ((960, 12), (640, 2)):
        for dt in (torch.float32, torch.bfloat16):
            cfg = GPTConfig(hidden=hidden, num_heads=heads, dtype=dt)
            kvc = KVCacheConfig(num_layers=12, num_heads=heads,
                                head_dim=hidden // heads, num_blocks=64,
                                block_size=16, dtype=dt)
            assert megakernel_refusal(cfg, kvc, allow_interpret=False, q=5,
                                      slots=32) is None, (hidden, dt)


@pytest.mark.parametrize("what", ["dtype", "shared memory"])
def test_megakernel_refuses_the_dtype_and_its_shared_memory(monkeypatch,
                                                            what):
    """The two refusals left where the kernel itself must run, each named
    in its reason: pools in a type other than the model's (fp32, bf16 and
    fp16 models each take their own), and a shape whose shared memory
    (reported in bytes) is over the kernel's budget."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    if what == "dtype":
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            cfg = GPTConfig(dtype=dt)
            kvc = KVCacheConfig(num_layers=12, num_heads=12, head_dim=64,
                                num_blocks=8, dtype=dt)
            assert megakernel_refusal(cfg, kvc, allow_interpret=False) \
                is None, dt
        for model, pool in ((torch.float16, torch.bfloat16),
                            (torch.bfloat16, torch.float32),
                            (torch.float16, torch.float32)):
            kvc = KVCacheConfig(num_layers=12, num_heads=12, head_dim=64,
                                num_blocks=8, dtype=pool)
            assert "fp32, bf16 or fp16" in megakernel_refusal(
                GPTConfig(dtype=model), kvc, allow_interpret=False)
        return
    big = GPTConfig(hidden=64 * 1024, num_heads=512, vocab_size=128)
    kv_big = KVCacheConfig(num_layers=12, num_heads=512, head_dim=128,
                           num_blocks=8)
    reason = megakernel_refusal(big, kv_big, allow_interpret=False)
    assert "shared memory" in reason
    need = mk.kernel_smem_bytes(64 * 1024, 128, 4 * 64 * 1024,
                                torch.bfloat16)
    assert need > mk.SMEM_LIMIT_BYTES and f"{need} B" in reason
    assert megakernel_ok(big, kv_big)    # the plain version takes it


def test_fused_programs_raise_on_an_unsupported_shape():
    odd = GPTConfig(vocab_size=97, max_seq=64, hidden=36, num_layers=1,
                    num_heads=4, dtype=torch.float32)
    kv9 = KVCacheConfig(num_layers=1, num_heads=4, head_dim=9, num_blocks=4,
                        block_size=8, dtype=torch.float32)
    params = init_gpt_params(odd, seed=0, device="cpu")
    from apex_tpu_torch.serve import init_kv_cache
    with pytest.raises(ValueError, match="megakernel unsupported"):
        gpt_decode_step_fused(params, _t([1]), _t([0]), _t([True]),
                              init_kv_cache(kv9, "cpu"), _t([[0]]), odd, kv9)
