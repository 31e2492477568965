"""apex_tpu_torch's blockwise codec (``comm.quantize``) on the CPU, against
apex_tpu.

The same numpy inputs go through the JAX codec and its port. The JAX side
runs as its own tests run it (``tests/test_comm.py``): ``use_pallas=True``
(the quantize and dequantize Pallas kernels B #17-18 in interpret mode).
The port runs on CPU tensors, so its wrappers take the kernels' plain
PyTorch versions (packed int4 included: the kernels write and read the
nibbles); the CUDA kernels are held against those bitwise on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``). The kernels'
own arithmetic — their geometry, and the quotient by a reciprocal and two
fused multiply-adds — is held here against its definition.

The deterministic codes and scales are held bitwise. Stochastic rounding
cannot be: JAX draws from the TPU core's PRNG (whose interpreter has no
CPU lowering) or threefry; the port from a counter hash of (seed,
element index). So the stochastic mode is held to what defines it: codes
⌊y⌋ or ⌈y⌉, an error below one step, the same bits for the same seed, new
bits for a new seed, and a mean error of 0 within 4σ over 64 seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.comm import quantize as jq

from apex_tpu_torch.comm import quantize as pq
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.serve import kv_cache

M32 = 0xFFFFFFFF


def _case(seed, rows, block, dtype, qmax):
    """(rows·block,) numpy input: normal values, one all-zero block, and
    one block whose amax is qmax (scale exactly 1) holding halves, so
    x/scale = k + ½ ties that round half to even."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(rows * block) * 3).astype(np.float32)
    x[:block] = 0
    ties = (np.arange(block) % 16 - 8 + 0.5).astype(np.float32)
    ties[0] = qmax
    x[block:2 * block] = np.clip(ties, -qmax, qmax)
    return np.asarray(jnp.asarray(x).astype(dtype))


def _port(a):
    from apex_tpu_torch.convert import tensor_from_numpy
    return tensor_from_numpy(a, torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,block", [(8, 256), (8, 128), (4, 128)])
def test_deterministic_codes_bitwise_jax_kernel(dtype, bits, block):
    """Codes and scales of the port (plain quantize) equal JAX's
    interpret-mode kernel bit for bit, ties included (half to even), for
    int8 and packed int4 at fp32 and bf16 input; an all-zero block has
    scale 1 and codes 0."""
    qmax = pq.qmax_for_bits(bits)
    x = _case(bits + block, 64, block, dtype, qmax)
    if bits == 8:
        q_j, s_j = jq.quantize_blockwise(jnp.asarray(x), block,
                                         use_pallas=True)
        q, s = pq.quantize_blockwise(_port(x), block, use_pallas=True)
        codes = q
    else:
        q_j, s_j = jq.quantize_blockwise_int4(jnp.asarray(x), block,
                                              use_pallas=True)
        q, s = pq.quantize_blockwise_int4(_port(x), block, use_pallas=True)
        codes = pq.unpack_int4(q)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert float(s[0]) == 1.0 and not bool(codes[:block].any())
    assert float(s[1]) == 1.0
    tie = torch.from_numpy(x[block:2 * block].astype(np.float32))
    want = torch.clamp(torch.round(tie), -qmax, qmax)   # half to even
    assert torch.equal(codes[block:2 * block].float(), want)
    assert int(codes.abs().max()) <= qmax


@pytest.mark.parametrize("bits,block", [(8, 256), (4, 128)])
def test_dequantize_bitwise_jax_kernel(bits, block):
    """codes × scale in fp32, bit for bit JAX's interpret-mode kernel."""
    x = _case(7, 32, block, "float32", pq.qmax_for_bits(bits))
    if bits == 8:
        q_j, s_j = jq.quantize_blockwise(jnp.asarray(x), block,
                                         use_pallas=True)
        y_j = jq.dequantize_blockwise(q_j, s_j, block, use_pallas=True)
        y = pq.dequantize_blockwise(_port(np.asarray(q_j)),
                                    _port(np.asarray(s_j)), block,
                                    use_pallas=True)
    else:
        q_j, s_j = jq.quantize_blockwise_int4(jnp.asarray(x), block,
                                              use_pallas=True)
        y_j = jq.dequantize_blockwise_int4(q_j, s_j, block, use_pallas=True)
        y = pq.dequantize_blockwise_int4(_port(np.asarray(q_j)),
                                         _port(np.asarray(s_j)), block,
                                         use_pallas=True)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_j))


@pytest.mark.parametrize("bits,block", [(8, 256), (4, 128)])
def test_reference_path_and_round_trip_error_match_jax(bits, block):
    """``use_pallas=False`` (and the default off the card) is JAX's
    reference: codes and scales bit for bit JAX's eager
    ``use_pallas=False`` (the scale a true quotient); the kernel path's
    scales are amax · fp32(1/qmax), one ulp apart in some blocks, as
    JAX's two paths are. ``quantization_error*`` equals JAX's eager
    round trip bitwise and its jitted one (where XLA takes the
    reciprocal and may fuse the multiply-subtract) within 1e-5."""
    qmax = pq.qmax_for_bits(bits)
    x = _case(8, 64, block, "float32", qmax)
    jfn, pfn = ((jq.quantize_blockwise, pq.quantize_blockwise) if bits == 8
                else (jq.quantize_blockwise_int4,
                      pq.quantize_blockwise_int4))
    jdq, pdq = ((jq.dequantize_blockwise, pq.dequantize_blockwise)
                if bits == 8 else (jq.dequantize_blockwise_int4,
                                   pq.dequantize_blockwise_int4))
    q_j, s_j = jfn(jnp.asarray(x), block, use_pallas=False)
    for use_pallas in (False, None):
        q, s = pfn(_port(x), block, use_pallas=use_pallas)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    _, s_k = pfn(_port(x), block, use_pallas=True)
    ulps = np.abs(s_k.numpy().view(np.int32) - np.asarray(s_j).view(np.int32))
    assert ulps.max() <= 1
    err_j = x - np.asarray(jdq(q_j, s_j, block, use_pallas=False))
    perr = (pq.quantization_error if bits == 8
            else pq.quantization_error_int4)
    jerr = (jq.quantization_error if bits == 8
            else jq.quantization_error_int4)
    err = perr(_port(x), block)
    np.testing.assert_array_equal(err.numpy(), err_j)
    np.testing.assert_allclose(err.numpy(),
                               np.asarray(jerr(jnp.asarray(x), block)),
                               atol=1e-5)


def _hash_reference(seed, i):
    """The stochastic draw's bits for element i, in Python ints."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & M32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & M32
        return h ^ (h >> 16)
    key = fmix(seed & M32)
    return fmix((key + (i & M32) * 0x9E3779B1 + (i >> 32) * 0x85EBCA77)
                & M32)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, -5])
def test_uniform_from_seed_is_the_counter_hash(seed):
    """u[i] = (fmix32(fmix32(seed) + i·0x9E3779B1) >> 8) · 2⁻²⁴, exactly,
    in [0, 1) — the bits the CUDA kernel draws."""
    u = pq.uniform_from_seed(seed, 4096)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    for i in (0, 1, 2, 255, 256, 4095):
        assert float(u[i]) == (_hash_reference(seed, i) >> 8) * 2.0 ** -24


@pytest.mark.parametrize("bits", [8, 4])
def test_stochastic_codes_are_floor_or_ceil(bits):
    """Each stochastic code is ⌊y⌋ or ⌈y⌉ of y = x/scale (so its error is
    below one step, |q·scale − x| < scale), on the same scales as the
    deterministic mode; nearest rounding is one of the two."""
    block = 128
    qmax = pq.qmax_for_bits(bits)
    x = _port(_case(11, 64, block, "float32", qmax))
    q, s = pq.quantize_blocks_reference(x.reshape(-1, block), qmax, seed=3)
    qn, sn = pq.quantize_blocks_reference(x.reshape(-1, block), qmax)
    assert torch.equal(s, sn)
    y = x.reshape(-1, block) / s[:, None]
    qf = q.float()
    assert bool(((qf == torch.floor(y)) | (qf == torch.ceil(y))).all())
    err = (qf * s[:, None] - x.reshape(-1, block)).abs()
    assert bool((err < s[:, None]).all())
    assert bool((qn.float() - qf).abs().max() <= 1)
    if bits == 4:
        packed, s4 = pq.quantize_blockwise_int4(x, block, stochastic=True,
                                                seed=3, use_pallas=True)
        assert torch.equal(pq.unpack_int4(packed), q.reshape(-1))
        assert torch.equal(s4, s)


def test_stochastic_same_seed_same_bits_new_seed_new_bits():
    x = _port(_case(12, 32, 256, "float32", 127.0))
    a = pq.quantize_blockwise(x, stochastic=True, seed=5)
    b = pq.quantize_blockwise(x, stochastic=True, seed=5)
    c = pq.quantize_blockwise(x, stochastic=True, seed=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    differ = (a[0] != c[0]).float().mean().item()
    assert differ > 0.2, differ          # about half the codes move
    assert torch.equal(a[1], c[1])


@pytest.mark.parametrize("bits", [8, 4])
def test_stochastic_rounding_is_unbiased(bits):
    """Over 64 seeds the mean error is 0 within 4σ. In steps of the scale,
    element e's error q − y has mean 0 and variance f(1−f) (f the
    fractional part of y = x/scale), so the mean over all N elements and
    64 seeds has σ = sqrt(Σ f(1−f) / 64) / N. Nearest rounding also
    averages to about 0 over random data, so each element's own mean over
    the seeds is held too: on average within 0.1 step of 0 (expected ≈
    0.04 at 64 seeds), where nearest rounding's error is ≈ 0.25."""
    block, seeds = 128, 64
    qmax = pq.qmax_for_bits(bits)
    x = _port(_case(13, 32, block, "float32", qmax)).reshape(-1, block)
    errs = []
    for seed in range(seeds):
        q, s = pq.quantize_blocks_reference(x, qmax, seed=seed)
        y = x / s[:, None]
        errs.append(q.double() - y.double())
    per_elem = torch.stack(errs).mean(0)
    f = y.double() - torch.floor(y.double())
    n = per_elem.numel()
    sigma = float(torch.sqrt((f * (1 - f)).sum() / seeds)) / n
    assert abs(float(per_elem.mean())) <= 4 * sigma, (per_elem.mean(), sigma)
    assert float(per_elem.abs().mean()) < 0.1
    nearest = (torch.round(y.double()) - y.double()).abs().mean()
    assert float(nearest) > 0.2


@pytest.mark.parametrize("which", ["quantize", "dequantize", "int4",
                                   "int4_dequantize"])
def test_use_pallas_true_outside_the_gate_raises_like_jax(which):
    """JAX's ``ValueError`` word for word where its gate refuses (block %
    128, rows % 32)."""
    x = np.zeros(100, np.float32)
    calls = {
        "quantize": (lambda m, t: m.quantize_blockwise(t, 10,
                                                       use_pallas=True)),
        "dequantize": (lambda m, t: m.dequantize_blockwise(
            t.astype(jnp.int8) if m is jq else t.to(torch.int8), t[:10],
            10, use_pallas=True)),
        "int4": (lambda m, t: m.quantize_blockwise_int4(t, 10,
                                                        use_pallas=True)),
        # 100 packed bytes: JAX gates the 200 unpacked codes
        "int4_dequantize": (lambda m, t: m.dequantize_blockwise_int4(
            t.astype(jnp.uint8) if m is jq else t.to(torch.uint8), t[:20],
            10, use_pallas=True)),
    }
    with pytest.raises(ValueError) as want:
        calls[which](jq, jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        calls[which](pq, _port(x))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,block", [(32 * 256, 256), (16 * 256, 256),
                                     (64 * 128, 128), (32 * 64, 64),
                                     (100, 10), (33 * 128, 128),
                                     (32 * 384, 384)])
def test_codec_gate_matches_jax(n, block):
    assert pq._pallas_ok(n, block) == jq._pallas_ok(n, block,
                                                    allow_interpret=True)
    assert pq._ROWS_PER_STEP == jq._ROWS_PER_STEP


def test_cpu_tensors_take_the_plain_versions():
    """Inside the gate a CPU tensor runs the plain versions, counting no
    launch; the kernel wrappers refuse CPU tensors."""
    x = torch.randn(32 * 256)
    before = ku.launch_counts()
    q, s = pq.quantize_blockwise(x, use_pallas=True)
    pq.quantize_blockwise(x, stochastic=True, seed=1)
    pq.dequantize_blockwise(q, s)
    assert ku.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        pq.quantize_blocks(x.reshape(-1, 256))
    with pytest.raises(ValueError, match="CUDA"):
        pq.dequantize_blocks(q.reshape(-1, 256), s)


def test_kv_path_calls_the_codec_with_use_pallas_false(monkeypatch):
    """The quantized KV pools quantize through the codec with
    ``use_pallas=False``, as JAX's KV path does, so the codec kernels'
    dispatch never moves the pools' path."""
    seen = []
    real = kv_cache.quantize_blockwise

    def spy(*a, **kw):
        seen.append(kw.get("use_pallas", "default"))
        return real(*a, **kw)

    monkeypatch.setattr(kv_cache, "quantize_blockwise", spy)
    q, s = kv_cache._quant_rows(torch.randn(2, 32, 128))
    assert seen == [False] and q.shape == (2, 32, 128) and s.shape == (2, 32)


# ---------------------------------------------------------------------------
# packed int4 in the kernels: the plain versions, the dispatch, the
# geometry and the quotient


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [128, 256])
def test_packed_plain_versions_match_jax_int4(dtype, group):
    """The packed plain versions (what the kernels compute since they
    write and read the nibbles) are ``pack_int4`` / ``unpack_int4`` around
    the int8 plain versions, and bit for bit JAX's interpret-mode int4
    path: nearest codes and scales, ties (half to even) and an all-zero
    group included, and the dequantized values."""
    qmax = pq.QMAX4
    x = _case(group + 3, 64, group, dtype, qmax)
    x2d = _port(x).reshape(-1, group)
    packed, s = pq.quantize_blocks_reference(x2d, qmax, packed=True)
    codes, s8 = pq.quantize_blocks_reference(x2d, qmax)
    assert packed.dtype == torch.uint8 and packed.shape == (64, group // 2)
    assert torch.equal(packed, pq.pack_int4(codes)) and torch.equal(s, s8)
    q_j, s_j = jq.quantize_blockwise_int4(jnp.asarray(x), group,
                                          use_pallas=True)
    np.testing.assert_array_equal(packed.reshape(-1).numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert float(s[0]) == 1.0 and not bool(packed[0].any())
    y = pq.dequantize_blocks_reference(packed, s, packed=True)
    assert torch.equal(y, pq.dequantize_blocks_reference(codes, s))
    y_j = jq.dequantize_blockwise_int4(q_j, s_j, group, use_pallas=True)
    np.testing.assert_array_equal(y.reshape(-1).numpy(), np.asarray(y_j))
    pub, s_pub = pq.quantize_blockwise_int4(_port(x), group, use_pallas=True)
    assert torch.equal(pub, packed.reshape(-1)) and torch.equal(s_pub, s)


def _as_card(monkeypatch, refuse_pack=True):
    """Route the codec's CPU tensors down the card's branch: the kernel
    wrappers become recorders that return the packed plain versions, and
    (``refuse_pack``) ``pack_int4`` / ``unpack_int4`` raise, so a test sees
    what the kernel path runs."""
    calls = []
    pack, unpack = pq.pack_int4, pq.unpack_int4

    def quantize(x2d, qmax=pq.QMAX, seed=None, packed=False):
        calls.append(("quantize", tuple(x2d.shape), packed))
        q, s = pq.quantize_blocks_reference(x2d, qmax, seed)
        return (pack(q) if packed else q), s

    def dequantize(q2d, scales, packed=False):
        calls.append(("dequantize", tuple(q2d.shape), packed))
        return pq.dequantize_blocks_reference(unpack(q2d) if packed else q2d,
                                              scales)

    def refuse(*a, **kw):
        raise AssertionError("a pack or unpack tensor op on the kernel path")

    monkeypatch.setattr(pq.ku, "use_kernel", lambda t: True)
    monkeypatch.setattr(pq, "quantize_blocks", quantize)
    monkeypatch.setattr(pq, "dequantize_blocks", dequantize)
    if refuse_pack:
        monkeypatch.setattr(pq, "pack_int4", refuse)
        monkeypatch.setattr(pq, "unpack_int4", refuse)
    return calls, pack, unpack


@pytest.mark.parametrize("stochastic", [False, True])
def test_int4_kernel_path_runs_no_pack_or_unpack(monkeypatch, stochastic):
    """Inside JAX's gate on the card, ``quantize_blockwise_int4`` returns
    the quantize kernel's nibbles as they are and
    ``dequantize_blockwise_int4`` hands the bytes to the dequantize kernel:
    one launch each, no ``pack_int4`` / ``unpack_int4`` tensor op; the
    values are the packed plain versions'."""
    x = _port(_case(21, 32, 128, "float32", pq.QMAX4))
    seed = 9 if stochastic else None
    want, want_s = pq.quantize_blocks_reference(x.reshape(-1, 128), pq.QMAX4,
                                                seed, packed=True)
    calls, _, unpack = _as_card(monkeypatch)
    packed, s = pq.quantize_blockwise_int4(x, 128, stochastic, seed)
    y = pq.dequantize_blockwise_int4(packed, s, 128)
    assert calls == [("quantize", (32, 128), True),
                     ("dequantize", (32, 64), True)]
    assert packed.shape == (32 * 64,) and packed.dtype == torch.uint8
    assert torch.equal(packed, want.reshape(-1)) and torch.equal(s, want_s)
    assert torch.equal(y, pq.dequantize_blocks_reference(
        unpack(want), want_s).reshape(-1))


@pytest.mark.parametrize("packed_bytes,group",
                         [(16 * 128, 128), (8 * 128, 128), (32 * 256, 256),
                          (16 * 256, 256), (32 * 192, 384), (50, 10)])
def test_int4_dequantize_gate_on_the_unpacked_length(monkeypatch,
                                                     packed_bytes, group):
    """``dequantize_blockwise_int4`` takes JAX's gate on n = 2 · the packed
    bytes (JAX unpacks before its gate): the kernel runs exactly where
    JAX's ``_pallas_ok(2 · bytes, group)`` holds, here 16 packed rows of
    128 (32 unpacked) but not 8; the values are the reference's either
    way."""
    rng = np.random.default_rng(packed_bytes)
    raw = rng.integers(0, 256, packed_bytes, dtype=np.uint8)
    raw = np.where((raw & 0xF) == 8, raw ^ 1, raw)     # codes in [-7, 7]
    raw = np.where((raw >> 4) == 8, raw ^ 0x10, raw).astype(np.uint8)
    scales = rng.random(2 * packed_bytes // group).astype(np.float32)
    inside = jq._pallas_ok(2 * packed_bytes, group, allow_interpret=True)
    want = pq.dequantize_blockwise(pq.unpack_int4(torch.from_numpy(raw)),
                                   torch.from_numpy(scales), group)
    calls, _, _ = _as_card(monkeypatch, refuse_pack=False)
    y = pq.dequantize_blockwise_int4(torch.from_numpy(raw),
                                     torch.from_numpy(scales), group)
    assert calls == ([("dequantize", (packed_bytes * 2 // group,
                                      group // 2), True)] if inside else [])
    assert torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", range(128, 4097, 128))
def test_quant_plan_gives_every_lane_whole_vectors(dtype, block):
    """At every (block, type) JAX's gate admits up to 4,096, the quantize
    kernel's geometry, walked as the kernel walks it (lane t of the team,
    vector t + j · team of chunk c), gives lanes whole 16-byte vectors and
    covers the row's vectors each once; a team is a power of 2 up to a
    warp, as the C entry takes it; at a power-of-2 row of 16-128 vectors
    every lane holds ``_VECS`` in one chunk, and a row of more vectors
    takes a whole warp."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = block // per
    team, _ = pq._quant_plan(block, dtype)
    assert 1 <= team <= 32 and team & (team - 1) == 0
    assert pq._CTA % team == 0
    span = team * pq._VECS
    chunks = -(-nvec // span)
    held = [c * span + t + j * team for c in range(chunks)
            for t in range(team) for j in range(pq._VECS)]
    assert sorted(v for v in held if v < nvec) == list(range(nvec))
    if nvec <= 128 and nvec & (nvec - 1) == 0:
        assert chunks == 1 and span == nvec
    if nvec > 128:
        assert team == 32


def _c_limits():
    """The C file's CTA size and vectors a lane, read from its source."""
    import pathlib
    import re
    src = (pathlib.Path(pq.__file__).parent.parent / "csrc"
           / "quantize.cu").read_text()
    return (int(re.search(r"kCta = (\d+);", src).group(1)),
            int(re.search(r"kVecs = (\d+);", src).group(1)))


def test_quant_plan_main_cells_and_limits():
    """The main path's cells hold 4 vectors (64 bytes of x) a lane: B 256
    a 16-lane team at fp32, 8 at bf16; G 128 8 and 4 lanes; one row a
    team, except bf16 stochastic (a resident grid). A non-power-of-2 row
    (384) takes the next power of 2 of lanes, a long one a warp with no
    upper limit (16,384: JAX's gate takes it); the Python constants are
    the C file's; a block that is no multiple of 128 raises."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert pq._quant_plan(256, f32) == (16, False)
    assert pq._quant_plan(256, f32, True) == (16, False)
    assert pq._quant_plan(256, bf16) == (8, False)
    assert pq._quant_plan(256, bf16, True) == (8, True)
    assert pq._quant_plan(128, f32) == (8, False)
    assert pq._quant_plan(128, bf16, True) == (4, True)
    assert pq._quant_plan(384, f32) == (32, False)   # 96 of 128 vectors
    assert pq._quant_plan(384, bf16) == (16, False)  # 48 of 64
    assert pq._quant_plan(2048, f32) == (32, False)
    assert pq._quant_plan(16384, bf16, True) == (32, True)
    assert _c_limits() == (pq._CTA, pq._VECS)
    with pytest.raises(ValueError, match="multiple of 128"):
        pq._quant_plan(200, f32)


# the quotient the kernel computes: one correctly rounded reciprocal a row
# and a correction by two fused multiply-adds, with its guards
_MAGIC = np.float32(12582912.0)


def _fma32(a, b, c):
    """float32 fma (one rounding of a·b + c) in numpy: the product is exact
    in float64, TwoSum gives the exact sum as s + err, and s is rounded to
    float32 with err deciding the ties that s lands on."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    with np.errstate(over="ignore", invalid="ignore"):
        f = s.astype(np.float32)
        up = f.astype(np.float64) < s
        g = np.where(up, np.nextafter(f, np.float32(np.inf)),
                     np.nextafter(f, np.float32(-np.inf)))
        mid = (f.astype(np.float64) + g.astype(np.float64)) / 2
        tie = (f.astype(np.float64) != s) & (s == mid) & (err != 0)
        other = np.where(err > 0, np.maximum(f, g), np.minimum(f, g))
        return np.where(tie, other, f).astype(np.float32)


def _recip_quotient(x2d, s):
    """y = x / s by the quantize kernel's reciprocal path (r = 1/s rounded
    once a row, q0 = x·r, y = fma(fma(−q0, s, x), r, q0)), and where it is
    the rounded quotient by the division's argument: the scale in [2^-60,
    2^60] and |q0| >= 2^-40 (or x = 0: y = ±0)."""
    s = s[:, None]
    with np.errstate(all="ignore"):
        r = np.float32(1) / s
        q0 = x2d * r
        y = _fma32(_fma32(-q0, s, x2d), r, q0)
        fast = (s >= np.float32(2.0 ** -60)) & (s <= np.float32(2.0 ** 60))
        exact = fast & ((np.abs(q0) >= np.float32(2.0 ** -40)) | (x2d == 0))
        return y, exact, fast


def _kernel_codes(x2d, qmax, u=None, per=4):
    """The quantize kernel's codes in numpy float32: its scale; y by the
    reciprocal path in rows whose scale is in [2^-60, 2^60], by division in
    the others and, stochastic, in each ``per``-element vector holding a
    draw u = 0; nearest y + 1.5·2^23 rounded to nearest, stochastic
    fma(u's 24 bits, 2^-32, y) then + 1.5·2^23 rounded down (M + ⌊z⌋ for
    |z| < 2^22); the clamp in that domain and the low byte of the bits."""
    amax = np.abs(x2d).max(axis=1)
    s = np.where(amax > 0, amax * (np.float32(1) / np.float32(qmax)),
                 np.float32(1)).astype(np.float32)
    y, _, fast = _recip_quotient(x2d, s)
    with np.errstate(all="ignore"):
        divide = np.broadcast_to(~fast, x2d.shape)
        if u is not None:
            zero = (u == 0).reshape(x2d.shape[0], -1, per).any(axis=2)
            divide = divide | np.repeat(zero, per, axis=1)
        y = np.where(divide, x2d / s[:, None], y)
        if u is None:
            m = y + _MAGIC
        else:
            z = _fma32(u * np.float32(2.0 ** 32), np.float32(2.0 ** -32), y)
            m = _MAGIC + np.floor(z)
        m = np.minimum(np.maximum(m, _MAGIC - np.float32(qmax)),
                       _MAGIC + np.float32(qmax)).astype(np.float32)
    bits = m.view(np.uint32) & 0xFF
    return bits.astype(np.uint8).view(np.int8), s


def _quotient_rows(case, qmax):
    rng = np.random.default_rng(len(case) + int(qmax))
    rows, block = 256, 256
    if case == "random":        # row maxima from 2^-70 to 2^70
        amax = (rng.random(rows) + 0.5) * 2.0 ** rng.integers(-70, 70, rows)
        x = (rng.random((rows, block)) * 2 - 1) * amax[:, None]
    elif case == "ties":        # k + ½ steps and their float neighbours
        s = np.float32(3.0) * np.float32(2.0) ** rng.integers(-30, 30, rows)
        k = rng.integers(-int(qmax), int(qmax), (rows, block)) + 0.5
        x = (k * s[:, None]).astype(np.float32)
        x = np.nextafter(x, x * rng.choice([-1.0, 0.0, 2.0], x.shape)
                         .astype(np.float32))
        x[:, 0] = qmax * s      # amax = qmax · s: scale s or an ulp off
    elif case == "subnormal":   # subnormal x in normal rows (whose
        # quotients underflow where the row's maximum is large); subnormal
        # rows
        x = rng.standard_normal((rows, block)) * 2.0 ** rng.integers(
            -149, -120, (rows, block))
        x[: rows // 4, 0] = rng.random(rows // 4) + 0.5
        x[rows // 4: rows // 2, 0] = 2.0 ** rng.integers(4, 40, rows // 4)
        x[rows // 2:] *= 2.0 ** -rng.integers(0, 20, (rows // 2, 1))
        # scale 1.55: -2^-149 / 1.55 rounds to -2^-149, the reciprocal path
        # to -0
        x[0] = -np.arange(block) * 2.0 ** -149
        x[0, 0] = 1.55 * qmax
    else:                       # all-zero rows, signed zeros, one large row
        x = np.zeros((rows, block))
        x[1::2, ::3] = -0.0
        x[-1] = rng.standard_normal(block) * 1e30
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["random", "ties", "subnormal", "zeros"])
def test_reciprocal_fma_quotient_is_the_ieee_quotient(case, bits):
    """The quantize kernel's quotient — r = 1/scale rounded once a row, q0
    = x·r, y = fma(fma(−q0, scale, x), r, q0) — emulated in numpy float32
    equals x / scale bit for bit (zeros up to sign) wherever the scale is
    in [2^-60, 2^60] and |q0| >= 2^-40, over random rows of every
    magnitude, ties and their neighbours, subnormal x and subnormal
    scales, and all-zero rows. Below 2^-40 it may not, and the kernel's
    codes (its division where the scale is out of range and, stochastic,
    in a vector holding a draw u = 0) equal the plain version's all the
    same: nearest and stochastic from a seed, and against the definition
    ⌊x/scale + u⌋ with u = 0 planted on tiny negative quotients."""
    qmax = pq.qmax_for_bits(bits)
    x2d = _quotient_rows(case, qmax)
    codes, s = _kernel_codes(x2d, qmax)
    y, exact, fast = _recip_quotient(x2d, s)
    with np.errstate(all="ignore"):
        want = x2d / s[:, None]
    same = (y.view(np.uint32) == want.view(np.uint32)) | ((y == 0)
                                                          & (want == 0))
    assert bool(same[exact].all()), (x2d[exact & ~same][:4])
    share = {"random": 0.8, "ties": 0.99, "subnormal": 0.0, "zeros": 0.99}
    assert exact.mean() >= share[case] and fast.mean() >= share[case]
    if case == "subnormal":   # tiny quotients in fast rows, and slow rows
        assert (fast & ~exact).any() and not fast.all()
    xt = torch.from_numpy(x2d)
    q, s_p = pq.quantize_blocks_reference(xt, qmax)
    np.testing.assert_array_equal(s, s_p.numpy())
    np.testing.assert_array_equal(codes, q.numpy())
    q, _ = pq.quantize_blocks_reference(xt, qmax, seed=17)
    u = pq.uniform_from_seed(17, x2d.size).numpy().reshape(x2d.shape)
    np.testing.assert_array_equal(_kernel_codes(x2d, qmax, u)[0], q.numpy())
    # u = 0 where the quotient is tiny and negative: floor gives -1 (or 0
    # for a quotient that rounds to -0), which only the division decides
    rng = np.random.default_rng(bits)
    u = rng.integers(1, 2 ** 24, x2d.shape).astype(np.float32) * 2.0 ** -24
    u = np.where((want < 0) & (want > -1e-20), np.float32(0),
                 u).astype(np.float32)
    with np.errstate(all="ignore"):
        ref = np.clip(np.floor(want + u), -qmax, qmax)
    ref = np.where(np.isnan(ref), -qmax, ref).astype(np.int8)
    np.testing.assert_array_equal(_kernel_codes(x2d, qmax, u)[0], ref)
