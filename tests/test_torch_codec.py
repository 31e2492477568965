"""apex_tpu_torch's blockwise codec (``comm.quantize``) on the CPU, against
apex_tpu.

The same numpy inputs go through the JAX codec and its port. The JAX side
runs as its own tests run it (``tests/test_comm.py``): ``use_pallas=True``
(the quantize and dequantize Pallas kernels B #17-18 in interpret mode).
The port runs on CPU tensors, so its wrappers take the kernels' plain
PyTorch versions; the CUDA kernels are held against those bitwise on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

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


@pytest.mark.parametrize("which", ["quantize", "dequantize", "int4"])
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
