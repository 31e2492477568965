"""apex_tpu_torch's packed variable-length attention (``ops.attention_varlen``
and ``contrib.fmha``) on the CPU, against apex_tpu.

The same numpy inputs go through the JAX function and its port. The JAX
side runs as its own tests run it (``tests/test_attention_varlen.py``):
``flash_attention_varlen(..., use_pallas=True, interpret=True)`` (the
varlen Pallas kernels B #9-11 in interpret mode) and ``fmha_packed(...,
use_pallas=True)``. The port runs on CPU tensors, so its wrappers take the
kernels' plain PyTorch versions; the CUDA kernels are held against those
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerance: fp32, atol 2e-5 and rtol 1e-5 (sums over up to 320 keys in
another order and another tiling).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib.fmha import cu_seqlens_to_segment_ids as jax_cu_to_seg
from apex_tpu.contrib.fmha import fmha_packed as jax_fmha
from apex_tpu.ops import attention_varlen as jvl

from apex_tpu_torch.contrib.fmha import (FMHA, cu_seqlens_to_segment_ids,
                                         fmha_packed)
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops import attention_varlen as vl

ATOL, RTOL = 2e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _packed_segs(rng, b, s, lo, hi, pad):
    """(b, s) int32: contiguous documents of lengths in [lo, hi], then
    ``pad`` tokens of padding (-1)."""
    rows = []
    for _ in range(b):
        row, doc = [], 0
        while len(row) < s - pad:
            n = min(int(rng.integers(lo, hi + 1)), s - pad - len(row))
            row += [doc] * n
            doc += 1
        rows.append(row + [-1] * (s - len(row)))
    return np.asarray(rows, np.int32)


def _inputs(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(4)], rng


def _port_varlen(q, k, v, do, seg, causal):
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = vl.flash_attention_varlen(*leaves, _t(seg), causal=causal)
    o.backward(_t(do))
    return [o] + [t.grad for t in leaves]


def _jax_varlen(q, k, v, do, seg, causal):
    o, vjp = jax.vjp(lambda q, k, v: jvl.flash_attention_varlen(
        q, k, v, jnp.asarray(seg), causal=causal, use_pallas=True,
        interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    return [o, *vjp(jnp.asarray(do))]


def _close_all(got, want):
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_matches_jax_kernel(causal):
    """o and dq, dk, dv of the port's ``flash_attention_varlen`` (plain
    versions of B #9-11) vs ``jax.vjp`` of JAX's interpret-mode kernels:
    2 rows of 2 heads, 320 packed tokens of documents of 5-90 tokens and a
    pad tail of 37."""
    (q, k, v, do), rng = _inputs(1, 2, 2, 320, 32)
    seg = _packed_segs(rng, 2, 320, 5, 90, 37)
    _close_all(_port_varlen(q, k, v, do, seg, causal),
               _jax_varlen(q, k, v, do, seg, causal))


@pytest.mark.parametrize("d", [192, 256])
def test_varlen_head_dims_up_to_256_match_jax_kernel(d):
    """Head dims 192 and 256 (the varlen kernels' D = 256 instantiation on
    the card): o and every gradient vs JAX's interpret-mode kernels, one
    row of 2 heads, 128 packed tokens, causal."""
    (q, k, v, do), rng = _inputs(d, 1, 2, 128, d)
    seg = _packed_segs(rng, 1, 128, 10, 60, 9)
    _close_all(_port_varlen(q, k, v, do, seg, True),
               _jax_varlen(q, k, v, do, seg, True))


@pytest.mark.parametrize("total", [130, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_varlen_misaligned_total_matches_jax(total, causal):
    """A packed length that is not a multiple of the 64-row tile (nor, at
    130, of JAX's 8): the port pads to its tile with segment -1 and slices
    back, JAX to its own; results and gradients agree and keep the
    caller's length."""
    (q, k, v, do), rng = _inputs(2, 1, 2, total, 32)
    seg = _packed_segs(rng, 1, total, 20, 70, 10)
    got = _port_varlen(q, k, v, do, seg, causal)
    assert got[0].shape == (1, 2, total, 32)
    assert all(g.shape == (1, 2, total, 32) for g in got[1:])
    _close_all(got, _jax_varlen(q, k, v, do, seg, causal))


def test_varlen_pad_rows_zero_and_segments_isolated():
    """Pad queries output exactly 0 and pad keys get exactly zero
    gradient; changing one document's tokens leaves the others' outputs
    bitwise unchanged."""
    (q, k, v, do), _ = _inputs(3, 1, 2, 96, 32)
    seg = np.asarray([[0] * 30 + [1] * 40 + [-1] * 26], np.int32)
    o, dq, dk, dv = _port_varlen(q, k, v, do, seg, False)
    for t in (o, dq, dk, dv):
        assert not bool(t[:, :, 70:].any())
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 30:70] += 1.0
    v2[:, :, 30:70] -= 1.0
    o2 = vl.flash_attention_varlen(_t(q), _t(k2), _t(v2), _t(seg))
    assert torch.equal(o2[:, :, :30], o[:, :, :30].detach())
    assert not torch.equal(o2[:, :, 30:70], o[:, :, 30:70].detach())


def test_varlen_plain_versions_match_jax_reference():
    """The kernels' plain versions on a 64-aligned row (no padding) vs JAX's
    dense ``attention_varlen_reference`` and, for lse, its interpret-mode
    forward kernel: o, and lse (NEG_INF on pad rows)."""
    (q, k, v, _), rng = _inputs(4, 1, 2, 128, 32)
    seg = _packed_segs(rng, 1, 128, 10, 50, 20)
    scale = 32 ** -0.5
    for causal in (False, True):
        o, lse = vl.flash_varlen_fwd_reference(
            _t(q), _t(k), _t(v), _t(seg), _t(seg), scale, causal)
        want = jvl.attention_varlen_reference(
            *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(seg),
            causal=causal)
        np.testing.assert_allclose(_np(o), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
        _, lse_j = jvl._vl_call(*(jnp.asarray(a) for a in (q, k, v)),
                                jnp.asarray(seg), jnp.asarray(seg), scale,
                                causal, 64, 128, True)
        np.testing.assert_allclose(_np(lse), np.asarray(lse_j), atol=ATOL,
                                   rtol=RTOL)
        assert bool((lse[0, :, 108:] == vl.NEG_INF).all())


def test_varlen_head_dim_not_multiple_of_8_takes_the_reference():
    """head_dim % 8 != 0: the dense reference on both sides, as JAX routes
    it."""
    (q, k, v, _), rng = _inputs(5, 1, 2, 40, 12)
    seg = _packed_segs(rng, 1, 40, 5, 15, 4)
    got = vl.flash_attention_varlen(_t(q), _t(k), _t(v), _t(seg),
                                    causal=True)
    want = jvl.flash_attention_varlen(*(jnp.asarray(a) for a in (q, k, v)),
                                      jnp.asarray(seg), causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fmha_packed_matches_jax(causal):
    """``fmha_packed`` over (200, 3, 2, 32) with cu_seqlens [0, 37, 101,
    180] (20 pad tokens) vs JAX's ``fmha_packed(use_pallas=True)``: the
    output and the gradient of qkv; pad rows of both exactly 0. ``FMHA``
    has no parameters and returns the same."""
    rng = np.random.default_rng(6)
    qkv = rng.standard_normal((200, 3, 2, 32)).astype(np.float32)
    do = rng.standard_normal((200, 2, 32)).astype(np.float32)
    cu = np.asarray([0, 37, 101, 180], np.int32)
    x = _t(qkv).requires_grad_()
    o = fmha_packed(x, _t(cu), causal=causal)
    o.backward(_t(do))
    o_j, vjp = jax.vjp(lambda a: jax_fmha(a, jnp.asarray(cu), causal=causal,
                                          use_pallas=True), jnp.asarray(qkv))
    (g_j,) = vjp(jnp.asarray(do))
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(x.grad), np.asarray(g_j), atol=ATOL,
                               rtol=RTOL)
    assert not bool(o[180:].any()) and not bool(x.grad[180:].any())
    mod = FMHA(num_heads=2)
    assert list(mod.parameters()) == []
    assert torch.equal(mod(_t(qkv), _t(cu), causal=causal), o.detach())
    with pytest.raises(ValueError, match="total, 3, heads"):
        fmha_packed(_t(qkv)[:, :2], _t(cu))


@pytest.mark.parametrize("cu,total", [([0, 12, 30, 40], 48),
                                      ([0, 5], 5), ([0, 1, 2, 3], 9),
                                      ([0, 64, 128], 200)])
def test_cu_seqlens_to_segment_ids_matches_jax(cu, total):
    got = cu_seqlens_to_segment_ids(torch.tensor(cu), total)
    want = jax_cu_to_seg(jnp.asarray(cu, jnp.int32), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (32, 64), (64, 128)])
def test_block_skipping_tables_match_jax(causal, block_q, block_k):
    """``_block_ranges``, ``_interact_matrix`` and ``_live_range`` (both
    axes) equal JAX's on packed rows with pad tails, an all-pad row
    included (empty live ranges give 0, 0)."""
    rng = np.random.default_rng(7)
    seg = np.concatenate([_packed_segs(rng, 2, 256, 3, 100, 50),
                          np.full((1, 256), -1, np.int32)])
    ts, js = _t(seg), jnp.asarray(seg)
    qmin, qmax = vl._block_ranges(ts, block_q)
    kmin, kmax = vl._block_ranges(ts, block_k)
    jqmin, jqmax = jvl._block_ranges(js, block_q)
    jkmin, jkmax = jvl._block_ranges(js, block_k)
    for a, b in ((qmin, jqmin), (qmax, jqmax), (kmin, jkmin), (kmax, jkmax)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    inter = vl._interact_matrix(qmin, qmax, kmin, kmax, causal, block_q,
                                block_k)
    jinter = jvl._interact_matrix(jqmin, jqmax, jkmin, jkmax, causal,
                                  block_q, block_k)
    np.testing.assert_array_equal(inter.numpy(), np.asarray(jinter))
    for axis in (1, 2):
        for a, b in zip(vl._live_range(inter, axis),
                        jvl._live_range(jinter, axis)):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tile_tables_are_what_the_kernels_read():
    """``_tile_ranges`` packs, per 64-row tile, (min, max, live lo, live hi)
    of the q axis and of the k axis, from the same helpers, with the min
    over the tile's real tokens: equal to JAX's ranges where a tile holds
    no padding; a tile holding a document's end and padding meets only
    that document's tiles (JAX's -1 min would let it meet every tile), an
    all-pad tile none."""
    rng = np.random.default_rng(8)
    seg = _t(_packed_segs(rng, 2, 192, 10, 80, 30))
    qr, kr = vl._tile_ranges(seg, seg, True)
    assert qr.shape == (2, 3, 4) and kr.shape == (2, 3, 4)
    assert qr.dtype == kr.dtype == torch.int32
    mn, mx = vl._real_ranges(seg)
    jmn, jmx = vl._block_ranges(seg, 64)
    assert torch.equal(mx, jmx)
    no_pad = (seg >= 0).reshape(2, 3, 64).all(-1)
    assert torch.equal(mn[no_pad], jmn[no_pad])
    inter = vl._interact_matrix(mn, mx, mn, mx, True, 64, 64)
    for table, axis in ((qr, 2), (kr, 1)):
        lo, hi = vl._live_range(inter, axis)
        assert torch.equal(table, torch.stack([mn, mx, lo, hi], -1))
    # 3 documents of 100 tokens, then 84 pads: tile 4 (256-319) holds the
    # last document's end and padding, tile 5 only padding
    seg = torch.tensor([[0] * 100 + [1] * 100 + [2] * 100 + [-1] * 84],
                       dtype=torch.int32)
    qr, kr = vl._tile_ranges(seg, seg, False)
    assert qr[0, 4].tolist() == [2, 2, 3, 4]        # JAX's: [-1, 2, 0, 4]
    assert kr[0, 4].tolist() == [2, 2, 3, 4]
    jmn, jmx = vl._block_ranges(seg, 64)
    jinter = vl._interact_matrix(jmn, jmx, jmn, jmx, False, 64, 64)
    assert vl._live_range(jinter, 2)[0][0, 4] == 0
    assert qr[0, 5, 1] == -1 and qr[0, 5, 0] == torch.iinfo(torch.int32).max
    inter = vl._interact_matrix(*vl._real_ranges(seg), *vl._real_ranges(seg),
                                False, 64, 64)
    assert not bool(inter[0, 5].any()) and not bool(inter[0, :, 5].any())


def test_varlen_cpu_tensors_take_the_plain_versions():
    """On the CPU no kernel is launched, and the packed forward plus
    backward gives the same bits twice."""
    (q, k, v, do), rng = _inputs(9, 1, 2, 128, 32)
    seg = _packed_segs(rng, 1, 128, 10, 60, 8)
    before = ku.launch_counts()
    first = _port_varlen(q, k, v, do, seg, True)
    again = _port_varlen(q, k, v, do, seg, True)
    assert ku.launch_counts() == before
    for a, b in zip(first, again):
        assert torch.equal(a, b)
