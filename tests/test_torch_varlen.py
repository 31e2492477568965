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


# ---------------------------------------------------------------------------
# the route (bf16 up to head_dim 256 on the tensor cores, all three
# kernels) and emulations of the tensor-core kernels' owner-block walks


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 8, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 136, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.bfloat16, 264, "cuda_core"), (torch.bfloat16, 2056, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 256, "cuda_core"),
    (torch.float32, 4096, "cuda_core")])
def test_varlen_dkv_route(dtype, d, want):
    """bf16 at head_dim <= 256 runs the varlen kernels (dK/dV, the forward
    and dQ alike) on the tensor cores (``csrc/flash_varlen_mma.cu``); fp32
    at every head_dim and bf16 above 256 on the CUDA cores
    (``csrc/flash_varlen.cu``)."""
    assert vl._varlen_route(dtype, d) == want


@pytest.mark.parametrize("d", [36, 0, -8, 12])
def test_varlen_dkv_route_refuses_what_no_kernel_takes(d):
    with pytest.raises(ValueError,
                       match=f"head_dim {d} must be a positive multiple of 8"):
        vl._varlen_route(torch.bfloat16, d)


@pytest.mark.parametrize("dtype,d,entry", [
    (torch.bfloat16, 64, "flash_varlen_mma_bwd_dkv"),
    (torch.bfloat16, 256, "flash_varlen_mma_bwd_dkv"),
    (torch.bfloat16, 512, "flash_varlen_bwd_dkv"),
    (torch.float32, 64, "flash_varlen_bwd_dkv")])
def test_dkv_wrapper_launches_the_routed_entry(monkeypatch, dtype, d, entry):
    """``flash_varlen_bwd_dkv`` launches its route's entry (``_launch``
    stubbed: nothing runs), with the tables it is given; the tensor-core
    entry's ctypes table has one pointer more than the CUDA-core one's
    (the block order) and is the table ``_launch`` loads it with."""
    seen = []
    monkeypatch.setattr(vl, "_launch", lambda e, *a: seen.append((e, a[-1])))
    q = torch.zeros(1, 2, 64, d, dtype=dtype)
    seg = torch.zeros(1, 64, dtype=torch.int32)
    row = torch.zeros(1, 2, 64, 1)
    tables = vl._tables(seg, seg, True, "mma" in entry)
    dk, dv = vl.flash_varlen_bwd_dkv(q, q, q, seg, seg, q, row, row, 0.1,
                                     True, tables=tables)
    assert dk.shape == dv.shape == q.shape
    assert seen == [(entry, tables)]
    assert entry in (vl._MMA_SIGNATURES if "mma" in entry
                     else vl._SIGNATURES)
    assert len(vl._MMA_SIGNATURES["flash_varlen_mma_bwd_dkv"]) == \
        len(vl._SIGNATURES["flash_varlen_bwd_dkv"]) + 1


def test_dkv_block_order_is_longest_live_range_first():
    """``_tables``'s block order: per batch row a permutation of the K/V
    tiles, by live q range (``ihi - ilo``) longest first, ties in tile
    order; the tile tables are ``_tile_ranges``'s, and without
    ``with_order`` (the CUDA-core routes) no order is built."""
    rng = np.random.default_rng(11)
    seg = _t(_packed_segs(rng, 2, 640, 20, 300, 60))
    for causal in (False, True):
        qr, kr, order, _ = vl._tables(seg, seg, causal, True)
        want_qr, want_kr = vl._tile_ranges(seg, seg, causal)
        assert torch.equal(qr, want_qr) and torch.equal(kr, want_kr)
        qr0, kr0, none, none_q = vl._tables(seg, seg, causal, False)
        assert torch.equal(qr0, qr) and torch.equal(kr0, kr)
        assert none is None and none_q is None
        assert order.dtype == torch.int32 and order.shape == (2, 10)
        for row in range(2):
            assert sorted(order[row].tolist()) == list(range(10))
            span = (kr[row, :, 3] - kr[row, :, 2]).tolist()
            walk = order[row].tolist()
            assert [span[t] for t in walk] == sorted(span, reverse=True)
            for a, b in zip(walk[:-1], walk[1:]):
                assert span[a] > span[b] or a < b


def _meets(causal):
    """``tiles_meet`` (csrc/flash_tile.cuh) over 64-row table entries."""
    def meet(qi, ki, qt, kt):
        ok = not (qi[0] > ki[1] or qi[1] < ki[0]) and qi[1] >= 0 and ki[1] >= 0
        return ok and (not causal or kt * 64 <= qt * 64 + 63)
    return meet


def _dkv_owner_walk(q, k, v, seg, do, lse, delta, scale, causal):
    """The tensor-core dK/dV's walk, emulated on the CPU: one owner per
    (batch row, head, 64-row K/V tile), taken in ``_tables``'s block
    order, walks exactly its live q range [ilo, ihi] of the ``kr`` table
    in order, skips the q tiles that cannot meet it (``tiles_meet``), and
    adds p^T dO and ds^T q into fp32 tiles, p = allowed ? exp(s − lse) : 0
    (by value) and ds = p·(dp − delta)·scale rounded to the input type
    before each product; a K/V tile that no q meets stays zero."""
    b, h, s, d = q.shape
    qr, kr, order, _ = vl._tables(seg, seg, causal, True)
    dk = torch.zeros(b, h, s, d)
    dv = torch.zeros(b, h, s, d)
    meet = _meets(causal)

    for bb in range(b):
        for kt in order[bb].tolist():
            ki = kr[bb, kt].tolist()
            ks = slice(kt * 64, kt * 64 + 64)
            kpos = torch.arange(kt * 64, kt * 64 + 64)
            for hh in range(h):
                acc_k = torch.zeros(64, d)
                acc_v = torch.zeros(64, d)
                for qt in range(ki[2], ki[3] + 1):
                    if not meet(qr[bb, qt].tolist(), ki, qt, kt):
                        continue
                    qs = slice(qt * 64, qt * 64 + 64)
                    qpos = torch.arange(qt * 64, qt * 64 + 64)
                    sq, sk = seg[bb, qs], seg[bb, ks]
                    ok = (sk[:, None] == sq[None, :]) & (sq[None, :] >= 0)
                    if causal:
                        ok &= kpos[:, None] <= qpos[None, :]
                    qf, of = q[bb, hh, qs].float(), do[bb, hh, qs].float()
                    st = k[bb, hh, ks].float() @ qf.t() * scale
                    p = torch.where(ok, torch.exp(st - lse[bb, hh, qs, 0]),
                                    0.0)
                    dp = v[bb, hh, ks].float() @ of.t()
                    ds = p * (dp - delta[bb, hh, qs, 0]) * scale
                    acc_v += p.to(q.dtype).float() @ of
                    acc_k += ds.to(q.dtype).float() @ qf
                dk[bb, hh, ks] = acc_k
                dv[bb, hh, ks] = acc_v
    return dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkv_owner_walk_matches_plain_version(dtype, causal):
    """The emulated owner-block walk equals the plain dK/dV
    (``flash_varlen_bwd_reference``) on two packed rows of 2 heads of 32
    over 320 tokens: documents ending mid-tile and a pad tail of 70 (an
    all-pad last tile), whose keys get exactly zero. fp32 atol 2e-5, rtol
    1e-5; bf16 atol 1e-2 + rtol 2**-7 (p and ds rounded on both sides
    from sums in another order)."""
    (q, k, v, do), rng = _inputs(12, 2, 2, 320, 32)
    seg = _packed_segs(rng, 2, 320, 30, 110, 70)
    ts = _t(seg)
    q, k, v, do = (_t(a).to(dtype) for a in (q, k, v, do))
    scale = 32 ** -0.5
    o, lse = vl.flash_varlen_fwd_reference(q, k, v, ts, ts, scale, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dk, dv = _dkv_owner_walk(q, k, v, ts, do, lse, delta, scale, causal)
    _, want_k, want_v = vl.flash_varlen_bwd_reference(q, k, v, ts, ts, o,
                                                      lse, do, scale, causal)
    atol, rtol = (ATOL, RTOL) if dtype == torch.float32 else (1e-2, 2 ** -7)
    for got, want in ((dk, want_k), (dv, want_v)):
        assert got.dtype == dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
    pad = (ts < 0)[:, None, :].expand(-1, 2, -1)
    for t in (dk, dv):
        assert not bool(t[pad].any())


@pytest.mark.parametrize("causal", [False, True])
def test_dkv_owner_walk_matches_jax_kernel(causal):
    """The emulated owner-block walk against JAX's varlen dK/dV kernel
    (``_vl_bwd_call``, interpret mode, 64-row blocks) from JAX's own o
    and lse, fp32, one packed row of 2 heads of 32 over 192 tokens: two
    documents ending mid-tile and a pad tail; atol 2e-5, rtol 1e-5."""
    (q, k, v, do), _ = _inputs(13, 1, 2, 192, 32)
    seg = np.asarray([[0] * 70 + [1] * 90 + [-1] * 32], np.int32)
    scale = 32 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    js = jnp.asarray(seg)
    o_j, lse_j = jvl._vl_call(jq, jk, jv, js, js, scale, causal, 64, 64,
                              True)
    _, dk_j, dv_j = jvl._vl_bwd_call(jq, jk, jv, js, js, o_j, lse_j, jdo,
                                     scale, causal, 64, 64, True)
    o, lse = _t(np.asarray(o_j)), _t(np.asarray(lse_j))
    delta = (_t(do) * o).sum(-1, keepdim=True)
    dk, dv = _dkv_owner_walk(_t(q), _t(k), _t(v), _t(seg), _t(do), lse,
                             delta, scale, causal)
    np.testing.assert_allclose(_np(dk), np.asarray(dk_j), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(_np(dv), np.asarray(dv_j), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("dtype,d,kernel,entry", [
    (torch.bfloat16, 64, "fwd", "flash_varlen_mma_fwd"),
    (torch.bfloat16, 256, "fwd", "flash_varlen_mma_fwd"),
    (torch.bfloat16, 512, "fwd", "flash_varlen_fwd"),
    (torch.float32, 64, "fwd", "flash_varlen_fwd"),
    (torch.bfloat16, 40, "dq", "flash_varlen_mma_bwd_dq"),
    (torch.bfloat16, 256, "dq", "flash_varlen_mma_bwd_dq"),
    (torch.bfloat16, 264, "dq", "flash_varlen_bwd_dq"),
    (torch.float32, 128, "dq", "flash_varlen_bwd_dq")])
def test_fwd_dq_wrappers_launch_the_routed_entry(monkeypatch, dtype, d,
                                                 kernel, entry):
    """``flash_varlen_fwd`` and ``flash_varlen_bwd_dq`` launch their
    route's entry (``_launch`` stubbed: nothing runs) with the tables they
    are given; a tensor-core entry's ctypes table has one pointer more
    than its CUDA-core twin's (the block order)."""
    seen = []
    monkeypatch.setattr(vl, "_launch", lambda e, *a: seen.append((e, a[-1])))
    q = torch.zeros(1, 2, 64, d, dtype=dtype)
    seg = torch.zeros(1, 64, dtype=torch.int32)
    row = torch.zeros(1, 2, 64, 1)
    tables = vl._tables(seg, seg, False, "mma" in entry)
    if kernel == "fwd":
        o, lse = vl.flash_varlen_fwd(q, q, q, seg, seg, 0.1, False,
                                     tables=tables)
        assert o.shape == q.shape and lse.shape == row.shape
    else:
        assert vl.flash_varlen_bwd_dq(q, q, q, seg, seg, q, row, row, 0.1,
                                      False, tables=tables).shape == q.shape
    assert seen == [(entry, tables)]
    assert entry in (vl._MMA_SIGNATURES if "mma" in entry
                     else vl._SIGNATURES)
    twin = entry.replace("mma_", "")
    assert len(vl._MMA_SIGNATURES[twin.replace("varlen_", "varlen_mma_")]) \
        == len(vl._SIGNATURES[twin]) + 1


def test_q_block_order_is_longest_live_range_first():
    """``_tables``'s q-tile order (the tensor-core forward's and dQ's):
    per batch row a permutation of the q tiles, by live K/V range (``jhi
    - jlo``) longest first, ties in tile order."""
    rng = np.random.default_rng(14)
    seg = _t(_packed_segs(rng, 2, 640, 20, 300, 60))
    for causal in (False, True):
        qr, _, _, order = vl._tables(seg, seg, causal, True)
        assert order.dtype == torch.int32 and order.shape == (2, 10)
        for row in range(2):
            assert sorted(order[row].tolist()) == list(range(10))
            span = (qr[row, :, 3] - qr[row, :, 2]).tolist()
            walk = order[row].tolist()
            assert [span[t] for t in walk] == sorted(span, reverse=True)
            for a, b in zip(walk[:-1], walk[1:]):
                assert span[a] > span[b] or a < b


# case (a): q tile 1 (64-127) holds document 0's end (64-99) and document
# 1's start (100-127); its live K/V range starts at tile 0, where document
# 1's rows have no allowed column. Documents end mid-tile, and the pad
# tail (250-319) leaves tile 4 all padding, with an empty live range.
CASE_A = [0] * 100 + [1] * 70 + [2] * 80 + [-1] * 70


def _case_a_segs(rng, rows):
    """Row 0 is CASE_A; the others random packed rows of documents of
    30-110 tokens with a pad tail of 70 (320 tokens)."""
    rest = _packed_segs(rng, rows - 1, 320, 30, 110, 70)
    return np.concatenate([np.asarray([CASE_A], np.int32), rest])


def _fwd_owner_walk(q, k, v, seg, scale, causal):
    """The tensor-core forward's walk, emulated on the CPU: one owner per
    (batch row, head, 64-row q tile), taken in ``_tables``' q order,
    walks exactly the live K/V range [jlo, jhi] of its ``qr`` entry in
    order, skips the tiles that cannot meet it (``tiles_meet``), and keeps
    an online softmax a 64-key tile at a time: p = allowed ? exp(s −
    m_new) : 0 by value, the correction 0 while m_prev <= NEG_INF / 2, p
    rounded to the input type against the running max before p·v. o =
    acc / l and lse = m + log l, or 0 and NEG_INF where l == 0."""
    b, h, s, d = q.shape
    qr, kr, _, order = vl._tables(seg, seg, causal, True)
    o = torch.zeros(b, h, s, d)
    lse = torch.full((b, h, s, 1), vl.NEG_INF)
    meet = _meets(causal)
    for bb in range(b):
        for qt in order[bb].tolist():
            qi = qr[bb, qt].tolist()
            qs = slice(qt * 64, qt * 64 + 64)
            qpos = torch.arange(qt * 64, qt * 64 + 64)
            for hh in range(h):
                m = torch.full((64,), vl.NEG_INF)
                l = torch.zeros(64)
                acc = torch.zeros(64, d)
                for kt in range(qi[2], qi[3] + 1):
                    if not meet(qi, kr[bb, kt].tolist(), qt, kt):
                        continue
                    ks = slice(kt * 64, kt * 64 + 64)
                    kpos = torch.arange(kt * 64, kt * 64 + 64)
                    sq, sk = seg[bb, qs], seg[bb, ks]
                    ok = (sq[:, None] == sk[None, :]) & (sq[:, None] >= 0)
                    if causal:
                        ok &= kpos[None, :] <= qpos[:, None]
                    st = q[bb, hh, qs].float() @ k[bb, hh, ks].float().t()
                    st = torch.where(ok, st * scale, vl.NEG_INF)
                    m_new = torch.maximum(m, st.amax(1))
                    p = torch.where(ok, torch.exp(st - m_new[:, None]), 0.0)
                    corr = torch.where(m <= vl.NEG_INF / 2, 0.0,
                                       torch.exp(m - m_new))
                    l = corr * l + p.sum(1)
                    acc = acc * corr[:, None] + (p.to(v.dtype).float()
                                                 @ v[bb, hh, ks].float())
                    m = m_new
                empty = l == 0.0
                safe = torch.where(empty, 1.0, l)
                o[bb, hh, qs] = acc / safe[:, None]
                lse[bb, hh, qs, 0] = torch.where(empty, vl.NEG_INF,
                                                 m + torch.log(safe))
    return o.to(q.dtype), lse


def _dq_owner_walk(q, k, v, seg, do, lse, delta, scale, causal):
    """The tensor-core dQ's walk, emulated on the CPU: the forward's owners
    and live K/V tiles, adding ds·k into an fp32 tile, p = allowed ?
    exp(s − lse) : 0 by value (a pad row's lse is NEG_INF) and ds = p·(dp
    − delta)·scale rounded to the input type before the product; a q tile
    with nothing live stays zero."""
    b, h, s, d = q.shape
    qr, kr, _, order = vl._tables(seg, seg, causal, True)
    dq = torch.zeros(b, h, s, d)
    meet = _meets(causal)
    for bb in range(b):
        for qt in order[bb].tolist():
            qi = qr[bb, qt].tolist()
            qs = slice(qt * 64, qt * 64 + 64)
            qpos = torch.arange(qt * 64, qt * 64 + 64)
            for hh in range(h):
                acc = torch.zeros(64, d)
                for kt in range(qi[2], qi[3] + 1):
                    if not meet(qi, kr[bb, kt].tolist(), qt, kt):
                        continue
                    ks = slice(kt * 64, kt * 64 + 64)
                    kpos = torch.arange(kt * 64, kt * 64 + 64)
                    sq, sk = seg[bb, qs], seg[bb, ks]
                    ok = (sq[:, None] == sk[None, :]) & (sq[:, None] >= 0)
                    if causal:
                        ok &= kpos[None, :] <= qpos[:, None]
                    kf = k[bb, hh, ks].float()
                    st = q[bb, hh, qs].float() @ kf.t() * scale
                    p = torch.where(ok, torch.exp(st - lse[bb, hh, qs]), 0.0)
                    dp = do[bb, hh, qs].float() @ v[bb, hh, ks].float().t()
                    ds = p * (dp - delta[bb, hh, qs]) * scale
                    acc += ds.to(q.dtype).float() @ kf
                dq[bb, hh, qs] = acc
    return dq.to(q.dtype)


def test_case_a_meets_the_finite_neg_inf_trouble():
    """Case (a) is what it is meant to be: q tile 1's live K/V range
    starts at tile 0, where document 1's rows have no allowed column (the
    tile max is NEG_INF, and exp(s − m) would be 1 but for the mask by
    value), and the all-pad tile 4 has the empty range (0, 0), which
    ``tiles_meet`` then skips."""
    seg = _t(np.asarray([CASE_A], np.int32))
    for causal in (False, True):
        qr, kr, _, _ = vl._tables(seg, seg, causal, True)
        assert qr[0, 1, 2] == 0
        rows = seg[0, 64:128]
        assert bool(((rows[:, None] == seg[0, None, :64]).any(1)
                     == (rows == 0)).all())
        assert qr[0, 4].tolist()[2:] == [0, 0]
        assert not _meets(causal)(qr[0, 4].tolist(), kr[0, 0].tolist(), 4, 0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_owner_walk_matches_plain_version(dtype, causal):
    """The emulated forward walk equals the plain forward
    (``flash_varlen_fwd_reference``) on case (a) and a random packed row
    (2 heads of 32, 320 tokens): fp32 atol 2e-5 + rtol 1e-5, bf16 atol
    1e-2 + rtol 2**-7 (p rounded against the running max, the plain
    version against the row's max); lse within 1e-4 / 1e-5 in bf16; pad
    rows exactly 0 with lse NEG_INF."""
    (q, k, v, _), rng = _inputs(15, 2, 2, 320, 32)
    ts = _t(_case_a_segs(rng, 2))
    q, k, v = (_t(a).to(dtype) for a in (q, k, v))
    scale = 32 ** -0.5
    o, lse = _fwd_owner_walk(q, k, v, ts, scale, causal)
    o_p, lse_p = vl.flash_varlen_fwd_reference(q, k, v, ts, ts, scale,
                                               causal)
    atol, rtol = (ATOL, RTOL) if dtype == torch.float32 else (1e-2, 2 ** -7)
    assert o.dtype == dtype
    np.testing.assert_allclose(_np(o), _np(o_p), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(lse), _np(lse_p),
                               atol=ATOL if dtype == torch.float32 else 1e-4,
                               rtol=RTOL)
    pad = (ts < 0)[:, None, :].expand(-1, 2, -1)
    assert not bool(o[pad].any())
    assert bool((lse[..., 0][pad] == vl.NEG_INF).all())


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_owner_walk_matches_jax_kernel(causal):
    """The emulated forward walk against JAX's varlen forward kernel
    (``_vl_call``, interpret mode, 64-row blocks), fp32, on case (a):
    o and lse within atol 2e-5 + rtol 1e-5, including document 1's rows
    of q tile 1, whose first live K/V tile allows nothing."""
    (q, k, v, _), _ = _inputs(16, 1, 2, 320, 32)
    seg = np.asarray([CASE_A], np.int32)
    scale = 32 ** -0.5
    o_j, lse_j = jvl._vl_call(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(seg), jnp.asarray(seg), scale,
                              causal, 64, 64, True)
    o, lse = _fwd_owner_walk(_t(q), _t(k), _t(v), _t(seg), scale, causal)
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_j), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_owner_walk_matches_plain_version(dtype, causal):
    """The emulated dQ walk equals the plain dQ
    (``flash_varlen_bwd_reference``) on case (a) and a random packed row,
    from the plain forward's o and lse: fp32 atol 2e-5 + rtol 1e-5, bf16
    atol 1e-2 + rtol 2**-7; pad rows exactly 0 (their lse is NEG_INF:
    exp(s − lse) is inf there, masked by a select)."""
    (q, k, v, do), rng = _inputs(17, 2, 2, 320, 32)
    ts = _t(_case_a_segs(rng, 2))
    q, k, v, do = (_t(a).to(dtype) for a in (q, k, v, do))
    scale = 32 ** -0.5
    o, lse = vl.flash_varlen_fwd_reference(q, k, v, ts, ts, scale, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = _dq_owner_walk(q, k, v, ts, do, lse, delta, scale, causal)
    want, _, _ = vl.flash_varlen_bwd_reference(q, k, v, ts, ts, o, lse, do,
                                               scale, causal)
    atol, rtol = (ATOL, RTOL) if dtype == torch.float32 else (1e-2, 2 ** -7)
    assert dq.dtype == dtype
    np.testing.assert_allclose(_np(dq), _np(want), atol=atol, rtol=rtol)
    assert not bool(dq[(ts < 0)[:, None, :].expand(-1, 2, -1)].any())


@pytest.mark.parametrize("causal", [False, True])
def test_dq_owner_walk_matches_jax_kernel(causal):
    """The emulated dQ walk against JAX's varlen dQ kernel
    (``_vl_bwd_call``, interpret mode, 64-row blocks) from JAX's own o and
    lse, fp32, on case (a): atol 2e-5 + rtol 1e-5."""
    (q, k, v, do), _ = _inputs(18, 1, 2, 320, 32)
    seg = np.asarray([CASE_A], np.int32)
    scale = 32 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    js = jnp.asarray(seg)
    o_j, lse_j = jvl._vl_call(jq, jk, jv, js, js, scale, causal, 64, 64,
                              True)
    dq_j, _, _ = jvl._vl_bwd_call(jq, jk, jv, js, js, o_j, lse_j, jdo,
                                  scale, causal, 64, 64, True)
    o, lse = _t(np.asarray(o_j)), _t(np.asarray(lse_j))
    delta = (_t(do) * o).sum(-1, keepdim=True)
    dq = _dq_owner_walk(_t(q), _t(k), _t(v), _t(seg), _t(do), lse, delta,
                        scale, causal)
    np.testing.assert_allclose(_np(dq), np.asarray(dq_j), atol=ATOL,
                               rtol=RTOL)
