"""The fused LM-head loss's two routes, on the CPU.

* The route table (``ops.lm_head_loss._lm_head_route``): bf16 takes the
  tensor-core forward, dX and dW (``csrc/lm_head_mma.cu``), fp32 the
  CUDA-core ones (``csrc/lm_head_loss.cu``); a hidden size that is not a
  multiple of 128 raises.
* The tensor-core kernels' launch geometry, a function of the shape
  alone: how a cluster of CTAs covers the hidden axis (``_mma_layout``),
  how many vocab splits dX takes (``_dx_splits``) and the forward takes
  (``_fwd_splits``); and plain emulations of those splits (dX: per-split
  fp32 partials added in split order; the forward: per-split (m, l, p)
  over 128-row vocab tiles, merged in split order) against the plain
  dX and forward, and the forward's against JAX's interpret-mode kernel.
* The wrappers launch the entry of their route with the arguments its
  ctypes table declares (the library stubbed: nothing runs here).
* JAX parity of the bf16 backward (the port's plain versions, which the
  card's kernels are held to) at T5-like and ragged shapes, small width,
  against JAX's Pallas kernels in interpret mode.

The kernels themselves run only on the card (``tests/test_torch_kernels_
cuda.py``, ``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.lm_head_loss import _lm_head_loss as jax_lm_head_loss
from apex_tpu.ops.lm_head_loss import _run_fwd as jax_run_fwd

from apex_tpu_torch.ops import _kernel_util as ku

lm = importlib.import_module("apex_tpu_torch.ops.lm_head_loss")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the route table


@pytest.mark.parametrize("h", [128, 512, 768, 1024, 2048])
def test_bf16_takes_the_tensor_cores_and_fp32_the_cuda_cores(h):
    assert lm._lm_head_route(torch.bfloat16, h) == "tensor_core"
    assert lm._lm_head_route(torch.float32, h) == "cuda_core"


@pytest.mark.parametrize("h", [0, 64, 100, 769])
def test_route_refuses_a_hidden_size_no_kernel_takes(h):
    with pytest.raises(ValueError, match="multiple of 128"):
        lm._lm_head_route(torch.bfloat16, h)


def test_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        lm._lm_head_route(torch.float64, 768)


@pytest.mark.parametrize("h", [128, 768, 2048])
def test_fp16_takes_the_tensor_cores(h):
    assert lm._lm_head_route(torch.float16, h) == "tensor_core"


# ---------------------------------------------------------------------------
# launch geometry


@pytest.mark.parametrize("h,want", [
    (128, (1, 128, 1)), (384, (1, 384, 1)), (512, (1, 512, 1)),
    (768, (2, 384, 1)), (1024, (4, 256, 1)), (1152, (3, 384, 1)),
    (2048, (8, 256, 1)), (3072, (8, 384, 1)), (3200, (5, 384, 2)),
    (12288, (8, 384, 4))])
def test_mma_layout_covers_the_hidden_axis(h, want):
    """T5-small's 512 runs in one CTA a row tile, GPT-2's 768 in clusters
    of two; a cluster of at most 8 CTAs covers h up to 3,072 with one
    panel each, wider h in panels of 384. Every layout covers h, with no
    CTA's panels wholly past it; 512-column panels never in a cluster."""
    c, hk, panels = lm._mma_layout(h)
    assert (c, hk, panels) == want
    assert 1 <= c <= 8 and hk in (128, 256, 384, 512)
    assert hk < 512 or c == 1
    assert c * panels * hk >= h > c * (panels - 1) * hk
    assert (c - 1) * panels * hk < h


@pytest.mark.parametrize("h", range(128, 8193, 128))
def test_mma_layout_is_valid_at_every_hidden_size(h):
    c, hk, panels = lm._mma_layout(h)
    assert 1 <= c <= 8 and hk in (128, 256, 384, 512) and panels >= 1
    assert hk < 512 or c == 1
    assert c * panels * hk >= h > c * (panels - 1) * hk
    assert (c - 1) * panels * hk < h


@pytest.mark.parametrize("n,v,h,want", [
    (8192, 50304, 768, 1),     # GPT-2-124M: 256 blocks, no split
    (1024, 32128, 512, 8),     # T5-small's decoder rows: 16 blocks x 8
    (96, 1000, 768, 16),       # the ragged check: capped at 16
    (512, 1000, 2048, 2),      # clusters of 8
    (8, 37, 256, 1)])          # one vocab tile: nothing to split
def test_dx_splits_fill_the_card(n, v, h, want):
    splits = lm._dx_splits(n, v, h)
    assert splits == want
    assert splits == lm._dx_splits(n, v, h)   # a function of the shape
    c, _, panels = lm._mma_layout(h)
    blocks = -(-n // 64) * c * panels
    assert splits == 1 or blocks * splits <= 132
    assert splits <= -(-v // 64)


@pytest.mark.parametrize("n,v,h,splits", [
    (40, 1000, 128, 1), (40, 1000, 128, 4), (96, 333, 256, 16),
    (64, 129, 128, 2), (17, 64, 128, 3)])
def test_dx_split_partials_merged_in_order_equal_the_plain_dx(n, v, h,
                                                              splits):
    """The tensor-core dX's vocab split, emulated: per split the fp32
    partial over its 64-column vocab tiles, added in split order, equals
    the plain dX in fp32 (rtol 1e-6, atol 1e-6 of the largest element:
    the sum runs in another order). A split past the vocab adds zeros."""
    rng = np.random.default_rng(n + v + h + splits)
    x = _t(rng.standard_normal((n, h)).astype(np.float32))
    w = _t((0.1 * rng.standard_normal((v, h))).astype(np.float32))
    t = _t(rng.integers(-1, v + 2, n))
    g = _t(rng.standard_normal(n).astype(np.float32))
    lse, _ = lm.lm_head_loss_fwd_reference(x, w, t)
    want = lm.lm_head_loss_bwd_reference(x, w, t, lse, g)[0]
    got = lm.lm_head_loss_bwd_dx_split_reference(x, w, t, lse, g, splits)
    assert got.dtype == torch.float32 and got.shape == (n, h)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("n,v,h,want", [
    (8192, 50304, 768, 4),     # GPT-2-124M: 64 row tiles x 4 = 256 blocks
    (1024, 32128, 512, 33),    # T5-small's decoder rows: 8 x 33 = 264
    (96, 1000, 768, 8),        # the ragged check: one vocab tile a split
    (512, 1000, 2048, 8),
    (65536, 50304, 768, 1),    # more row tiles than two waves' worth
    (8, 37, 256, 1)])          # one vocab tile: nothing to split
def test_fwd_splits_fill_the_card(n, v, h, want):
    """The forward's vocab splits: the most that keep the (row tile x
    split) grid within one wave of two blocks on each of 132 SMs, at most
    64 and at most one a 128-row vocab tile: one split more would need a
    second wave, so the grid fills the card as far as whole splits can
    (GPT-2's 256 of 264 block slots, T5's 264)."""
    splits = lm._fwd_splits(n, v, h)
    assert splits == want
    rows, tiles = -(-n // 128), -(-v // 128)
    blocks = rows * splits
    assert 1 <= splits <= min(64, tiles)
    assert splits == 1 or blocks <= 264
    assert splits == min(64, tiles) or blocks + rows > 264


@pytest.mark.parametrize("n,v", [(8192, 50304), (1024, 32128), (96, 1000),
                                 (300, 5000)])
def test_fwd_splits_are_a_function_of_the_shape_alone(n, v):
    """The same (n, V) gives the same split count at every hidden size
    and on every call, so the in-order merge repeats bitwise."""
    got = {lm._fwd_splits(n, v, h) for h in (128, 512, 768, 2048, 4096)}
    assert got == {lm._fwd_splits(n, v, 768)}


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-4),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("n,v,h,splits", [
    (40, 1000, 128, 1), (40, 1000, 128, 3), (96, 333, 256, 8),
    (64, 129, 128, 2), (17, 64, 128, 1), (130, 700, 256, 16)])
def test_fwd_split_emulation_equals_the_plain_forward(dtype, tol, n, v, h,
                                                      splits):
    """The tensor-core forward's vocab split, emulated: per split the
    running (m, l, p) over its 128-row vocab tiles, the splits merged in
    split order, equals the plain forward's lse and pred (and the loss)
    within 2e-4 in bf16 and 2e-5 in fp32; a split past the vocab adds
    nothing; a target outside [0, V) gives pred 0."""
    rng = np.random.default_rng(n + v + h + splits)
    x = _t(rng.standard_normal((n, h)).astype(np.float32)).to(dtype)
    w = _t((0.1 * rng.standard_normal((v, h))).astype(np.float32)).to(dtype)
    t = _t(rng.integers(-1, v + 2, n))
    t[:2] = torch.tensor([-1, v])
    lse_p, pred_p = lm.lm_head_loss_fwd_reference(x, w, t)
    lse, pred = lm.lm_head_loss_fwd_split_reference(x, w, t, splits)
    assert lse.dtype == pred.dtype == torch.float32
    torch.testing.assert_close(lse, lse_p, atol=tol, rtol=tol)
    torch.testing.assert_close(pred, pred_p, atol=tol, rtol=tol)
    torch.testing.assert_close(lse - pred, lse_p - pred_p, atol=tol,
                               rtol=tol)
    out = (t < 0) | (t >= v)
    assert not bool(pred[out].any())


@pytest.mark.parametrize("dtype,tol", [(jnp.bfloat16, 2e-4),
                                       (jnp.float32, 2e-5)])
@pytest.mark.parametrize("n,v,h,bn,bv", [
    (128, 321, 256, 64, 64),    # T5-like: few rows, a ragged vocab tail
    (96, 1000, 128, 32, 128),   # ragged rows (96 of 128-row tiles), vocab
])
def test_fwd_split_emulation_matches_jax_kernel(dtype, tol, n, v, h, bn, bv):
    """The split forward's emulation, at the split count the card takes,
    against JAX's forward kernel (``_run_fwd``) in interpret mode: lse
    and pred within 2e-4 (bf16 inputs; the same products, fp32 sums in
    another order) and 2e-5 (fp32)."""
    rng = np.random.default_rng(n + v + h)
    x = (rng.standard_normal((n, h)) * 2.0).astype(np.float32)
    w = (rng.standard_normal((v, h)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    lse_j, pred_j = jax_run_fwd(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                jnp.asarray(t), bn, bv, True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    lse, pred = lm.lm_head_loss_fwd_split_reference(
        _t(x).to(tdt), _t(w).to(tdt), _t(t), lm._fwd_splits(n, v, h))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_j), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the wrappers' launches (library stubbed)


class _Lib:
    """Records each entry called with its arguments; returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype,n,v,h", [
    (torch.bfloat16, 1024, 300, 512), (torch.bfloat16, 96, 1000, 768),
    (torch.bfloat16, 8, 70, 3200), (torch.float32, 96, 1000, 768),
    (torch.float16, 96, 1000, 768)])
def test_wrappers_launch_the_routed_entries(monkeypatch, dtype, n, v, h):
    """dX and dW launch their route's entry once, count it under that
    name, pass as many arguments as its ctypes table declares, and for
    bf16 and fp16 the layout and split count of ``_mma_layout`` /
    ``_dx_splits`` (with a split scratch only when dX splits) and the
    dtype code."""
    libs = {}

    def load(name, table):
        libs.setdefault(name, (_Lib(), table))
        return libs[name][0]

    monkeypatch.setattr(lm, "_check",
                        lambda what, x2, w, *a: (*x2.shape[:1], w.shape[0],
                                                 x2.shape[1]))
    monkeypatch.setattr(ku, "load_kernel", load)
    monkeypatch.setattr(ku, "stream_handle", lambda t: None)
    monkeypatch.setattr(ku, "_LAUNCHES", {})
    x = torch.zeros(n, h, dtype=dtype)
    w = torch.zeros(v, h, dtype=dtype)
    t = torch.zeros(n, dtype=torch.long)
    row = torch.zeros(n)
    dx = lm.lm_head_loss_bwd_dx(x, w, t, row, row)
    dw = lm.lm_head_loss_bwd_dw(x, w, t, row, row)
    assert dx.shape == x.shape and dw.shape == w.shape
    bf16 = dtype != torch.float32  # the tensor-core route
    source = "lm_head_mma" if bf16 else "lm_head_loss"
    lib, table = libs[source]
    names = [c[0] for c in lib.calls]
    assert names == [f"{source}_bwd_dx", f"{source}_bwd_dw"]
    assert ku.launch_counts() == {name: 1 for name in names}
    for name, args in lib.calls:
        assert len(args) == len(table[name]), name
    if bf16:
        layout, splits = lm._mma_layout(h), lm._dx_splits(n, v, h)
        dx_args, dw_args = lib.calls[0][1], lib.calls[1][1]
        assert dx_args[-7:-2] == (h, *layout, splits)
        assert dw_args[-6:-2] == (h, *layout)
        assert dx_args[-2] == dw_args[-2] == ku.dtype_code(dtype)
        assert (dx_args[6] is None) == (splits == 1)


@pytest.mark.parametrize("dtype,n,v,h", [
    (torch.bfloat16, 1024, 300, 512), (torch.bfloat16, 8192, 50304, 768),
    (torch.float32, 96, 1000, 768), (torch.float16, 1024, 300, 512)])
def test_forward_launches_the_routed_entry(monkeypatch, dtype, n, v, h):
    """The forward launches its route's entry once and counts it under
    that name: bf16 and fp16 ``lm_head_mma_fwd`` with ``_fwd_splits``'s
    count (and a (3, splits, n) scratch) and the dtype code, fp32
    ``lm_head_loss_fwd`` with is_bf16 0; as many arguments as the entry's
    ctypes table declares."""
    libs = {}

    def load(name, table):
        libs.setdefault(name, (_Lib(), table))
        return libs[name][0]

    monkeypatch.setattr(lm, "_check",
                        lambda what, x2, w, *a: (*x2.shape[:1], w.shape[0],
                                                 x2.shape[1]))
    monkeypatch.setattr(ku, "load_kernel", load)
    monkeypatch.setattr(ku, "stream_handle", lambda t: None)
    monkeypatch.setattr(ku, "_LAUNCHES", {})
    x = torch.zeros(n, h, dtype=dtype)
    w = torch.zeros(v, h, dtype=dtype)
    lse, pred = lm.lm_head_loss_fwd(x, w, torch.zeros(n, dtype=torch.long))
    assert lse.shape == pred.shape == (n,)
    bf16 = dtype != torch.float32  # the tensor-core route
    source = "lm_head_mma" if bf16 else "lm_head_loss"
    lib, table = libs[source]
    calls = [c for c in lib.calls if c[0] != "lm_head_loss_fwd_splits"]
    assert [c[0] for c in calls] == [f"{source}_fwd"]
    assert ku.launch_counts() == {f"{source}_fwd": 1}
    args = calls[0][1]
    assert len(args) == len(table[f"{source}_fwd"])
    if bf16:
        assert args[-6:-1] == (n, v, h, lm._fwd_splits(n, v, h),
                               ku.dtype_code(dtype))
    else:
        assert args[-5:-1] == (n, v, h, 0)


# ---------------------------------------------------------------------------
# JAX parity of the bf16 backward at T5-like and ragged shapes


@pytest.mark.parametrize("n,v,h,bn,bv", [
    (96, 1000, 128, 32, 128),   # ragged rows (96 of 64-row tiles), vocab
    (128, 321, 256, 64, 64),    # T5-like: few rows, a ragged vocab tail
])
def test_bf16_backward_matches_jax_kernel_at_t5_and_ragged_shapes(n, v, h,
                                                                   bn, bv):
    """dx and dw of the port's bf16 ``lm_head_loss`` (its plain backward,
    which rounds dl to bf16 before each product as the card's kernels do)
    against ``jax.grad`` of JAX's Pallas kernels in interpret mode: within
    one bf16 step (rtol 2**-7) plus atol 2e-5."""
    rng = np.random.default_rng(n + v)
    x = (rng.standard_normal((n, h)) * 2.0).astype(np.float32)
    w = (rng.standard_normal((v, h)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)

    def fused(x2, w2):
        return jnp.mean(jax_lm_head_loss(x2, w2, jnp.asarray(t), None, bn,
                                         bv, "pallas_interpret"))

    dx_j, dw_j = jax.jit(jax.grad(fused, argnums=(0, 1)))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    tx = _t(x).bfloat16().requires_grad_()
    tw = _t(w).bfloat16().requires_grad_()
    lm.lm_head_loss(tx, tw, _t(t)).mean().backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    for got, want in ((tx.grad, dx_j), (tw.grad, dw_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=2e-5)
