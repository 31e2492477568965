"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode) and skips without one. This file imports neither jax nor apex_tpu,
so it also runs on a machine that has no JAX; the repo's conftest imports
jax, so run it there with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: fp32 atol/rtol 2e-5 (summation order and fused multiply-adds
differ from the plain version's kernels); bf16 atol 1e-3, rtol 2**-7 (one
rounding step of the bf16 output); fp16 the bf16 gates.
"""

import contextlib
import importlib
import math

import numpy as np
import pytest
import torch

from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops.attention import (attention_reference,
                                          flash_attention,
                                          flash_attention_bwd_dbias,
                                          flash_attention_bwd_dbias_reference,
                                          flash_attention_bwd_dkv,
                                          flash_attention_bwd_dq,
                                          flash_attention_bwd_reference,
                                          flash_attention_fwd,
                                          flash_attention_fwd_reference)
from apex_tpu_torch.ops.fused_update import (adam_tail_reference,
                                             fused_adam_tail,
                                             fused_lamb_tail,
                                             lamb_tail_reference)
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_bwd,
                                           layer_norm_bwd_reference,
                                           layer_norm_fwd,
                                           norm_bwd_split_reference,
                                           layer_norm_fwd_reference,
                                           layer_norm_reference, rms_norm,
                                           rms_norm_bwd,
                                           rms_norm_bwd_reference,
                                           rms_norm_fwd,
                                           rms_norm_fwd_reference,
                                           rms_norm_reference)
from apex_tpu_torch.ops.lm_head_loss import (_lm_head_route, lm_head_loss,
                                             lm_head_loss_bwd_dw,
                                             lm_head_loss_bwd_dx,
                                             lm_head_loss_bwd_reference,
                                             lm_head_loss_fwd,
                                             lm_head_loss_fwd_reference)
from apex_tpu_torch.serve.decode import (_paged_route, paged_attention,
                                         paged_attention_fwd,
                                         paged_attention_reference)
from apex_tpu_torch.serve.kv_cache import (KVCacheConfig, init_kv_cache,
                                           paged_write)
from apex_tpu_torch.serve.megakernel import (fused_layer_fwd,
                                             fused_layer_reference)
from apex_tpu_torch.serve import megakernel as mk
from apex_tpu_torch.transformer.testing import (GPTConfig, T5Config,
                                                build_t5_train_step,
                                                init_gpt_params, t5_loss)

ln_mod = importlib.import_module("apex_tpu_torch.ops.layer_norm")
port_attention = importlib.import_module("apex_tpu_torch.ops.attention")

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 2 ** -7),
       torch.float16: (1e-3, 2 ** -7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(1, 768), (3, 768), (37, 128),
                                         (512, 1024), (5, 4096),
                                         (1024, 512)])
def test_layer_norm_kernel_matches_plain(dev, dtype, rows, hidden):
    g = torch.Generator(device=dev).manual_seed(rows * hidden)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2 + 1).to(dtype)
    w = torch.randn(hidden, device=dev, generator=g).to(dtype)
    b = torch.randn(hidden, device=dev, generator=g).to(dtype)
    before = ku.launch_counts().get("layer_norm_fwd", 0)
    got = layer_norm_fwd(x, w, b)
    assert ku.launch_counts()["layer_norm_fwd"] == before + 1
    _close(got, layer_norm_reference(x, w, b), dtype)
    assert got.dtype == dtype and got.shape == x.shape
    # the front door launches only where JAX's gate holds (rows % 8),
    # and gives the reference's bits elsewhere
    gated = ln_mod._pallas_ok(rows, hidden)
    got = layer_norm(x, w, b)
    assert ku.launch_counts()["layer_norm_fwd"] == before + 1 + gated
    if not gated:
        assert torch.equal(got, layer_norm_reference(x, w, b))


def test_layer_norm_kernel_refuses_what_it_cannot_take(dev):
    x = torch.randn(4, 100, device=dev)        # 100 % 4 fp32 ok; bf16 not
    w, b = torch.ones(100, device=dev), torch.zeros(100, device=dev)
    layer_norm_fwd(x, w, b)
    with pytest.raises(ValueError, match="multiple"):
        layer_norm_fwd(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="weight"):
        layer_norm_fwd(x, w.bfloat16(), b)     # weight and bias differ
    w8, b8 = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(torch.randn(768, 8, device=dev).t(), w8, b8)
    with pytest.raises(ValueError, match="pallas layer_norm requires"):
        layer_norm(x, w, b, use_pallas=True)
    with ku.force_plain():
        torch.testing.assert_close(layer_norm(x), layer_norm_reference(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_non_affine_is_the_plain_version_on_the_card(dev, dtype):
    """weight or bias None: the plain version on CUDA too, as JAX sends the
    non-affine form to its reference; no kernel launch, no raise."""
    x = torch.randn(64, 768, device=dev).to(dtype)
    w = torch.randn(768, device=dev).to(dtype)
    before = ku.launch_counts()
    for args in ((None, None), (w, None)):
        got = layer_norm(x, *args)
        assert got.dtype == dtype and got.is_cuda
        assert torch.equal(got, layer_norm_reference(x, *args))
    assert ku.launch_counts() == before


def _paged(dev, dtype, n, heads, hd, bs, mb, seed):
    rng = np.random.default_rng(seed)
    blocks = n * mb
    cfg = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                        num_blocks=blocks, block_size=bs, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    pools = {k: torch.randn(heads, blocks + 1, bs, hd, device=dev,
                            generator=g).to(dtype) for k in "kv"}
    q = torch.randn(n, heads, hd, device=dev, generator=g).to(dtype)
    bt = torch.from_numpy(
        rng.permutation(blocks).reshape(n, mb).astype(np.int32)).to(dev)
    ctx = rng.integers(1, mb * bs + 1, n)
    ctx[0] = 0
    if n > 2:
        ctx[1] = mb * bs
        ctx[2] = mb * bs + 7           # past the row's blocks: clamped
    return q, pools, cfg, bt, torch.from_numpy(ctx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,heads,hd,bs,mb", [
    (8, 12, 64, 16, 64), (3, 2, 32, 8, 3), (40, 4, 128, 16, 5),
    (5, 3, 64, 4, 33)])
def test_paged_attention_kernel_matches_plain(dev, dtype, n, heads, hd, bs,
                                              mb):
    q, pools, cfg, bt, ctx = _paged(dev, dtype, n, heads, hd, bs, mb,
                                    seed=n + hd)
    entry = _paged_route(dtype, hd)
    before = ku.launch_counts().get(entry, 0)
    got = paged_attention(q, pools, cfg, bt, ctx)
    assert ku.launch_counts()[entry] == before + 1
    want = paged_attention_reference(q, pools, cfg, bt, ctx)
    _close(got, want, dtype)
    assert not got[0].float().abs().max()        # ctx == 0 -> zeros


def test_paged_attention_kernel_refuses_what_it_cannot_take(dev):
    q, pools, cfg, bt, ctx = _paged(dev, torch.float32, 4, 2, 64, 16, 2, 1)
    scale = 1 / math.sqrt(64)
    paged_attention_fwd(q, pools, cfg, bt, ctx, scale)
    qd, pd, cd, _, _ = _paged(dev, torch.float32, 4, 2, 44, 16, 2, 1)
    with pytest.raises(ValueError, match="head_dim 44 .*multiple of 8"):
        paged_attention_fwd(qd, pd, cd, bt, ctx, scale)
    # above 256: the wide walk, no longer refused
    qd, pd, cd, _, _ = _paged(dev, torch.float32, 4, 2, 264, 16, 2, 1)
    before = ku.launch_counts().get("paged_wide_fwd", 0)
    paged_attention_fwd(qd, pd, cd, bt, ctx, 1 / math.sqrt(264))
    assert ku.launch_counts()["paged_wide_fwd"] == before + 1
    with pytest.raises(ValueError, match="rows_per_table=3"):
        paged_attention_fwd(q, pools, cfg, bt, ctx, scale, rows_per_table=3)
    with pytest.raises(ValueError, match="pool"):
        paged_attention_fwd(q, {k: v.bfloat16() for k, v in pools.items()},
                            cfg, bt, ctx, scale)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_fwd(q.transpose(0, 1).contiguous().transpose(0, 1),
                            pools, cfg, bt, ctx, scale)
    with pytest.raises(ValueError, match="rows"):
        paged_attention_fwd(q, pools, cfg, bt[:3], ctx, scale)


# ---------------------------------------------------------------------------
# training slice: LayerNorm backward, flash attention forward and backward


def _ln_case(dev, dtype, rows, hidden, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(hidden, device=dev, generator=g)).to(dtype)
    b = (0.1 * torch.randn(hidden, device=dev, generator=g)).to(dtype)
    dy = torch.randn(rows, hidden, device=dev, generator=g).to(dtype)
    return x, w, b, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(1, 768), (37, 128), (512, 768),
                                         (1000, 1024), (8192, 768),
                                         (4096, 512)])
def test_layer_norm_bwd_kernel_matches_plain(dev, dtype, rows, hidden):
    """dx within the file's tolerance; dw/db are sums over ``rows``, so
    their atol grows with sqrt(rows) (fp32 1e-5·sqrt(rows), bf16 one output
    rounding plus 2e-3·sqrt(rows))."""
    x, w, b, dy = _ln_case(dev, dtype, rows, hidden, rows + hidden)
    y, mean, rstd = layer_norm_fwd(x, w, b, stats=True)
    y_p, mean_p, rstd_p = layer_norm_fwd_reference(x, w, b)
    _close(y, y_p, dtype)
    torch.testing.assert_close(mean, mean_p, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(rstd, rstd_p, atol=2e-5, rtol=2e-5)
    before = ku.launch_counts().get("layer_norm_bwd", 0)
    dx, dw, db = layer_norm_bwd(dy, x, mean, rstd, w)
    assert ku.launch_counts()["layer_norm_bwd"] == before + 1
    pdx, pdw, pdb = layer_norm_bwd_reference(dy, x, mean, rstd, w)
    _close(dx, pdx, dtype)
    sum_atol = (1e-5 if dtype == torch.float32 else 2e-3) * math.sqrt(rows)
    for got, want in ((dw, pdw), (db, pdb)):
        assert got.dtype == dtype and got.shape == (hidden,)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=sum_atol,
                                   rtol=TOL[dtype][1])


def test_layer_norm_bwd_dw_db_bitwise_repeat(dev):
    """Two-stage reduction, no atomics: the same input gives bitwise the
    same dw/db (and dx) on every run."""
    x, w, b, dy = _ln_case(dev, torch.float32, 8192, 768, 7)
    _, mean, rstd = layer_norm_fwd(x, w, b, stats=True)
    first = layer_norm_bwd(dy, x, mean, rstd, w)
    for _ in range(3):
        again = layer_norm_bwd(dy, x, mean, rstd, w)
        for a, b_ in zip(first, again):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_is_differentiable_on_the_card(dev, dtype):
    """The repaired fault: ``layer_norm`` on CUDA has a grad_fn, and its
    gradients equal the plain version's (autograd through the reference
    math); a serving call without autograd keeps no statistics."""
    x, w, b, dy = _ln_case(dev, dtype, 64, 768, 3)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [w.clone().requires_grad_() for _ in range(2)]
    bs = [b.clone().requires_grad_() for _ in range(2)]
    y = layer_norm(xs[0], ws[0], bs[0])
    assert y.grad_fn is not None
    y.backward(dy)
    layer_norm_reference(xs[1], ws[1], bs[1]).backward(dy)
    for got, want in zip((xs[0], ws[0], bs[0]), (xs[1], ws[1], bs[1])):
        torch.testing.assert_close(got.grad.float(), want.grad.float(),
                                   atol=8 * TOL[dtype][0],
                                   rtol=TOL[dtype][1])
    with torch.no_grad():
        assert layer_norm(xs[0], ws[0], bs[0]).grad_fn is None


def _flash_names(dtype, d, bias=False):
    """The C entries the fwd, dQ and dK/dV wrappers (and, with ``bias``,
    the d(bias) wrapper) launch and count at this dtype and head dim: the
    tensor-core kernels for bf16 up to 256, the CUDA-core kernels
    otherwise."""
    prefix = ("flash_mma" if port_attention._flash_route(dtype, d)
              == "tensor_core" else "flash_attention")
    names = ("fwd", "bwd_dq", "bwd_dkv") + (("bwd_dbias",) if bias else ())
    return tuple(f"{prefix}_{n}" for n in names)


def _flash_case(dev, dtype, bh, s, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(bh, s, d, device=dev, generator=g).to(dtype)
            for _ in range(4)]


FLASH_CASES = [  # bh, s, d, causal, dropout rate
    (6, 256, 64, True, 0.0), (4, 128, 64, False, 0.0),
    (3, 192, 32, True, 0.0), (4, 128, 64, True, 0.2),
    (2, 128, 32, False, 0.1),
    # tail tiles (lengths not a multiple of 64), head dims 40 and 128
    (3, 1000, 64, True, 0.0), (2, 200, 40, False, 0.1),
    (4, 256, 128, True, 0.0), (2, 136, 128, False, 0.2),
    (3, 72, 24, True, 0.0),
    # head dims 136-256 (D = 256)
    (2, 256, 256, True, 0.0), (2, 200, 192, False, 0.1),
    (2, 128, 136, True, 0.0),
    # head dims 520-2048 (D = 1024, 16-row tiles; D = 2048, 8-row tiles)
    (2, 72, 1024, True, 0.0), (1, 40, 520, False, 0.1),
    (1, 64, 2048, True, 0.0), (2, 48, 1032, False, 0.0),
    # above 2048: the wide kernels, the head dim in chunks of 2048 columns
    (2, 40, 2056, True, 0.0), (1, 24, 4096, False, 0.1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d,causal,rate", FLASH_CASES)
def test_flash_kernels_match_plain(dev, dtype, bh, s, d, causal, rate):
    """o, lse, dq, dk, dv of the three kernels vs their plain versions at
    the same inputs (lse and delta from the kernel forward for both
    backwards); fp32 atol/rtol 1e-4 (sums over up to s keys in another
    order), bf16 one output rounding (rtol 2**-7) plus atol 1e-2 for the
    bf16-rounded p and ds products."""
    q, k, v, do = _flash_case(dev, dtype, bh, s, d, bh * s + d)
    scale, seed = 1 / math.sqrt(d), 4321
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2 ** -7)
    counts = ku.launch_counts()
    o, lse = flash_attention_fwd(q, k, v, scale, causal, rate, seed)
    o_p, lse_p = flash_attention_fwd_reference(q, k, v, scale, causal, rate,
                                               seed)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal,
                                rate, seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal,
                                     rate, seed)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, scale, causal,
                                         rate, seed)
    torch.cuda.synchronize()
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=name)
    after = ku.launch_counts()
    for name in _flash_names(dtype, d):
        assert after[name] == counts.get(name, 0) + 1


def test_flash_attention_autograd_on_the_card(dev):
    """The front door on CUDA goes through the kernels (one launch each)
    and gives the plain versions' output and gradients (fp32 atol 1e-4)."""
    q, k, v, do = (t.reshape(2, 3, 128, 64)
                   for t in _flash_case(dev, torch.float32, 6, 128, 64, 11))
    runs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = ku.launch_counts()
        if plain:
            with ku.force_plain():
                o = flash_attention(*leaves, causal=True)
                o.backward(do)
            assert ku.launch_counts() == before
        else:
            o = flash_attention(*leaves, causal=True)
            o.backward(do)
            assert ku.launch_counts()["flash_attention_bwd_dkv"] == \
                before.get("flash_attention_bwd_dkv", 0) + 1
        runs.append([o] + [t.grad for t in leaves])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_kernels_refuse_what_they_cannot_take(dev):
    q, k, v, do = _flash_case(dev, torch.float32, 2, 128, 64, 1)
    flash_attention_fwd(q, k, v, 0.125, True)
    flash_attention_fwd(*(t[..., :48].contiguous() for t in (q, k, v)),
                        0.125, False)                  # runs in D = 64
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(*(t[..., :36].contiguous() for t in (q, k, v)),
                            0.125, False)
    flash_attention_fwd(*(torch.randn(2, 128, 264, device=dev)
                          for _ in range(3)), 0.125, False)  # D = 512
    flash_attention_fwd(*(torch.randn(2, 64, 520, device=dev)
                          for _ in range(3)), 0.125, False)  # D = 1024
    wide = torch.randn(2, 64, 2056, device=dev)
    flash_attention_fwd(wide, wide, wide, 0.125, False)  # the wide kernels
    with pytest.raises(ValueError, match="head_dim 0 must be a positive"):
        flash_attention_fwd(*(t[..., :0] for t in (q, k, v)), 0.125, False)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_fwd(*(t[:, :100].contiguous() for t in (q, k, v)),
                            0.125, False)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_fwd(q[:, :64].contiguous(), k, v, 0.125, True)
    with pytest.raises(ValueError, match="k must be"):
        flash_attention_fwd(q, k.bfloat16(), v, 0.125, True)
    q_strided = torch.randn(2, 64, 128, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q_strided, k, v, 0.125, True)
    lse = torch.zeros(2, 128, 1, device=dev)
    with pytest.raises(ValueError, match="delta"):
        flash_attention_bwd_dq(q, k, v, do, lse, lse[:, :64], 0.125, True)


FLASH_BIAS_CASES = [  # batch, heads, sq, sk, d, causal, dropout rate
    (2, 4, 128, 128, 64, False, 0.0), (2, 3, 192, 192, 32, True, 0.0),
    (2, 2, 64, 256, 64, False, 0.0), (3, 2, 128, 128, 64, True, 0.2),
    # tail tiles, head dims 40 and 128
    (2, 2, 200, 328, 64, False, 0.0), (2, 2, 136, 136, 128, True, 0.1),
    (2, 3, 200, 200, 40, True, 0.0),
    # head dims 192 and 256 (D = 256)
    (2, 2, 128, 192, 256, False, 0.0), (2, 2, 136, 136, 192, True, 0.1),
    # head dims 1024 and 2048 (16- and 8-row tiles; the bias in 64-row
    # units), and above 2048 (the wide kernels)
    (2, 1, 72, 72, 1024, True, 0.0), (1, 2, 40, 104, 2048, False, 0.1),
    (1, 2, 40, 40, 2056, True, 0.0), (2, 1, 24, 56, 4096, False, 0.1)]


def _flash_bias_case(dev, dtype, b, heads, sq, sk, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b * heads, sq, d, device=dev, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b * heads, sk, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    bias = 2.0 * torch.randn(heads, sq, sk, device=dev, generator=g)
    return q, k, v, do, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,sq,sk,d,causal,rate", FLASH_BIAS_CASES)
def test_flash_bias_kernels_match_plain(dev, dtype, b, heads, sq, sk, d,
                                        causal, rate):
    """The four kernels with an fp32 (heads, sq, sk) bias vs their plain
    versions: o, lse, dq, dk, dv as without a bias (fp32 atol/rtol 1e-4,
    bf16 atol 1e-2 + rtol 2**-7), d(bias) fp32 within atol/rtol 1e-4 in
    both input types (both sides form the same fp32 products of the same
    inputs and sum the batch in fp32, in another order); above the causal
    diagonal d(bias) is exactly 0."""
    q, k, v, do, bias = _flash_bias_case(dev, dtype, b, heads, sq, sk, d,
                                         sq * sk + d + b)
    args = (1 / math.sqrt(d), causal, rate, 99)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2 ** -7)
    counts = ku.launch_counts()
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bias)
    o_p, lse_p = flash_attention_fwd_reference(q, k, v, *args, bias=bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, *args, bias=bias)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args,
                                     bias=bias)
    db = flash_attention_bwd_dbias(q, k, v, do, lse, delta, *args,
                                   bias=bias)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, *args,
                                         bias=bias)
    db_p = flash_attention_bwd_dbias_reference(q, k, v, o, lse, do, *args,
                                               bias=bias)
    torch.cuda.synchronize()
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=name)
    assert db.dtype == torch.float32 and db.shape == bias.shape
    torch.testing.assert_close(db, db_p, atol=1e-4, rtol=1e-4)
    if causal:
        above = torch.ones(sq, sk, dtype=torch.bool, device=dev).triu(1)
        assert not bool(db[:, above].any())
    after = ku.launch_counts()
    for name in _flash_names(dtype, d, bias=True):
        assert after[name] == counts.get(name, 0) + 1


@pytest.mark.parametrize("causal", [False, True])
def test_flash_dbias_bitwise_repeat(dev, causal):
    """d(bias) sums the batch in one fixed order: repeats are bitwise
    equal (bf16 inputs, 8 batch items, T5's decoder shape: the tensor-core
    kernel, 8 batch chunks added in order by a second launch)."""
    q, k, v, do, bias = _flash_bias_case(dev, torch.bfloat16, 8, 8, 128,
                                         128, 64, 5)
    args = (0.125, causal, 0.0, 0)
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bias)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    first = flash_attention_bwd_dbias(q, k, v, do, lse, delta, *args,
                                      bias=bias)
    for _ in range(3):
        again = flash_attention_bwd_dbias(q, k, v, do, lse, delta, *args,
                                          bias=bias)
        assert torch.equal(first, again)


def test_flash_attention_bias_autograd_on_the_card(dev):
    """The front door with a bias on CUDA goes through the four kernels
    (one launch each) and gives the plain versions' output and q, k, v
    and bias gradients (fp32 atol 1e-4); a bf16 bias gets a bf16
    gradient."""
    q, k, v, do, bias = _flash_bias_case(dev, torch.float32, 2, 3, 128, 128,
                                         64, 12)
    q, k, v, do = (t.reshape(2, 3, 128, 64) for t in (q, k, v, do))
    runs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        before = ku.launch_counts()
        if plain:
            with ku.force_plain():
                o = flash_attention(*leaves[:3], bias=leaves[3], causal=True)
                o.backward(do)
            assert ku.launch_counts() == before
        else:
            o = flash_attention(*leaves[:3], bias=leaves[3], causal=True)
            o.backward(do)
            assert ku.launch_counts()["flash_attention_bwd_dbias"] == \
                before.get("flash_attention_bwd_dbias", 0) + 1
        runs.append([o] + [t.grad for t in leaves])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    b16 = bias.bfloat16().requires_grad_()
    flash_attention(q, k, v, bias=b16).backward(do)
    assert b16.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("sq,sk,d,causal,bias", [
    (1000, 1000, 64, True, False), (200, 328, 40, False, True),
    (136, 136, 128, True, True), (256, 256, 256, True, True),
    (200, 200, 192, False, False)])
def test_flash_attention_tail_shapes_autograd_on_the_card(dev, sq, sk, d,
                                                          causal, bias):
    """The front door at a tail shape or a repaired head dim goes through
    the kernels (one launch each of fwd, dQ, dK/dV and, with a bias,
    d(bias)) and gives the plain versions' output and gradients (fp32
    atol 1e-4)."""
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q, do = (torch.randn(2, 3, sq, d, device=dev, generator=g)
             for _ in range(2))
    k, v = (torch.randn(2, 3, sk, d, device=dev, generator=g)
            for _ in range(2))
    bb = [torch.randn(3, sq, sk, device=dev, generator=g)] if bias else []
    names = ["flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"]
    names += ["flash_attention_bwd_dbias"] if bias else []
    runs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, *bb)]
        before = ku.launch_counts()
        with ku.force_plain() if plain else contextlib.nullcontext():
            o = flash_attention(*leaves[:3], causal=causal,
                                bias=leaves[3] if bias else None)
            o.backward(do)
        after = ku.launch_counts()
        for name in names:
            assert after.get(name, 0) == before.get(name, 0) + (not plain)
        runs.append([o] + [t.grad for t in leaves])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_shapes_jax_sends_to_its_reference_launch_nothing(dev):
    """Causal with sq != sk, a length not a multiple of 8, head_dim % 8 !=
    0: the plain reference on the card, as JAX routes them; no launch."""
    before = ku.launch_counts()
    for sq, sk, d, causal in ((64, 128, 64, True), (100, 100, 64, False),
                              (64, 64, 12, False)):
        q = torch.randn(1, 2, sq, d, device=dev)
        k = torch.randn(1, 2, sk, d, device=dev)
        got = flash_attention(q, k, k, causal=causal)
        torch.testing.assert_close(
            got, attention_reference(q, k, k, causal=causal))
    assert ku.launch_counts() == before


def test_flash_bias_kernels_refuse_what_they_cannot_take(dev):
    q, k, v, do, bias = _flash_bias_case(dev, torch.float32, 2, 2, 128, 128,
                                         64, 3)
    flash_attention_fwd(q, k, v, 0.125, False, bias=bias)
    with pytest.raises(ValueError, match="bias"):
        flash_attention_fwd(q, k, v, 0.125, False, bias=bias.bfloat16())
    with pytest.raises(ValueError, match="bias"):
        flash_attention_fwd(q, k, v, 0.125, False, bias=bias[:, :64])
    with pytest.raises(ValueError, match="heads"):
        flash_attention_fwd(q, k, v, 0.125, False,
                            bias=torch.zeros(3, 128, 128, device=dev))
    lse = torch.zeros(4, 128, 1, device=dev)
    with pytest.raises(ValueError, match="needs the bias"):
        flash_attention_bwd_dbias(q, k, v, do, lse, lse, 0.125, False,
                                  bias=None)


def test_t5_loss_kernels_match_plain_on_the_card(dev):
    """A small T5 proper (hidden 128, 2 heads of 64, 1 + 1 layers, s_enc
    128, s_dec 64, fp32): loss and every gradient leaf through the kernels
    (bias fwd/dQ/dK-dV/d(bias), cross-attention, LN, fused loss) vs the
    plain versions forced; loss rel 1e-5, each leaf max err <= 1e-5 of
    its max |g|, as ``chip_smoke.py`` holds T5-small."""
    cfg = T5Config(vocab_size=512, hidden=128, num_heads=2, enc_layers=1,
                   dec_layers=1, dtype=torch.float32,
                   relative_position_bias=True, encoder_final_ln=True)
    _, params, _, (enc, dec, tgt) = build_t5_train_step(cfg, 2, 128, 64,
                                                        device=dev)
    leaves = list(named_leaves(params))
    runs = []
    for plain in (False, True):
        for _, p in leaves:
            p.grad = None
        before = ku.launch_counts()
        if plain:
            with ku.force_plain():
                loss = t5_loss(params, enc, dec, tgt, cfg)
                loss.backward()
            assert ku.launch_counts() == before
        else:
            loss = t5_loss(params, enc, dec, tgt, cfg)
            loss.backward()
            assert ku.launch_counts()["flash_attention_bwd_dbias"] == \
                before.get("flash_attention_bwd_dbias", 0) + 2
        runs.append((loss.item(), [p.grad.clone() for _, p in leaves]))
    (lk, gk), (lp, gp) = runs
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for (name, _), a, b in zip(leaves, gk, gp):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


# ---------------------------------------------------------------------------
# fused LM-head + cross-entropy (forward, dX, dW) and the Adam tail


def _lm_case(dev, dtype, n, v, h, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, device=dev, generator=g).to(dtype)
    w = (0.05 * torch.randn(v, h, device=dev, generator=g)).to(dtype)
    t = torch.randint(0, v, (n,), device=dev, generator=g)
    gr = torch.randn(n, device=dev, generator=g)
    return x, w, t, gr


def _close_scaled(got, want, atol_of_max, rtol, name):
    """|got − want| ≤ atol_of_max·max|want| + rtol·|want|."""
    torch.cuda.synchronize()
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want,
                               atol=atol_of_max * scale, rtol=rtol, msg=name)


def _close_rows(got, want, atol_of_row_max, rtol, name):
    """|got − want| ≤ atol_of_row_max·max|want[row]| + rtol·|want|, row by
    row: a vocab row of dw that no target hits holds only the softmax
    term, far below a hit row's scale, and is held to its own max."""
    torch.cuda.synchronize()
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    row_max = want.abs().amax(dim=1, keepdim=True)
    bad = err > atol_of_row_max * row_max + rtol * want.abs()
    assert bool(got.isfinite().all()) and not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements outside {atol_of_row_max} of "
        f"their row's max + rtol {rtol}; max abs err {float(err.max()):.3e}")


LM_CASES = [(96, 1000, 128), (256, 512, 768), (8, 37, 256), (600, 3000, 384),
            (128, 257, 1152), (1024, 32128, 512)]   # the last: T5-small's


def _lm_fwd_name(dtype):
    """The forward's C entry at this dtype: the tensor-core one of
    ``csrc/lm_head_mma.cu`` for bf16, the CUDA-core one of
    ``csrc/lm_head_loss.cu`` for fp32."""
    if _lm_head_route(dtype, 128) == "tensor_core":
        return "lm_head_mma_fwd"
    return "lm_head_loss_fwd"


def _lm_bwd_names(dtype):
    """The C entries the dX and dW wrappers launch (and count) at this
    dtype: the tensor-core ones of ``csrc/lm_head_mma.cu`` for bf16, the
    CUDA-core ones of ``csrc/lm_head_loss.cu`` for fp32."""
    if _lm_head_route(dtype, 128) == "tensor_core":
        return ("lm_head_mma_bwd_dx", "lm_head_mma_bwd_dw")
    return ("lm_head_loss_bwd_dx", "lm_head_loss_bwd_dw")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v,h", LM_CASES)
def test_lm_head_loss_kernels_match_plain(dev, dtype, n, v, h):
    """lse, pred, dx and dw of the three kernels vs their plain versions at
    ragged row and vocab counts (and h = 1152, two hidden chunks in fp32).
    lse/pred: atol/rtol 2e-5 fp32 (sums over h in another order), 2e-4
    bf16 (the same bf16 products, fp32 sums). dx, dw, row by row, with
    the targets and with none hit: fp32 1e-5 of the row's max plus rtol
    1e-4; bf16 1e-2 of the row's max plus one bf16 step (dl is rounded to
    bf16 on both sides from scores that differ in the last fp32 bits, so a
    rounding may flip by one step)."""
    x, w, t, g = _lm_case(dev, dtype, n, v, h, n + v + h)
    counts = ku.launch_counts()
    lse, pred = lm_head_loss_fwd(x, w, t)
    lse_p, pred_p = lm_head_loss_fwd_reference(x, w, t)
    tol = 2e-5 if dtype == torch.float32 else 2e-4
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, atol=tol, rtol=tol)
    torch.testing.assert_close(pred, pred_p, atol=tol, rtol=tol)
    dx = lm_head_loss_bwd_dx(x, w, t, lse, g)
    dw = lm_head_loss_bwd_dw(x, w, t, lse, g)
    dx_p, dw_p = lm_head_loss_bwd_reference(x, w, t, lse, g)
    atol, rtol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-2, 2 ** -7)
    assert dx.dtype == dw.dtype == dtype
    _close_rows(dx, dx_p, atol, rtol, "dx")
    _close_rows(dw, dw_p, atol, rtol, "dw")
    after = ku.launch_counts()
    for name in (_lm_fwd_name(dtype), *_lm_bwd_names(dtype)):
        assert after[name] == counts.get(name, 0) + 1
    # the softmax term alone (no target hit), which the one-hot term
    # outweighs in dx and in the hit rows of dw
    none = torch.full_like(t, -1)
    dx_p, dw_p = lm_head_loss_bwd_reference(x, w, none, lse, g)
    _close_rows(lm_head_loss_bwd_dx(x, w, none, lse, g), dx_p, atol, rtol,
                "dx, softmax term")
    _close_rows(lm_head_loss_bwd_dw(x, w, none, lse, g), dw_p, atol, rtol,
                "dw, softmax term")


# the tensor-core dX and dW: GPT-2-124M's and T5-small's shapes, ragged
# rows (96) and vocab (1000), one CTA a row tile (h up to 512) and
# clusters of 2-8 CTAs (h 640-2048), two panels a CTA (h 3200), and dX's
# vocab splits (1-16)
LM_MMA_CASES = [(8192, 50304, 768), (1024, 32128, 512), (96, 1000, 768),
                (512, 1000, 2048), (96, 1000, 3200), (8, 37, 256),
                (600, 3000, 384), (128, 257, 1152), (200, 4100, 640),
                (40, 777, 512)]


@pytest.mark.parametrize("n,v,h", LM_MMA_CASES)
def test_lm_head_mma_kernels_match_plain(dev, n, v, h):
    """The tensor-core dX and dW vs their plain versions, bf16, with g =
    1/n as on the training path (most vocab rows of dW then hold only the
    softmax term), with the targets and with none hit, at chip_smoke's bf16
    tolerance: 1e-2 of the row's max plus one bf16 step (dl is rounded to
    bf16 on both sides from scores that differ in the last fp32 bits).
    One launch of each, none of the CUDA-core dX and dW."""
    x, w, t, _ = _lm_case(dev, torch.bfloat16, n, v, h, n + v + h)
    g = torch.full((n,), 1.0 / n, device=dev)
    lse, _ = lm_head_loss_fwd(x, w, t)
    counts = ku.launch_counts()
    dx = lm_head_loss_bwd_dx(x, w, t, lse, g)
    dw = lm_head_loss_bwd_dw(x, w, t, lse, g)
    after = ku.launch_counts()
    for name in ("lm_head_mma_bwd_dx", "lm_head_mma_bwd_dw"):
        assert after[name] == counts.get(name, 0) + 1
    for name in ("lm_head_loss_bwd_dx", "lm_head_loss_bwd_dw"):
        assert after.get(name, 0) == counts.get(name, 0)
    dx_p, dw_p = lm_head_loss_bwd_reference(x, w, t, lse, g)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close_rows(dx, dx_p, 1e-2, 2 ** -7, "dx")
    _close_rows(dw, dw_p, 1e-2, 2 ** -7, "dw")
    del dx_p, dw_p
    none = torch.full_like(t, -1)
    dx_p, dw_p = lm_head_loss_bwd_reference(x, w, none, lse, g)
    _close_rows(lm_head_loss_bwd_dx(x, w, none, lse, g), dx_p, 1e-2,
                2 ** -7, "dx, softmax term")
    _close_rows(lm_head_loss_bwd_dw(x, w, none, lse, g), dw_p, 1e-2,
                2 ** -7, "dw, softmax term")


@pytest.mark.parametrize("n,v,h", [(1024, 32128, 512), (2048, 5000, 768),
                                   (96, 1000, 2048)])
def test_lm_head_mma_bitwise_repeat(dev, n, v, h):
    """dX (vocab splits 8, 2 and 8: partials added in split order) and dW
    (one owner per output element; at h 768 and 2048 the cluster's score
    parts summed in rank order) give the same bits on every launch."""
    x, w, t, g = _lm_case(dev, torch.bfloat16, n, v, h, 11)
    lse, _ = lm_head_loss_fwd(x, w, t)
    first = (lm_head_loss_bwd_dx(x, w, t, lse, g),
             lm_head_loss_bwd_dw(x, w, t, lse, g))
    for _ in range(3):
        assert torch.equal(first[0], lm_head_loss_bwd_dx(x, w, t, lse, g))
        assert torch.equal(first[1], lm_head_loss_bwd_dw(x, w, t, lse, g))


# the tensor-core forward: GPT-2-124M's and T5-small's heads, ragged rows
# and vocab, the wide (h 2048) check, a vocab past one 128-row tile edge
LM_FWD_CASES = [(8192, 50304, 768), (1024, 32128, 512), (96, 1000, 768),
                (512, 1000, 2048), (200, 4100, 384), (8, 37, 256)]


@pytest.mark.parametrize("n,v,h", LM_FWD_CASES)
def test_lm_head_mma_fwd_matches_plain_and_repeats_bitwise(dev, n, v, h):
    """The tensor-core forward (bf16) vs its plain version: lse, pred and
    the loss within 2e-4 (the same bf16 products, fp32 sums in another
    order); a target of -1 (and one past V) gives pred 0; one launch of
    ``lm_head_mma_fwd``, none of the CUDA-core forward; the same bits on
    every launch (the splits merged in order)."""
    x, w, t, _ = _lm_case(dev, torch.bfloat16, n, v, h, n + v + h)
    t[::7] = -1
    t[1::7] = v
    before = ku.launch_counts()
    lse, pred = lm_head_loss_fwd(x, w, t)
    after = ku.launch_counts()
    assert after["lm_head_mma_fwd"] == before.get("lm_head_mma_fwd", 0) + 1
    assert after.get("lm_head_loss_fwd", 0) == \
        before.get("lm_head_loss_fwd", 0)
    lse_p, pred_p = lm_head_loss_fwd_reference(x, w, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(pred, pred_p, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(lse - pred, lse_p - pred_p, atol=2e-4,
                               rtol=2e-4)
    assert not bool(pred[::7].any()) and not bool(pred[1::7].any())
    for _ in range(3):
        again = lm_head_loss_fwd(x, w, t)
        assert torch.equal(lse, again[0]) and torch.equal(pred, again[1])


@pytest.mark.parametrize("targets", ["none", "random"])
def test_lm_head_fp32_wide_dx_matches_plain_and_fp64(dev, targets):
    """The fp32 CUDA-core dX at h 2048 (512 rows, V 1000, g = 1/n), with
    no target hit (the softmax term alone, which cancels to a small row
    max) and with targets: within the fp32 gate (1e-5 of the row's max
    plus rtol 1e-4) of the plain version and of dx evaluated in fp64 from
    the same x, w, lse and g."""
    x, w, t, _ = _lm_case(dev, torch.float32, 512, 1000, 2048, 17)
    if targets == "none":
        t = torch.full_like(t, -1)
    g = torch.full((512,), 1.0 / 512, device=dev)
    lse, _ = lm_head_loss_fwd(x, w, t)
    dx = lm_head_loss_bwd_dx(x, w, t, lse, g)
    dx_p, _ = lm_head_loss_bwd_reference(x, w, t, lse, g)
    _close_rows(dx, dx_p, 1e-5, 1e-4, "dx vs plain")
    p = torch.exp(torch.matmul(x.double(), w.double().t())
                  - lse.double()[:, None])
    hit = torch.arange(1000, device=dev)[None, :] == t[:, None]
    dx64 = torch.matmul((p - hit.double()) * g.double()[:, None],
                        w.double())
    err = (dx.double() - dx64).abs()
    row_max = dx64.abs().amax(dim=1, keepdim=True)
    assert not bool((err > 1e-5 * row_max + 1e-4 * dx64.abs()).any()), (
        f"dx vs fp64: {float((err / row_max).max()):.3e} of the row's max")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_head_loss_backward_launches_its_route(dev, dtype):
    """One ``LMHeadLoss`` backward on CUDA launches one dX and one dW of
    its route (bf16: ``lm_head_mma_bwd_*``; fp32: ``lm_head_loss_bwd_*``)
    and no kernel of the other."""
    x, w, t, _ = _lm_case(dev, dtype, 256, 3000, 768, 2)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = ku.launch_counts()
    lm_head_loss(xs, ws, t).mean().backward()
    after = ku.launch_counts()
    mine = _lm_bwd_names(dtype)
    other = _lm_bwd_names(torch.float32 if dtype == torch.bfloat16
                          else torch.bfloat16)
    for name in mine:
        assert after[name] == before.get(name, 0) + 1
    for name in other:
        assert after.get(name, 0) == before.get(name, 0)


def test_lm_head_loss_dw_bitwise_repeat(dev):
    """Each dw row has one owning block that sums the rows in order: the
    same inputs give bitwise the same dw (and dx, lse) on every run."""
    x, w, t, g = _lm_case(dev, torch.bfloat16, 1024, 5000, 768, 5)
    lse, _ = lm_head_loss_fwd(x, w, t)
    first = (lse, lm_head_loss_bwd_dx(x, w, t, lse, g),
             lm_head_loss_bwd_dw(x, w, t, lse, g))
    for _ in range(3):
        lse2, _ = lm_head_loss_fwd(x, w, t)
        again = (lse2, lm_head_loss_bwd_dx(x, w, t, lse2, g),
                 lm_head_loss_bwd_dw(x, w, t, lse2, g))
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_lm_head_loss_autograd_on_the_card(dev):
    """The front door on CUDA launches the three kernels once each and
    gives the plain versions' loss and gradients (fp32, 1e-5 of max)."""
    x, w, t, _ = _lm_case(dev, torch.float32, 2, 777, 256, 9)
    x = torch.randn(2, 48, 256, device=dev)
    t = t.new_tensor(np.random.default_rng(0).integers(0, 777, (2, 48)))
    runs = []
    for plain in (False, True):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = ku.launch_counts()
        if plain:
            with ku.force_plain():
                loss = lm_head_loss(xs, ws, t)
                loss.mean().backward()
            assert ku.launch_counts() == before
        else:
            loss = lm_head_loss(xs, ws, t)
            loss.mean().backward()
            assert ku.launch_counts()["lm_head_loss_bwd_dw"] == \
                before.get("lm_head_loss_bwd_dw", 0) + 1
        assert loss.shape == t.shape and loss.dtype == torch.float32
        runs.append((loss, xs.grad, ws.grad))
    for got, want in zip(*runs):
        _close_scaled(got, want, 1e-5, 1e-5, "lm_head_loss autograd")


def test_lm_head_loss_kernels_refuse_what_they_cannot_take(dev):
    x, w, t, g = _lm_case(dev, torch.float32, 16, 50, 128, 1)
    lm_head_loss_fwd(x, w, t)
    with pytest.raises(ValueError, match="multiple of 128"):
        lm_head_loss_fwd(x[:, :100].contiguous(), w[:, :100].contiguous(), t)
    with pytest.raises(ValueError, match="w must be"):
        lm_head_loss_fwd(x, w.bfloat16(), t)
    with pytest.raises(ValueError, match="targets"):
        lm_head_loss_fwd(x, w, t.int())
    with pytest.raises(ValueError, match="contiguous"):
        lm_head_loss_fwd(torch.randn(128, 16, device=dev).t(), w, t)
    lse, _ = lm_head_loss_fwd(x, w, t)
    with pytest.raises(ValueError, match="g must be"):
        lm_head_loss_bwd_dx(x, w, t, lse, g[:8])


def _tail_case(dev, shape, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g, p = (torch.randn(shape, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    m = torch.randn(shape, device=dev, generator=gen)
    v = torch.rand(shape, device=dev, generator=gen)
    return g, m, v, p


TAIL_KW = dict(betas=(0.9, 0.999), eps=1e-8)
C1, C2 = float(np.float32(1 - 0.9 ** 3)), float(np.float32(1 - 0.999 ** 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 13), (300, 700), (1,), (70001,),
                                   (256 * 1056 + 3,)])
@pytest.mark.parametrize("wd,adam_w", [(0.0, True), (0.01, True),
                                       (0.01, False)])
def test_adam_tail_kernel_matches_plain(dev, dtype, shape, wd, adam_w):
    """u, m', v' of the kernel vs the plain version (rtol 1e-6, atol
    1e-7: IEEE division and square root on both sides, torch divides a
    tensor by a scalar through its reciprocal), leaves that are not a
    multiple of the block included; m and v are updated in place."""
    g, m, v, p = _tail_case(dev, shape, dtype, len(shape) + shape[0])
    want = adam_tail_reference(g, m, v, p, C1, C2, weight_decay=wd,
                               adam_w_mode=adam_w, **TAIL_KW)
    m_in, v_in = m.clone(), v.clone()
    before = ku.launch_counts().get("fused_adam_tail", 0)
    u, m_out, v_out = fused_adam_tail(g, m_in, v_in, p, C1, C2,
                                      weight_decay=wd, adam_w_mode=adam_w,
                                      **TAIL_KW)
    assert ku.launch_counts()["fused_adam_tail"] == before + 1
    assert m_out.data_ptr() == m_in.data_ptr()
    assert v_out.data_ptr() == v_in.data_ptr()
    torch.cuda.synchronize()
    for got, ref, name in zip((u, m_in, v_in), want, ("u", "m", "v")):
        assert got.dtype == torch.float32 and got.shape == shape, name
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7, msg=name)


def test_lamb_tail_kernel_sums_match_and_repeat_bitwise(dev):
    """LAMB: u, m', v' as Adam's; Σp² and Σu² within rtol 1e-5 of the
    plain sums, and bitwise equal over repeats (two-stage, in-order)."""
    shape = (1000, 777)
    g, m, v, p = _tail_case(dev, shape, torch.bfloat16, 3)
    want = lamb_tail_reference(g, m, v, p, C1, C2, weight_decay=0.01,
                               **TAIL_KW)
    outs = []
    for _ in range(3):
        got = fused_lamb_tail(g, m.clone(), v.clone(), p, C1, C2,
                              weight_decay=0.01, **TAIL_KW)
        outs.append(got)
    torch.cuda.synchronize()
    for got, ref in zip(outs[0][:3], want[:3]):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)
    for got, ref in zip(outs[0][3:], want[3:]):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    for again in outs[1:]:
        for a, b in zip(outs[0], again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lamb", [False, True])
def test_adam_tail_flag_leaves_state_and_param_unchanged(dev, dtype, lamb):
    """A set found_inf flag (device fp32): the kernel leaves m and v
    bitwise, writes u = 0, so p + (-lr·u) is p bitwise, and the LAMB sums
    are 0; a clear flag gives the unflagged launch's bits."""
    g, m, v, p = _tail_case(dev, (300, 700), dtype, 11)
    tail = fused_lamb_tail if lamb else fused_adam_tail
    kw = dict(TAIL_KW, weight_decay=0.01)
    m1, v1 = m.clone(), v.clone()
    out = tail(g, m1, v1, p, C1, C2, found_inf=torch.ones(1, device=dev),
               **kw)
    torch.cuda.synchronize()
    assert torch.equal(m1, m) and torch.equal(v1, v)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(p + (-1e-4 * out[0]).to(p.dtype), p)
    if lamb:
        assert float(out[3]) == 0.0 and float(out[4]) == 0.0
    clear = tail(g, m.clone(), v.clone(), p, C1, C2,
                 found_inf=torch.zeros(1, device=dev), **kw)
    plain = tail(g, m.clone(), v.clone(), p, C1, C2, **kw)
    torch.cuda.synchronize()
    for a, b in zip(clear, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_tail_device_corrections(dev, dtype):
    """c1, c2 from a device pointer holding the host's values give the
    host launch's bits; computed on the card from a device count (``1 -
    β**t`` in fp32) they match the plain version given the same tensor
    (rtol 1e-6, atol 1e-7)."""
    g, m, v, p = _tail_case(dev, (70001,), dtype, 12)
    corr = torch.tensor([C1, C2], dtype=torch.float32, device=dev)
    a = fused_adam_tail(g, m.clone(), v.clone(), p, C1, C2, **TAIL_KW)
    b = fused_adam_tail(g, m.clone(), v.clone(), p, 0.5, 0.5, corr=corr,
                        **TAIL_KW)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    count = torch.full((), 3, dtype=torch.int32, device=dev)
    betas = torch.tensor([0.9, 0.999], dtype=torch.float32, device=dev)
    corr = 1.0 - torch.pow(betas, count.float())
    got = fused_adam_tail(g, m.clone(), v.clone(), p, 1.0, 1.0, corr=corr,
                          **TAIL_KW)
    want = adam_tail_reference(g, m.clone(), v.clone(), p, 1.0, 1.0,
                               corr=corr, **TAIL_KW)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_fused_adam_device_step_skips_without_a_host_read(dev):
    """FusedAdam(step(found_inf=...)) on the card: a clean step, then a
    flagged one that keeps params, moments and the count bitwise; the
    count stays a device tensor and no synchronizing call is made
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    from apex_tpu_torch.optimizers import FusedAdam

    params = [torch.randn(300, 70, device=dev), torch.randn(7, device=dev)]
    opt = FusedAdam(params, lr=1e-3)
    for p in params:
        p.grad = torch.randn_like(p)
    opt.step(found_inf=torch.zeros((), device=dev))
    before = [p.clone() for p in params]
    moments = [(opt.state[p]["exp_avg"].clone(),
                opt.state[p]["exp_avg_sq"].clone()) for p in params]
    count = opt.param_groups[0]["step"].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step(found_inf=torch.ones((), device=dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for p, b, (m, v) in zip(params, before, moments):
        assert torch.equal(p, b)
        assert torch.equal(opt.state[p]["exp_avg"], m)
        assert torch.equal(opt.state[p]["exp_avg_sq"], v)
    assert torch.equal(opt.param_groups[0]["step"], count)
    assert opt.param_groups[0]["step"].is_cuda


# every kernel of a training path in fp16, through its bf16 test's checks
# and gates (fp16 keeps 3 more mantissa bits than bf16: the bf16 gates are
# the loosest these cases may have): LN / RMS with fp16 and fp32 weights,
# flash on the tensor cores (d <= 256) and the CUDA cores (d 520, 1024)
# and the wide kernels (2056), with a bias, varlen likewise, the LM head,
# the Adam tail (its flag and device corrections) and hidden dropout
FP16 = torch.float16
FP16_CASES = {
    "layer_norm_fwd": lambda dev: test_layer_norm_kernel_matches_plain(
        dev, FP16, 512, 1024),
    "layer_norm_bwd": lambda dev: test_layer_norm_bwd_kernel_matches_plain(
        dev, FP16, 8192, 768),
    "layer_norm_autograd":
        lambda dev: test_layer_norm_is_differentiable_on_the_card(dev, FP16),
    "layer_norm_fp32_w": lambda dev: test_layer_norm_mixed_types_match_plain(
        dev, FP16, torch.float32, 64, 768),
    "layer_norm_wide": lambda dev: test_layer_norm_mixed_types_match_plain(
        dev, FP16, FP16, 16, 12288),
    "rms_norm": lambda dev: test_rms_norm_kernels_match_plain(
        dev, FP16, FP16, 8192, 768),
    "rms_norm_fp32_w": lambda dev: test_rms_norm_kernels_match_plain(
        dev, FP16, torch.float32, 4096, 512),
    "flash_d64": lambda dev: test_flash_kernels_match_plain(
        dev, FP16, 6, 256, 64, True, 0.0),
    "flash_d64_dropout": lambda dev: test_flash_kernels_match_plain(
        dev, FP16, 4, 128, 64, True, 0.2),
    "flash_d40_tail": lambda dev: test_flash_kernels_match_plain(
        dev, FP16, 2, 200, 40, False, 0.1),
    "flash_d256": lambda dev: test_flash_kernels_match_plain(
        dev, FP16, 2, 256, 256, True, 0.0),
    "flash_d520": lambda dev: test_flash_kernels_match_plain(
        dev, FP16, 1, 40, 520, False, 0.1),
    "flash_d1024": lambda dev: test_flash_kernels_match_plain(
        dev, FP16, 2, 72, 1024, True, 0.0),
    "flash_d2056": lambda dev: test_flash_kernels_match_plain(
        dev, FP16, 2, 40, 2056, True, 0.0),
    "flash_bias_d64": lambda dev: test_flash_bias_kernels_match_plain(
        dev, FP16, 3, 2, 128, 128, 64, True, 0.2),
    "flash_bias_d1024": lambda dev: test_flash_bias_kernels_match_plain(
        dev, FP16, 2, 1, 72, 72, 1024, True, 0.0),
    "varlen_d64": lambda dev: test_varlen_kernels_match_plain(
        dev, FP16, 2, 3, 320, 64, True, False),
    "varlen_d256": lambda dev: test_varlen_kernels_match_plain(
        dev, FP16, 1, 2, 320, 256, True, True),
    "varlen_d1024": lambda dev: test_varlen_kernels_match_plain(
        dev, FP16, 1, 1, 320, 1024, True, True),
    "varlen_d2056": lambda dev: test_varlen_kernels_match_plain(
        dev, FP16, 1, 1, 256, 2056, True, True),
    "lm_head": lambda dev: test_lm_head_loss_kernels_match_plain(
        dev, FP16, 600, 3000, 384),
    "lm_head_t5": lambda dev: test_lm_head_loss_kernels_match_plain(
        dev, FP16, 1024, 32128, 512),
    "lm_head_cluster": lambda dev: test_lm_head_loss_kernels_match_plain(
        dev, FP16, 128, 257, 1152),
    "adam_tail": lambda dev: test_adam_tail_kernel_matches_plain(
        dev, FP16, (300, 700), 0.01, True),
    "adam_tail_l2": lambda dev: test_adam_tail_kernel_matches_plain(
        dev, FP16, (70001,), 0.01, False),
    "adam_tail_flag": lambda dev:
        test_adam_tail_flag_leaves_state_and_param_unchanged(dev, FP16,
                                                             False),
    "lamb_tail_flag": lambda dev:
        test_adam_tail_flag_leaves_state_and_param_unchanged(dev, FP16,
                                                             True),
    "adam_tail_corr": lambda dev: test_adam_tail_device_corrections(dev,
                                                                    FP16),
    "dropout": lambda dev: test_hidden_dropout_kernel_bitwise_equals_plain(
        dev, FP16, (8, 1024, 768), 0.1),
    "dropout_odd": lambda dev: test_hidden_dropout_kernel_bitwise_equals_plain(
        dev, FP16, (1001,), 0.5),
}


@pytest.mark.parametrize("case", list(FP16_CASES))
def test_kernels_take_fp16(dev, case):
    """Every kernel a training path reaches takes fp16 on the card, as
    JAX's Pallas wrappers do in interpret mode: launched (counted), in
    fp16 where JAX returns x's type, and within its bf16 gate of the plain
    version on the same inputs."""
    FP16_CASES[case](dev)


def test_c6_serving_and_codec_kernels_raise_on_fp16(dev):
    """Since C6 the serving kernels (paged attention, the fused layer) and
    the codec take fp16 on the card (their fp16 cases: the dtype
    parametrizations of the paged, megakernel and codec tests); a type
    none of them takes (float64) still raises rather than running another
    way."""
    from apex_tpu_torch.comm import quantize as pq
    q, pools, cfg, bt, ctx = _paged(dev, torch.float32, 4, 2, 64, 16, 2, 1)
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        paged_attention_fwd(q.double(),
                            {k: v.double() for k, v in pools.items()}, cfg,
                            bt, ctx, 0.125)
    x, lp, layer, cfg16, kv16, bt, start, _, active = _fused_case(
        dev, FP16, "none", 2, 1)
    before = ku.launch_counts().get("megakernel", 0)
    fused_layer_fwd(x, lp, _clone(layer), cfg16, kv16, bt, start, None,
                    active)
    assert ku.launch_counts()["megakernel"] == before + 1
    with pytest.raises(ValueError, match="x must be"):
        fused_layer_fwd(x.double(), lp, layer, cfg16, kv16, bt, start, None,
                        active)
    with pytest.raises(ValueError, match="float16"):
        pq.quantize_blocks(torch.randn(32, 128, device=dev).double())
    codes, _ = pq.quantize_blocks(torch.randn(32, 128, device=dev).half())
    assert codes.shape == (32, 128)


def test_fp8_product_routes_agree(dev):
    """The fp8 product on the tensor cores (``torch._scaled_mm``) and as
    the fp32 product of the upcast operands: the same codes, sums in other
    orders and precisions (Hopper's fp8 MMA keeps about 14 bits of its
    running sum between cuBLAS's promotions to fp32): max abs difference
    within 1e-3 of the output's largest magnitude; the route follows the
    shapes (a dim not % 16 takes the upcast)."""
    from apex_tpu_torch.amp import fp8

    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(256, 1024, device=dev, generator=gen)
    w = torch.randn(1024, 512, device=dev, generator=gen) * 0.05
    for da, db in ((fp8.E4M3, fp8.E4M3), (fp8.E5M2, fp8.E4M3),
                   (fp8.E4M3, fp8.E5M2)):
        a = fp8.cast_fp8(x, torch.tensor(1.0, device=dev), da)
        b = fp8.cast_fp8(w, torch.tensor(1.0, device=dev), db)
        assert fp8.fp8_route(a, b) == "scaled_mm"
        tc = fp8.fp8_matmul(a, b)
        up = fp8.fp8_matmul(a, b, route="upcast")
        assert float((tc - up).abs().max()) <= 1e-3 * float(
            up.abs().max())
    assert fp8.fp8_route(a[:, :1000], b[:1000]) == "upcast"


# ---------------------------------------------------------------------------
# quantized paged attention and the fused layer (the megakernel)

QUANT = {"int8": dict(quantized=True, bits=8),
         "int4": dict(quantized=True, bits=4),
         "int4_g16": dict(quantized=True, bits=4, group_size=16)}


def _quant_pools(dev, dtype, mode, n, heads, hd, bs, mb, seed):
    """Pools written through the plain codec with random K/V at every
    position of every row's blocks, and the paged kernel's inputs."""
    q, pools, _, bt, ctx = _paged(dev, dtype, n, heads, hd, bs, mb, seed)
    cfg = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                        num_blocks=n * mb, block_size=bs, dtype=dtype,
                        **QUANT[mode])
    layer = {k: v[0] for k, v in init_kv_cache(cfg, dev).items()}
    pos = torch.arange(mb * bs, device=dev).repeat(n)
    rows = bt.repeat_interleave(mb * bs, dim=0)
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(heads, n * mb * bs, hd, device=dev, generator=g) * 2
    v = torch.randn(heads, n * mb * bs, hd, device=dev, generator=g)
    paged_write(layer, cfg, k.to(dtype), v.to(dtype), rows, pos,
                torch.ones_like(pos, dtype=torch.bool))
    return q, layer, cfg, bt, ctx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mode", list(QUANT))
@pytest.mark.parametrize("n,heads,hd,bs,mb", [
    (8, 12, 64, 16, 8), (3, 2, 32, 8, 3), (5, 4, 128, 16, 5)])
def test_quant_paged_attention_kernel_matches_plain(dev, dtype, mode, n,
                                                    heads, hd, bs, mb):
    """int8 / int4 pools: bf16 at atol 1e-2 (the codes dequantized and the
    products summed on the tensor cores, p as two bf16 terms), fp32 at
    2e-5."""
    q, layer, cfg, bt, ctx = _quant_pools(dev, dtype, mode, n, heads, hd,
                                          bs, mb, seed=n + hd)
    entry = _paged_route(dtype, hd)
    before = ku.launch_counts().get(entry, 0)
    got = paged_attention(q, layer, cfg, bt, ctx)
    assert ku.launch_counts()[entry] == before + 1
    want = paged_attention_reference(q, layer, cfg, bt, ctx)
    torch.cuda.synchronize()
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[0].float().abs().max()


# the split walk: every head_dim % 8 up to 256, groups of rows sharing a
# block table (verify's k + 1 rows a slot, a prefill chunk's 32), pools of
# each format; a row's bits do not depend on its group

PAGED_POOLS = {"none": {}, "int8": dict(quantized=True, bits=8),
               "int4": dict(quantized=True, bits=4),
               "int4_g8": dict(quantized=True, bits=4, group_size=8)}


def _paged_groups(dev, dtype, mode, slots, g, hd, seed, heads=3, bs=16,
                  mb=24):
    """``slots`` block-table rows of ``mb`` blocks, each shared by ``g``
    flat rows (``bt`` repeated, as ``paged_layer_stack`` builds it), pools
    holding random K/V at every position of every slot (written through
    the plain codec for quantized formats); contexts in [0, capacity + 7],
    one slot's rows all past its blocks and one row 0."""
    rng = np.random.default_rng(seed)
    blocks = slots * mb
    cfg = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                        num_blocks=blocks, block_size=bs, dtype=dtype,
                        **PAGED_POOLS[mode])
    layer = {k: v[0] for k, v in init_kv_cache(cfg, dev).items()}
    tables = torch.from_numpy(rng.permutation(blocks).reshape(slots, mb)
                              .astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.arange(mb * bs, device=dev).repeat(slots)
    k = torch.randn(heads, blocks * bs, hd, device=dev, generator=gen) * 2
    v = torch.randn(heads, blocks * bs, hd, device=dev, generator=gen)
    paged_write(layer, cfg, k.to(dtype), v.to(dtype),
                tables.repeat_interleave(mb * bs, dim=0), pos,
                torch.ones_like(pos, dtype=torch.bool))
    n = slots * g
    q = torch.randn(n, heads, hd, device=dev, generator=gen).to(dtype)
    ctx = rng.integers(0, mb * bs + 8, n)
    ctx[0] = 0
    ctx[-g:] = mb * bs + 3
    return (q, layer, cfg, tables.repeat_interleave(g, dim=0),
            torch.from_numpy(ctx.astype(np.int32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mode", list(PAGED_POOLS))
@pytest.mark.parametrize("hd", [8, 40, 80, 96, 136, 256])
@pytest.mark.parametrize("g", [1, 5, 32])
def test_paged_routes_match_plain(dev, dtype, mode, hd, g):
    """Each route against the plain version: fp32 at 2e-5; bf16 at atol
    1e-3 (fp pools) and 1e-2 (quantized pools, as the quantized test
    above), rtol one bf16 rounding."""
    q, layer, cfg, bt, ctx = _paged_groups(dev, dtype, mode, 3, g, hd,
                                           seed=hd + g)
    entry = _paged_route(dtype, hd)
    before = ku.launch_counts().get(entry, 0)
    got = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=g)
    assert ku.launch_counts()[entry] == before + 1
    want = paged_attention_reference(q, layer, cfg, bt, ctx)
    torch.cuda.synchronize()
    atol = 2e-5 if dtype == torch.float32 else \
        1e-3 if mode == "none" else 1e-2     # bf16 and fp16: the bf16 gate
    rtol = 2e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[0].float().abs().max()        # ctx == 0 -> zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("hd", [64, 80])
def test_paged_rows_bitwise_whatever_their_group(dev, dtype, mode, hd):
    """The same rows launched as groups of 32 (a prefill chunk), of 5 (a
    verify call; the first 30 rows of each slot) and of 1 (decode rows,
    all slots' rows in one launch) give identical bits, and a launch
    repeats bitwise."""
    q, layer, cfg, bt, ctx = _paged_groups(dev, dtype, mode, 3, 32, hd,
                                           seed=hd)
    g32 = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=32)
    g1 = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=1)
    keep = (torch.arange(q.shape[0], device=dev) % 32) < 30
    g5 = paged_attention(q[keep].contiguous(), layer, cfg, bt[keep],
                         ctx[keep], rows_per_table=5)
    again = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=32)
    torch.cuda.synchronize()
    assert torch.equal(g32, g1)
    assert torch.equal(g32[keep], g5)
    assert torch.equal(g32, again)


def _fused_case(dev, dtype, mode, n, q, hidden=256, heads=4, seed=0):
    """One GPT layer (biases and LN weights perturbed), a pool whose
    slots already hold random context, and fed rows: slot 0 inactive, the
    last slot's rows running past its blocks, n_fed varying."""
    cfg = GPTConfig(vocab_size=128, max_seq=256, hidden=hidden,
                    num_layers=1, num_heads=heads, dtype=dtype)
    params = init_gpt_params(cfg, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = {}
    for name, t in params["layers"].items():
        t = t[0].float()
        if t.dim() == 1:
            t = t + 0.1 * torch.randn(t.shape, device=dev, generator=g)
        lp[name] = t.to(dtype).contiguous()
    hd, bs, mb = hidden // heads, 16, 8
    kv = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                       num_blocks=n * mb, block_size=bs, dtype=dtype,
                       **QUANT.get(mode, {}))
    layer = {k: v[0] for k, v in init_kv_cache(kv, dev).items()}
    rng = np.random.default_rng(seed)
    bt = torch.from_numpy(rng.permutation(n * mb).reshape(n, mb)
                          .astype(np.int32)).to(dev)
    start = rng.integers(0, 100, n)
    start[-1] = mb * bs - 2
    pos = torch.arange(mb * bs, device=dev).repeat(n)
    old = pos < torch.from_numpy(start).to(dev).repeat_interleave(mb * bs)
    kk = torch.randn(heads, n * mb * bs, hd, device=dev, generator=g)
    vv = torch.randn(heads, n * mb * bs, hd, device=dev, generator=g)
    paged_write(layer, kv, kk.to(dtype), vv.to(dtype),
                bt.repeat_interleave(mb * bs, dim=0), pos, old)
    n_fed = torch.from_numpy(rng.integers(1, q + 1, n).astype(np.int32))
    active = torch.ones(n, dtype=torch.bool)
    active[0] = n == 1
    x = torch.randn(n, q, hidden, device=dev, generator=g).to(dtype)
    return (x, lp, layer, cfg, kv, bt,
            torch.from_numpy(start.astype(np.int32)).to(dev),
            n_fed.to(dev), active.to(dev))


def _clone(layer):
    return {k: v.clone() for k, v in layer.items()}


# x' of the fused layer against its plain version: fp32 sums in another
# order (fp pools); with quantized pools a fed row's code may flip where
# the two fp32 K values straddle a rounding midpoint, moving a score by
# one code step; bf16 one output rounding plus flips of bf16 intermediates
MK_TOL = {(torch.float32, False): (1e-4, 1e-4),
          (torch.float32, True): (2e-3, 1e-3),
          (torch.bfloat16, False): (2e-2, 2 ** -6),
          (torch.bfloat16, True): (2e-2, 2 ** -6),
          # fp16 held to the bf16 gate
          (torch.float16, False): (2e-2, 2 ** -6),
          (torch.float16, True): (2e-2, 2 ** -6)}


# (hidden, heads) of the fused layer's head dims: the walks' buckets 64
# (32 and 64), 128 (80) and the wide walk (320)
MK_WIDTHS = {32: (128, 4), 64: (256, 4), 80: (320, 4), 320: (640, 2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("n,q", [(8, 1), (8, 5), (3, 3), (32, 5)])
@pytest.mark.parametrize("hd", sorted(MK_WIDTHS))
def test_megakernel_matches_plain(dev, dtype, mode, n, q, hd):
    """The fused layer against its plain version at head dims 32, 64, 80
    and 320 and up to 160 rows: x', K and V within tolerance; the pool it
    wrote equal to the plain codec's write of its own K/V (codes and
    scales bitwise) or within tolerance (fp pools); two launches bitwise
    equal."""
    hidden, heads = MK_WIDTHS[hd]
    x, lp, layer, cfg, kv, bt, start, n_fed, active = _fused_case(
        dev, dtype, mode, n, q, hidden=hidden, heads=heads)
    nv = None if q == 1 else n_fed
    got_pool = _clone(layer)
    before = ku.launch_counts().get("megakernel", 0)
    got = fused_layer_fwd(x, lp, got_pool, cfg, kv, bt, start, nv, active)
    assert ku.launch_counts()["megakernel"] == before + 1
    want_pool = _clone(layer)
    want = fused_layer_reference(x, lp, want_pool, cfg, kv, bt, start, nv,
                                 active)
    torch.cuda.synchronize()
    atol, rtol = MK_TOL[(dtype, mode != "none")]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    kv_tol = TOL[dtype] if dtype == torch.float32 else (1e-2, 2 ** -7)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.float(), b.float(), atol=kv_tol[0],
                                   rtol=kv_tol[1])
    if mode == "none":
        for name in layer:   # the plain version also fills the trash block
            torch.testing.assert_close(got_pool[name][:, :-1].float(),
                                       want_pool[name][:, :-1].float(),
                                       atol=kv_tol[0], rtol=kv_tol[1])
    else:
        # the plain codec on the kernel's own K/V: the same pool, bitwise
        codec_pool = _clone(layer)
        offs = torch.arange(q, device=dev)
        pos = (start.long()[:, None] + offs).reshape(-1)
        valid = active[:, None] & (offs[None, :] < (
            n_fed[:, None] if nv is not None else q))
        heads, hd = kv.num_heads, kv.head_dim
        paged_write(codec_pool, kv,
                    got[1].reshape(n * q, heads, hd).transpose(0, 1),
                    got[2].reshape(n * q, heads, hd).transpose(0, 1),
                    bt.repeat_interleave(q, dim=0), pos, valid.reshape(-1))
        for name in layer:
            # the trash block (last) is written by paged_write only
            assert torch.equal(got_pool[name][:, :-1],
                               codec_pool[name][:, :-1]), name
    again_pool = _clone(layer)
    again = fused_layer_fwd(x, lp, again_pool, cfg, kv, bt, start, nv,
                            active)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for name in layer:
        assert torch.equal(got_pool[name], again_pool[name]), name


@pytest.mark.parametrize("mode", ["none", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd", [64, 80, 320])
@pytest.mark.parametrize("n", [8, 32])
def test_megakernel_rows_do_not_depend_on_the_batch(dev, mode, dtype, hd, n):
    """Each slot launched alone gives the bits it gets among n (n = 32:
    160 rows, whose row chunks of 64 (8-64 at wide K) put slots 12 and 25
    across a chunk boundary), and a q=1 launch (decode) the bits of the
    same row in a q=5 launch whose other rows are padding (verify)."""
    hidden, heads = MK_WIDTHS[hd]
    x, lp, layer, cfg, kv, bt, start, n_fed, active = _fused_case(
        dev, dtype, mode, n, 5, hidden=hidden, heads=heads, seed=3)
    full_pool = _clone(layer)
    full = fused_layer_fwd(x, lp, full_pool, cfg, kv, bt, start, n_fed,
                           active)
    for i in ((1, 2, 3, 4, 5, 6, 7) if n == 8 else (1, 12, 25, 31)):
        alone_pool = _clone(layer)
        alone = fused_layer_fwd(x[i:i + 1], lp, alone_pool, cfg, kv,
                                bt[i:i + 1], start[i:i + 1],
                                n_fed[i:i + 1], active[i:i + 1])
        for a, b in zip(full, alone):
            assert torch.equal(a[i:i + 1], b)
    one_pool = _clone(layer)
    one = fused_layer_fwd(x[:, :1].contiguous(), lp, one_pool, cfg, kv, bt,
                          start, None, active)
    ones = torch.ones_like(n_fed)
    five_pool = _clone(layer)
    five = fused_layer_fwd(x, lp, five_pool, cfg, kv, bt, start, ones,
                           active)
    for a, b in zip(one, five):
        assert torch.equal(a[:, 0], b[:, 0])
    for name in layer:
        assert torch.equal(one_pool[name], five_pool[name]), name


def test_megakernel_refuses_what_it_cannot_take(dev):
    x, lp, layer, cfg, kv, bt, start, n_fed, active = _fused_case(
        dev, torch.float32, "none", 2, 1)
    with pytest.raises(ValueError, match="shared memory"):
        wide = GPTConfig(vocab_size=128, max_seq=256, hidden=8192,
                         num_layers=1, num_heads=64, dtype=torch.float32)
        kvw = KVCacheConfig(num_layers=1, num_heads=64, head_dim=128,
                            num_blocks=16, block_size=16,
                            dtype=torch.float32)
        fused_layer_fwd(x, lp, layer, wide, kvw, bt, start, None, active)
    with pytest.raises(ValueError, match="qkv_kernel"):
        fused_layer_fwd(x, {**lp, "qkv_kernel": lp["qkv_kernel"].t()},
                        layer, cfg, kv, bt, start, None, active)
    with pytest.raises(ValueError, match="pool"):
        fused_layer_fwd(x, lp, {k: v.bfloat16() for k, v in layer.items()},
                        cfg, kv, bt, start, None, active)
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        fused_layer_fwd(x.half(), lp, layer,
                        GPTConfig(vocab_size=128, max_seq=256, hidden=256,
                                  num_layers=1, num_heads=4,
                                  dtype=torch.float16),
                        KVCacheConfig(num_layers=1, num_heads=4,
                                      head_dim=64, num_blocks=16,
                                      block_size=16, dtype=torch.float32),
                        bt, start, None, active)


def test_megakernel_smem_mirror_matches_the_kernel(dev):
    """The shared memory the gate counts (kernel_smem_bytes) equals what
    the kernel's C entry reports, over head dims, the three types and
    every pool format; the budget equals SMEM_LIMIT_BYTES."""
    lib = ku.load_kernel("megakernel", mk._SIGNATURES)
    assert lib.fused_layer_smem_budget() == mk.SMEM_LIMIT_BYTES
    for d in (8, 40, 64, 80, 128, 136, 256, 264, 320, 1024):
        for heads in (1, 12):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                for mode, group in ((0, d), (1, d), (2, d), (2, 8)):
                    h = heads * d
                    got = lib.fused_layer_smem_bytes(
                        h, d, 4 * h, mode, group, ku.dtype_code(dt))
                    assert got == mk.kernel_smem_bytes(h, d, 4 * h, dt, mode,
                                                       group), (d, heads, dt,
                                                                mode, group)


# ---------------------------------------------------------------------------
# packed varlen attention (B #9-11) and contrib.fmha


def _varlen_case(dev, dtype, b, h, s, d, seed, foreign_tile=False):
    """Packed rows of documents of 20-150 tokens with a pad tail of 70 (at
    s = 320 the last tile is all padding). With ``foreign_tile`` the keys
    of tile 2 carry a segment id no query has: a K/V tile no q meets."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(b):
        row, doc = [], 0
        while len(row) < s - 70:
            row += [doc] * min(int(rng.integers(20, 151)), s - 70 - len(row))
            doc += 1
        rows.append(row + [-1] * (s - len(row)))
    seg_q = torch.tensor(rows, dtype=torch.int32, device=dev)
    seg_k = seg_q.clone()
    if foreign_tile:
        seg_k[:, 128:192] = 999
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=g).to(dtype)
                   for _ in range(4))
    return q, k, v, do, seg_q, seg_k


VARLEN_CASES = [  # b, h, s, d, causal, foreign K/V tile
    (2, 3, 320, 64, True, False), (2, 3, 320, 64, False, True),
    (1, 2, 320, 40, True, True), (1, 2, 256, 128, False, False),
    (1, 2, 320, 256, True, True), (1, 2, 256, 192, False, False),
    # D = 1024 and 2048: a quarter and an eighth of a 64-row table entry a
    # tile; above 2048 the wide kernels (8-row tiles, 2048-column chunks)
    (1, 1, 320, 1024, True, True), (1, 1, 256, 2048, False, False),
    (1, 1, 256, 2056, True, True), (1, 1, 192, 4096, False, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,foreign", VARLEN_CASES)
def test_varlen_kernels_match_plain(dev, dtype, b, h, s, d, causal, foreign):
    """o, lse, dq, dk, dv of the three varlen kernels vs their plain
    versions at the same inputs (fp32 atol/rtol 1e-4, bf16 atol 1e-2 +
    rtol 2**-7, as flash); pad rows, an all-padding tile and a K/V tile no
    query meets give exact zeros (lse NEG_INF on pad rows). The kernels
    run on their route (bf16 up to head_dim 256: ``flash_varlen_mma_*``,
    and then none of the CUDA-core kernels)."""
    from apex_tpu_torch.ops.attention_varlen import (
        NEG_INF, _varlen_route, flash_varlen_bwd_dkv,
        flash_varlen_bwd_dq, flash_varlen_bwd_reference, flash_varlen_fwd,
        flash_varlen_fwd_reference)
    q, k, v, do, seg_q, seg_k = _varlen_case(dev, dtype, b, h, s, d,
                                             s * d + b, foreign)
    args = (1 / math.sqrt(d), causal)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2 ** -7)
    counts = ku.launch_counts()
    o, lse = flash_varlen_fwd(q, k, v, seg_q, seg_k, *args)
    o_p, lse_p = flash_varlen_fwd_reference(q, k, v, seg_q, seg_k, *args)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = flash_varlen_bwd_dq(q, k, v, seg_q, seg_k, do, lse, delta, *args)
    dk, dv = flash_varlen_bwd_dkv(q, k, v, seg_q, seg_k, do, lse, delta,
                                  *args)
    want = flash_varlen_bwd_reference(q, k, v, seg_q, seg_k, o, lse, do,
                                      *args)
    torch.cuda.synchronize()
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=name)
    pad_q = (seg_q < 0)[:, None, :]
    assert not bool(o[pad_q.expand(-1, h, -1)].any())
    assert not bool(dq[pad_q.expand(-1, h, -1)].any())
    assert bool((lse[..., 0][pad_q.expand(-1, h, -1)] == NEG_INF).all())
    no_q = ~torch.isin(seg_k, seg_q[seg_q >= 0])[:, None, :]
    for t in (dk, dv):
        assert not bool(t[no_q.expand(-1, h, -1)].any())
    after = ku.launch_counts()
    mma = _varlen_route(dtype, d) == "tensor_core"
    for kernel in ("fwd", "bwd_dq", "bwd_dkv"):
        for routed in (True, False):
            name = f"flash_varlen_{'mma_' if mma == routed else ''}{kernel}"
            assert after.get(name, 0) == counts.get(name, 0) + routed, name


def _packed_case(dev, heads, total, d, seed):
    """One packed row of ``total`` tokens: documents of 64-1024 tokens
    from numpy ``seed`` until the next would overflow, then padding (-1);
    bf16 q, k, v, dO."""
    rng = np.random.default_rng(seed)
    row = []
    while True:
        n = int(rng.integers(64, 1025))
        if len(row) + n > total:
            break
        row += [len(set(row))] * n
    seg = torch.tensor([row + [-1] * (total - len(row))], dtype=torch.int32,
                       device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(1, heads, total, d, device=dev,
                               generator=g).bfloat16() for _ in range(4))
    return q, k, v, do, seg


# the tensor-core dK/dV: packed causal and bidirectional rows at GPT-2's
# head width, head_dim 256, and 40 (zeros past d in the D = 64 tile)
VARLEN_MMA_CASES = [(4, 2048, 64, True), (4, 2048, 64, False),
                    (2, 1024, 256, True), (2, 1024, 40, False)]


@pytest.mark.parametrize("heads,total,d,causal", VARLEN_MMA_CASES)
def test_varlen_mma_dkv_matches_plain_and_repeats_bitwise(dev, heads, total,
                                                          d, causal):
    """The tensor-core varlen dK/dV (bf16) vs its plain version, flash's
    bf16 tolerance (atol 1e-2 + rtol 2**-7); pad keys get exactly 0; one
    launch of ``flash_varlen_mma_bwd_dkv``, none of the CUDA-core dK/dV;
    the same bits on every launch, with the tables built in the call or
    given, in the block order or in tile order; tables without the block
    order are refused."""
    from apex_tpu_torch.ops.attention_varlen import (
        _tables, flash_varlen_bwd_dkv, flash_varlen_bwd_reference,
        flash_varlen_fwd)
    q, k, v, do, seg = _packed_case(dev, heads, total, d, total + d)
    args = (1 / math.sqrt(d), causal)
    o, lse = flash_varlen_fwd(q, k, v, seg, seg, *args)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    before = ku.launch_counts()
    dk, dv = flash_varlen_bwd_dkv(q, k, v, seg, seg, do, lse, delta, *args)
    after = ku.launch_counts()
    assert after["flash_varlen_mma_bwd_dkv"] == \
        before.get("flash_varlen_mma_bwd_dkv", 0) + 1
    assert after.get("flash_varlen_bwd_dkv", 0) == \
        before.get("flash_varlen_bwd_dkv", 0)
    want = flash_varlen_bwd_reference(q, k, v, seg, seg, o, lse, do, *args)
    torch.cuda.synchronize()
    for got, ref, name in zip((dk, dv), want[1:], ("dk", "dv")):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7, msg=name)
        assert not bool(got[0][:, seg[0] < 0].any()), name
    qr, kr, order, q_order = _tables(seg, seg, causal, True)
    tile_order = torch.arange(order.shape[1], dtype=torch.int32,
                              device=dev)[None].contiguous()
    for tables in (None, (qr, kr, order, q_order),
                   (qr, kr, tile_order, q_order)):
        dk2, dv2 = flash_varlen_bwd_dkv(q, k, v, seg, seg, do, lse, delta,
                                        *args, tables=tables)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    with pytest.raises(ValueError, match="block order"):
        flash_varlen_bwd_dkv(q, k, v, seg, seg, do, lse, delta, *args,
                             tables=(qr, kr, None, q_order))


def _case_a(dev, heads, d, seed):
    """One packed row of 320 tokens: document 0 (100 tokens) ends inside
    q tile 1 and document 1 (70) starts there, so tile 1's first live K/V
    tile (tile 0) allows nothing for document 1's rows; document 2 (80)
    ends mid-tile; a pad tail of 70 leaves tile 4 all padding (an empty
    live range). bf16 q, k, v, dO."""
    seg = torch.tensor([[0] * 100 + [1] * 70 + [2] * 80 + [-1] * 70],
                       dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(1, heads, 320, d, device=dev,
                               generator=g).bfloat16() for _ in range(4))
    return q, k, v, do, seg


# the tensor-core forward and dQ: the dK/dV's packed rows, case (a) at
# head_dims 40-256 (d < D zero-filled in the tiles), causal and not
VARLEN_MMA_FWD_CASES = (
    [("packed", *c) for c in VARLEN_MMA_CASES]
    + [("case_a", 2, 320, d, causal) for d in (40, 64, 128, 200, 256)
       for causal in (False, True)])


@pytest.mark.parametrize("kind,heads,total,d,causal", VARLEN_MMA_FWD_CASES)
def test_varlen_mma_fwd_dq_match_plain_and_repeat_bitwise(dev, kind, heads,
                                                          total, d, causal):
    """The tensor-core varlen forward and dQ (bf16) vs their plain
    versions: o and dq within flash's bf16 tolerance (atol 1e-2 + rtol
    2**-7), lse within 1e-4 / 1e-5; pad rows' o and dq exactly 0 and their
    lse NEG_INF; one launch each of ``flash_varlen_mma_fwd`` and
    ``flash_varlen_mma_bwd_dq``, none of the CUDA-core forward and dQ; the
    same bits on every launch, with the tables built in the call or
    given, in the block order or in tile order."""
    from apex_tpu_torch.ops.attention_varlen import (
        NEG_INF, _tables, flash_varlen_bwd_dq, flash_varlen_bwd_reference,
        flash_varlen_fwd, flash_varlen_fwd_reference)
    if kind == "packed":
        q, k, v, do, seg = _packed_case(dev, heads, total, d, 7 * total + d)
    else:
        q, k, v, do, seg = _case_a(dev, heads, d, d)
    args = (1 / math.sqrt(d), causal)
    before = ku.launch_counts()
    o, lse = flash_varlen_fwd(q, k, v, seg, seg, *args)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = flash_varlen_bwd_dq(q, k, v, seg, seg, do, lse, delta, *args)
    after = ku.launch_counts()
    for name, n in (("flash_varlen_mma_fwd", 1), ("flash_varlen_fwd", 0),
                    ("flash_varlen_mma_bwd_dq", 1),
                    ("flash_varlen_bwd_dq", 0)):
        assert after.get(name, 0) == before.get(name, 0) + n, name
    o_p, lse_p = flash_varlen_fwd_reference(q, k, v, seg, seg, *args)
    want = flash_varlen_bwd_reference(q, k, v, seg, seg, o, lse, do, *args)
    torch.cuda.synchronize()
    assert o.dtype == dq.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), o_p.float(), atol=1e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(dq.float(), want[0].float(), atol=1e-2,
                               rtol=2 ** -7)
    pad = seg[0] < 0
    assert not bool(o[0][:, pad].any()) and not bool(dq[0][:, pad].any())
    assert bool((lse[0][:, pad] == NEG_INF).all())
    qr, kr, order, q_order = _tables(seg, seg, causal, True)
    tile_order = torch.arange(q_order.shape[1], dtype=torch.int32,
                              device=dev)[None].contiguous()
    for tables in (None, (qr, kr, order, q_order),
                   (qr, kr, order, tile_order)):
        o2, lse2 = flash_varlen_fwd(q, k, v, seg, seg, *args, tables=tables)
        dq2 = flash_varlen_bwd_dq(q, k, v, seg, seg, do, lse, delta, *args,
                                  tables=tables)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert torch.equal(dq, dq2)
    with pytest.raises(ValueError, match="block order"):
        flash_varlen_fwd(q, k, v, seg, seg, *args,
                         tables=(qr, kr, order, None))


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_mma_dkv_misaligned_front_door(dev, causal):
    """``flash_attention_varlen`` on bf16 at a total that is not a
    multiple of the 64-row tile (1000 tokens, 4 heads of 64): one launch
    of each tensor-core kernel per forward plus backward (none of the
    CUDA-core ones), k and v gradients
    within the bf16 tolerance of the plain versions forced, pad keys 0."""
    from apex_tpu_torch.ops.attention_varlen import flash_attention_varlen
    q, k, v, do, seg = _packed_case(dev, 4, 1000, 64, 5)
    runs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = ku.launch_counts()
        with ku.force_plain() if plain else contextlib.nullcontext():
            o = flash_attention_varlen(*leaves, seg, causal=causal)
            o.backward(do)
        after = ku.launch_counts()
        for kernel in ("fwd", "bwd_dq", "bwd_dkv"):
            mma, core = f"flash_varlen_mma_{kernel}", f"flash_varlen_{kernel}"
            assert after.get(mma, 0) - before.get(mma, 0) == (not plain)
            assert after.get(core, 0) == before.get(core, 0)
        assert leaves[1].grad.shape == (1, 4, 1000, 64)
        runs.append([t.grad for t in leaves[1:]])
    for got, ref in zip(*runs):
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7)
        assert not bool(got[0][:, seg[0] < 0].any())


@pytest.mark.parametrize("causal", [False, True])
def test_fmha_packed_autograd_on_the_card(dev, causal):
    """``fmha_packed`` on CUDA: one launch of each varlen kernel per
    forward plus backward, the plain versions' output and qkv gradient
    (fp32 atol 1e-4) at a misaligned total (1000 tokens, 40 of padding),
    pad rows exactly 0, and the same bits on a second run."""
    from apex_tpu_torch.contrib.fmha import fmha_packed
    g = torch.Generator(device=dev).manual_seed(21)
    qkv = torch.randn(1000, 3, 4, 64, device=dev, generator=g)
    do = torch.randn(1000, 4, 64, device=dev, generator=g)
    cu = torch.tensor([0, 130, 400, 777, 960], device=dev)
    runs = []
    for plain in (False, True, False):
        x = qkv.clone().requires_grad_()
        before = ku.launch_counts()
        with ku.force_plain() if plain else contextlib.nullcontext():
            o = fmha_packed(x, cu, causal=causal)
            o.backward(do)
        after = ku.launch_counts()
        for name in ("flash_varlen_fwd", "flash_varlen_bwd_dq",
                     "flash_varlen_bwd_dkv"):
            assert after.get(name, 0) == before.get(name, 0) + (not plain)
        assert not bool(o[960:].any()) and not bool(x.grad[960:].any())
        runs.append((o, x.grad))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(runs[0][1], runs[1][1], atol=1e-4, rtol=1e-4)
    assert torch.equal(runs[0][0], runs[2][0])
    assert torch.equal(runs[0][1], runs[2][1])


def test_varlen_kernels_refuse_what_they_cannot_take(dev):
    from apex_tpu_torch.ops.attention_varlen import flash_varlen_fwd
    q, k, v, do, seg_q, seg_k = _varlen_case(dev, torch.float32, 1, 2, 256,
                                             64, 3)
    flash_varlen_fwd(q, k, v, seg_q, seg_k, 0.125, True)
    with pytest.raises(ValueError, match="multiples of 64"):
        flash_varlen_fwd(*(t[:, :, :200].contiguous() for t in (q, k, v)),
                         seg_q[:, :200].contiguous(),
                         seg_k[:, :200].contiguous(), 0.125, True)
    with pytest.raises(ValueError, match="seg_q"):
        flash_varlen_fwd(q, k, v, seg_q.long(), seg_k, 0.125, True)
    wide = torch.randn(1, 2, 256, 2056, device=dev)
    flash_varlen_fwd(wide, wide, wide, seg_q, seg_k, 0.125, True)  # wide
    with pytest.raises(ValueError, match="head_dim 36 must be a positive"):
        flash_varlen_fwd(*(t[..., :36].contiguous() for t in (q, k, v)),
                         seg_q, seg_k, 0.125, True)
    with pytest.raises(ValueError, match="k must be"):
        flash_varlen_fwd(q, k.bfloat16(), v, seg_q, seg_k, 0.125, True)


def test_flash_attention_head_dim_above_256_raises_on_the_card(dev):
    """head_dim 264, 520, 2048, 2056 and 4096 run (the CUDA-core kernels'
    D = 512, 1024 and 2048: 32-, 16- and 8-row tiles; above it the wide
    kernels): every d % 8 == 0 that JAX's gate takes, one launch of each
    kernel, nothing raises; head_dim 36 takes the plain reference, as JAX
    sends it there, and launches nothing."""
    for d in (264, 520, 2048, 2056, 4096):
        q = torch.randn(1, 2, 64, d, device=dev, requires_grad=True)
        before = ku.launch_counts()
        flash_attention(q, q, q, causal=True).sum().backward()
        after = ku.launch_counts()
        for name in _flash_names(torch.float32, d):
            assert after[name] == before.get(name, 0) + 1
    q = torch.randn(1, 2, 64, 36, device=dev)
    before = ku.launch_counts()
    flash_attention(q, q, q, causal=True)
    assert ku.launch_counts() == before


# ---------------------------------------------------------------------------
# seventh slice: LayerNorm in mixed types and wide rows, RMSNorm, the codec

NORM_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


def _norm_case(dev, xt, wt, rows, hidden, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2 + 1).to(xt)
    w = (1 + 0.1 * torch.randn(hidden, device=dev, generator=g)).to(wt)
    b = (0.1 * torch.randn(hidden, device=dev, generator=g)).to(wt)
    dy = torch.randn(rows, hidden, device=dev, generator=g).to(xt)
    return x, w, b, dy


def _close_norm(got, want, dtype, sum_rows=None):
    """y and dx: the file's tolerance; a sum over rows (dw, db): atol
    1e-5·sqrt(rows) in fp32, 2e-3·sqrt(rows) in bf16."""
    atol, rtol = TOL[dtype]
    if sum_rows is not None:
        atol = (1e-5 if dtype == torch.float32 else 2e-3) * math.sqrt(
            sum_rows)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("xt,wt", NORM_TYPES)
@pytest.mark.parametrize("rows,hidden", [(64, 768), (37, 512), (16, 12288)])
def test_layer_norm_mixed_types_match_plain(dev, xt, wt, rows, hidden):
    """x and the weight in their own types: y and dx in x's, dw/db in the
    weight's, each within tolerance of the plain version (which computes
    in fp32 and rounds where the kernels do)."""
    x, w, b, dy = _norm_case(dev, xt, wt, rows, hidden, rows + hidden)
    y, mean, rstd = layer_norm_fwd(x, w, b, stats=True)
    y_p, mean_p, rstd_p = layer_norm_fwd_reference(x, w, b)
    _close_norm(y, y_p, xt)
    torch.testing.assert_close(rstd, rstd_p, atol=2e-5, rtol=2e-5)
    dx, dw, db = layer_norm_bwd(dy, x, mean, rstd, w)
    pdx, pdw, pdb = layer_norm_bwd_reference(dy, x, mean, rstd, w)
    _close_norm(dx, pdx, xt)
    _close_norm(dw, pdw, wt, rows)
    _close_norm(db, pdb, wt, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_bwd_wide_rows(dev, dtype):
    """hidden 12,288 (GPT-3's width) and 37,376 (the widest JAX's gate
    admits at 8-row blocks, a multiple of 128): the backward's shared
    memory no longer grows with hidden, so both run, match the plain
    version and repeat bitwise."""
    for rows, hidden in ((256, 12288), (16, 37376)):
        assert ln_mod._pallas_ok(rows, hidden)
        x, w, b, dy = _norm_case(dev, dtype, dtype, rows, hidden, hidden)
        _, mean, rstd = layer_norm_fwd(x, w, b, stats=True)
        got = layer_norm_bwd(dy, x, mean, rstd, w)
        want = layer_norm_bwd_reference(dy, x, mean, rstd, w)
        _close_norm(got[0], want[0], dtype)
        _close_norm(got[1], want[1], dtype, rows)
        _close_norm(got[2], want[2], dtype, rows)
        again = layer_norm_bwd(dy, x, mean, rstd, w)
        assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("xt,wt", NORM_TYPES)
@pytest.mark.parametrize("rows,hidden", [(8192, 768), (4096, 512),
                                         (37, 256), (64, 12288)])
def test_rms_norm_kernels_match_plain(dev, xt, wt, rows, hidden):
    """RMSNorm forward (y, rstd) and backward (dx, dw) vs their plain
    versions; one launch each; dw bitwise over a repeat."""
    x, w, _, dy = _norm_case(dev, xt, wt, rows, hidden, 3 * rows + hidden)
    counts = ku.launch_counts()
    y, rstd = rms_norm_fwd(x, w, stats=True)
    y_p, rstd_p = rms_norm_fwd_reference(x, w)
    _close_norm(y, y_p, xt)
    torch.testing.assert_close(rstd, rstd_p, atol=2e-5, rtol=2e-5)
    dx, dw = rms_norm_bwd(dy, x, rstd, w)
    pdx, pdw = rms_norm_bwd_reference(dy, x, rstd, w)
    _close_norm(dx, pdx, xt)
    _close_norm(dw, pdw, wt, rows)
    after = ku.launch_counts()
    for name in ("rms_norm_fwd", "rms_norm_bwd"):
        assert after[name] == counts.get(name, 0) + 1
    assert torch.equal(rms_norm_bwd(dy, x, rstd, w)[1], dw)


@pytest.mark.parametrize("module", ["FusedRMSNorm", "MixedFusedRMSNorm",
                                    "FusedLayerNorm", "MixedFusedLayerNorm"])
def test_normalization_modules_on_the_card(dev, module):
    """A bf16 batch through each module (fp32 params): one forward and one
    backward kernel launch, output and gradients within tolerance of the
    same module run with the plain versions forced."""
    import apex_tpu_torch.normalization as norm
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(4, 64, 768, device=dev, generator=g).bfloat16()
    dy = torch.randn(4, 64, 768, device=dev, generator=g).bfloat16()
    rms = "RMS" in module
    names = ("rms_norm_fwd", "rms_norm_bwd") if rms else (
        "layer_norm_fwd", "layer_norm_bwd")
    w0 = 1 + 0.1 * torch.randn(768, device=dev, generator=g)
    runs = []
    for plain in (False, True):
        mod = getattr(norm, module)(768, device=dev)
        with torch.no_grad():
            mod.weight.copy_(w0)
        xl = x.clone().requires_grad_()
        before = ku.launch_counts()
        with ku.force_plain() if plain else contextlib.nullcontext():
            y = mod(xl)
            y.backward(dy)
        after = ku.launch_counts()
        for name in names:
            assert after.get(name, 0) == before.get(name, 0) + (not plain)
        assert y.dtype == torch.bfloat16 and mod.weight.grad.dtype == \
            torch.float32
        runs.append((y, xl.grad, mod.weight.grad))
    for got, want, dtype in zip(runs[0], runs[1], (torch.bfloat16,) * 2
                                + (torch.float32,)):
        _close_norm(got, want, dtype, 256 if got.dim() == 1 else None)


def test_rms_norm_gate_on_the_card(dev):
    """Outside JAX's gate (rows % 8, hidden % 128) rms_norm is the
    reference on CUDA, no launch; use_pallas=True there raises; no weight
    is the reference everywhere."""
    before = ku.launch_counts()
    x = torch.randn(5, 100, device=dev)
    w = torch.ones(100, device=dev)
    assert torch.equal(rms_norm(x, w), rms_norm_reference(x, w))
    x8 = torch.randn(8, 256, device=dev)
    assert torch.equal(rms_norm(x8), rms_norm_reference(x8))
    assert ku.launch_counts() == before
    with pytest.raises(ValueError, match="pallas rms_norm requires"):
        rms_norm(x, w, use_pallas=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bits,block", [(8, 128), (8, 256), (8, 384),
                                        (8, 512), (8, 1024), (8, 1152),
                                        (8, 2048), (8, 8320), (4, 128),
                                        (4, 256), (4, 384), (4, 1024),
                                        (4, 4224), (4, 16512)])
@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("rows", [32, 97])
def test_codec_kernels_match_plain_bitwise(dev, dtype, bits, block, seed,
                                           rows):
    """Quantize (nearest, or stochastic with a seed) and dequantize: codes
    and scales bitwise the plain versions' (the IEEE quotient, rint, the
    same counter hash), int4 as nibbles written by the kernel (its plain
    version ``pack_int4`` of the codes) and read by the dequantize kernel
    (its plain version the reference on ``unpack_int4`` of the bytes), the
    dequantized values bitwise too, at blocks 128-1024 (384: no power of
    2, lanes of a team idle), 1152 (bf16: a chunk and a partial one),
    2048, 4224, 8320 and 16512 (rows walked in chunks of 128 vectors, read
    twice, past what one CTA's registers hold in both types), rows 32 and
    97 (3 · 32 + 1: a partial CTA of rows), both grids (bf16 stochastic:
    resident); one launch each through the public entry points (rows % 32
    == 0)."""
    from apex_tpu_torch.comm import quantize as pq
    g = torch.Generator(device=dev).manual_seed(block + bits)
    n = rows * block
    x = (torch.randn(n, device=dev, generator=g) * 3).to(dtype)
    x[:block] = 0                                   # an all-zero block
    x[block:2 * block] = 0.5 * torch.arange(block, device=dev) - 7
    qmax = pq.qmax_for_bits(bits)
    x2d = x.reshape(-1, block)
    q, s = pq.quantize_blocks(x2d, qmax, seed)
    q_p, s_p = pq.quantize_blocks_reference(x2d, qmax, seed)
    torch.cuda.synchronize()
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert int(q.abs().max()) <= qmax and float(s[0]) == 1.0
    if dtype == torch.float16:
        # upcast inside the kernel, exactly: the fp32 path's codes and
        # scales on the same values
        q32, s32 = pq.quantize_blocks(x2d.float(), qmax, seed)
        assert torch.equal(q, q32) and torch.equal(s, s32)
    y = pq.dequantize_blocks(q, s)
    assert torch.equal(y, pq.dequantize_blocks_reference(q, s))
    if bits == 4:
        packed, s4 = pq.quantize_blocks(x2d, qmax, seed, packed=True)
        assert packed.dtype == torch.uint8 and packed.shape == (rows,
                                                                block // 2)
        assert torch.equal(packed, pq.pack_int4(q_p)) and torch.equal(s4, s)
        assert torch.equal(packed, pq.quantize_blocks_reference(
            x2d, qmax, seed, packed=True)[0])
        y4 = pq.dequantize_blocks(packed, s, packed=True)
        assert torch.equal(y4, pq.dequantize_blocks_reference(
            pq.unpack_int4(packed), s))
        assert torch.equal(y4, y)
    if rows % 32:
        return
    stoch = seed is not None
    kind = "stochastic" if stoch else "nearest"
    before = ku.launch_counts()
    if bits == 8:
        codes, scales = pq.quantize_blockwise(x, block, stoch, seed)
        back = pq.dequantize_blockwise(codes, scales, block)
    else:
        codes, scales = pq.quantize_blockwise_int4(x, block, stoch, seed)
        assert torch.equal(codes, pq.pack_int4(q.reshape(-1)))
        back = pq.dequantize_blockwise_int4(codes, scales, block)
    after = ku.launch_counts()
    assert after[f"quantize_blockwise[{kind}]"] == \
        before.get(f"quantize_blockwise[{kind}]", 0) + 1
    assert after["dequantize_blockwise"] == \
        before.get("dequantize_blockwise", 0) + 1
    assert torch.equal(scales, s) and torch.equal(back, y.reshape(-1))


def test_codec_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """The wrappers raise for a block that is odd or no multiple of 128, a
    misaligned pointer, a wrong type, packed codes at qmax 127; the C
    entries refuse such blocks, and a team that is no power of 2 up to 32,
    themselves (no launch, a nonzero status)."""
    from apex_tpu_torch.comm import quantize as pq
    for block in (129, 192, 100):
        with pytest.raises(ValueError, match="multiple of 128"):
            pq.quantize_blocks(torch.randn(32, block, device=dev),
                               pq.QMAX4, packed=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        pq.dequantize_blocks(torch.zeros(32, 50, dtype=torch.uint8,
                                         device=dev),
                             torch.ones(32, device=dev), packed=True)
    flat = torch.randn(32 * 128 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        pq.quantize_blocks(flat[1:].view(32, 128))
    codes = torch.zeros(32 * 128 + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        pq.dequantize_blocks(codes[1:].view(32, 128),
                             torch.ones(32, device=dev))
    with pytest.raises(ValueError, match="torch.float32 or torch.bfloat16 "
                                         "or torch.float16"):
        pq.quantize_blocks(torch.randn(32, 128, device=dev).double())
    with pytest.raises(ValueError, match="torch.uint8"):
        pq.dequantize_blocks(torch.zeros(32, 64, dtype=torch.int8,
                                         device=dev),
                             torch.ones(32, device=dev), packed=True)
    with pytest.raises(ValueError, match="torch.int8"):
        pq.dequantize_blocks(torch.zeros(32, 128, dtype=torch.uint8,
                                         device=dev),
                             torch.ones(32, device=dev))
    with pytest.raises(ValueError, match="qmax"):
        pq.quantize_blocks(torch.randn(32, 128, device=dev), pq.QMAX,
                           packed=True)
    lib = ku.load_kernel("quantize", pq._SIGNATURES)
    x = torch.randn(32 * 130, device=dev)
    q = torch.empty(32 * 130, dtype=torch.int8, device=dev)
    s = torch.empty(32, device=dev)
    stream = ku.stream_handle(x)
    for block, packed, qmax, plan in ((130, 1, 7.0, (32, 0)),
                                      (100, 0, 127.0, (32, 0)),
                                      (128, 1, 127.0, (32, 0)),
                                      (128, 0, 127.0, (24, 1)),
                                      (128, 0, 127.0, (64, 0)),
                                      (256, 0, 127.0, (0, 1))):
        rows = 32 * 128 // block
        assert lib.quantize_blockwise(dev.index or 0, x.data_ptr(),
                                      q.data_ptr(), s.data_ptr(), rows,
                                      block, qmax, 0, 0, 0, packed, *plan,
                                      stream) != 0
    for block in (100, 130):
        assert lib.dequantize_blockwise(dev.index or 0, q.data_ptr(),
                                        s.data_ptr(), x.data_ptr(),
                                        32 * block, block, 0, stream) != 0
    torch.cuda.synchronize()


def test_codec_gate_on_the_card(dev):
    """JAX's gate: block % 128 and rows % 32. Outside it the codec's
    reference (the scale a true quotient) runs on CUDA with no launch,
    the same bits as on the CPU; use_pallas=True raises there; False is
    the reference inside it; the KV pools' codec (block = head_dim 64)
    never launches."""
    from apex_tpu_torch.comm import quantize as pq
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(16 * 256, device=dev, generator=g)   # 16 rows: not 32
    before = ku.launch_counts()
    q, s = pq.quantize_blockwise(x)
    q_r, s_r = pq.quantize_blockwise(x.cpu(), use_pallas=False)
    assert torch.equal(q.cpu(), q_r) and torch.equal(s.cpu(), s_r)
    pq.quantize_blockwise(torch.randn(64 * 256, device=dev),
                          use_pallas=False)
    pq.quantize_blockwise(torch.randn(64 * 64, device=dev), 64)
    assert ku.launch_counts() == before
    with pytest.raises(ValueError, match="pallas quantize needs"):
        pq.quantize_blockwise(x, use_pallas=True)


# ---------------------------------------------------------------------------
# eighth slice: the tensor-core forward and dK/dV (bf16, d <= 256), and the
# CUDA-core kernels at head_dim 264-512 (D = 512)

MMA_CASES = [  # batch, heads, sq, sk, d, causal, dropout rate, bias
    (2, 3, 128, 128, 32, True, 0.0, False), (2, 3, 192, 192, 40, True, 0.1,
                                             True),
    (2, 3, 256, 256, 64, False, 0.0, True), (2, 2, 1000, 1000, 64, True,
                                             0.0, False),
    (2, 2, 200, 328, 64, False, 0.2, True), (2, 2, 136, 136, 128, True,
                                             0.1, False),
    (1, 2, 128, 512, 128, False, 0.0, False), (1, 2, 256, 256, 192, True,
                                               0.0, True),
    (1, 2, 200, 200, 256, False, 0.1, False), (1, 2, 72, 72, 256, True,
                                               0.0, True)]


@pytest.mark.parametrize("b,heads,sq,sk,d,causal,rate,bias", MMA_CASES)
def test_mma_kernels_match_plain_and_repeat_bitwise(dev, b, heads, sq, sk,
                                                    d, causal, rate, bias):
    """The tensor-core forward and dK/dV (bf16, the D = 32/64/128/256
    instantiations, d = 40 and 192 with zeros past d) vs their plain
    versions: o, dk, dv within atol 1e-2 + rtol 2**-7 (p and ds are
    rounded to bf16 before their products, at other running maxima), lse
    1e-4 / 1e-5; two launches give the same bits; each call launches its
    tensor-core entry once (and the ``[bias]`` count with a bias)."""
    q, k, v, do, bb = _flash_bias_case(dev, torch.bfloat16, b, heads, sq,
                                       sk, d, sq + sk + d)
    bb = bb if bias else None
    args = (1 / math.sqrt(d), causal, rate, 5)
    counts = ku.launch_counts()
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bb)
    o_p, lse_p = flash_attention_fwd_reference(q, k, v, *args, bias=bb)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args, bias=bb)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, *args,
                                         bias=bb)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_p.float(), atol=1e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    for got, ref, name in zip((dk, dv), want[1:], ("dk", "dv")):
        assert got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7, msg=name)
    after = ku.launch_counts()
    for name in ("flash_mma_fwd", "flash_mma_bwd_dkv"):
        assert after[name] == counts.get(name, 0) + 1
        assert after.get(f"{name}[bias]", 0) == \
            counts.get(f"{name}[bias]", 0) + bias
    o2, lse2 = flash_attention_fwd(q, k, v, *args, bias=bb)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args,
                                       bias=bb)
    for a, b2 in ((o, o2), (lse, lse2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b2)


@pytest.mark.parametrize("bias", [False, True])
def test_bf16_front_door_takes_the_tensor_cores(dev, bias):
    """``flash_attention`` on bf16 CUDA tensors at head_dim 64: one launch
    of the tensor-core forward, dQ and dK/dV (and d(bias) with a bias) per
    forward plus backward, none of the CUDA-core kernels; output and
    gradients within the bf16 tolerance of the plain versions forced."""
    q, k, v, do, bb = _flash_bias_case(dev, torch.bfloat16, 2, 3, 128, 128,
                                       64, 31)
    q, k, v, do = (t.reshape(2, 3, 128, 64) for t in (q, k, v, do))
    runs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        b_leaf = [bb.clone().requires_grad_()] if bias else []
        before = ku.launch_counts()
        with ku.force_plain() if plain else contextlib.nullcontext():
            o = flash_attention(*leaves, causal=True,
                                bias=b_leaf[0] if bias else None)
            o.backward(do)
        after = ku.launch_counts()
        want = {"flash_mma_fwd": 1, "flash_mma_bwd_dkv": 1,
                "flash_mma_bwd_dq": 1, "flash_mma_bwd_dbias": int(bias),
                "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0,
                "flash_attention_bwd_dbias": 0}
        for name, n in want.items():
            assert after.get(name, 0) - before.get(name, 0) == \
                (0 if plain else n), name
        runs.append([o] + [t.grad for t in leaves + b_leaf])
    for got, ref in zip(*runs):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2 ** -7)
    # the fused LM-head loss and packed varlen attention on bf16: the
    # tensor-core forward, dX and dW, and the tensor-core varlen dK/dV,
    # none of the CUDA-core entries
    from apex_tpu_torch.ops.attention_varlen import flash_attention_varlen
    x, w, t, _ = _lm_case(dev, torch.bfloat16, 256, 3000, 768, 3)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    seg = torch.tensor([[0] * 100 + [1] * 150 + [-1] * 6], device=dev,
                       dtype=torch.int32)
    qv = q.reshape(1, 6, 128, 64).repeat(1, 1, 2, 1)
    lv = [qv.clone().requires_grad_() for _ in range(3)]
    before = ku.launch_counts()
    lm_head_loss(xs, ws, t).mean().backward()
    flash_attention_varlen(*lv, seg, causal=True).float().sum().backward()
    after = ku.launch_counts()
    want = {"lm_head_mma_fwd": 1, "lm_head_mma_bwd_dx": 1,
            "lm_head_mma_bwd_dw": 1, "lm_head_loss_fwd": 0,
            "lm_head_loss_bwd_dx": 0, "lm_head_loss_bwd_dw": 0,
            "flash_varlen_mma_bwd_dkv": 1, "flash_varlen_bwd_dkv": 0}
    for name, n in want.items():
        assert after.get(name, 0) - before.get(name, 0) == n, name


@pytest.mark.parametrize("b,heads,sq,sk,d,causal,rate,bias", MMA_CASES)
def test_mma_dq_dbias_match_plain_and_repeat_bitwise(dev, b, heads, sq, sk,
                                                     d, causal, rate, bias):
    """The tensor-core dQ and d(bias) (bf16, D = 32/64/128/256, d = 40
    and 192 with zeros past d, tails, dropout) vs their plain versions:
    dq within atol 1e-2 + rtol 2**-7 (ds is rounded to bf16 before its
    product on both sides, from fp32 sums in other orders), d(bias) fp32
    within 1e-4 (the same fp32 products of the same bf16 inputs, the batch
    summed in another order) and zero above the causal diagonal; two
    launches of each give the same bits; each call launches its
    tensor-core entry once (dQ's ``[bias]`` count with a bias)."""
    q, k, v, do, bb = _flash_bias_case(dev, torch.bfloat16, b, heads, sq,
                                       sk, d, sq * sk + d)
    bb = bb if bias else None
    args = (1 / math.sqrt(d), causal, rate, 9)
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bb)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    counts = ku.launch_counts()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, *args, bias=bb)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, *args,
                                         bias=bb)[0]
    torch.cuda.synchronize()
    assert dq.dtype == torch.bfloat16
    torch.testing.assert_close(dq.float(), want.float(), atol=1e-2,
                               rtol=2 ** -7)
    assert torch.equal(dq, flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                  *args, bias=bb))
    after = ku.launch_counts()
    assert after["flash_mma_bwd_dq"] == counts.get("flash_mma_bwd_dq", 0) + 2
    assert after.get("flash_mma_bwd_dq[bias]", 0) == \
        counts.get("flash_mma_bwd_dq[bias]", 0) + 2 * bias
    if not bias:
        return
    db = flash_attention_bwd_dbias(q, k, v, do, lse, delta, *args, bias=bb)
    db_p = flash_attention_bwd_dbias_reference(q, k, v, o, lse, do, *args,
                                               bias=bb)
    torch.cuda.synchronize()
    assert db.dtype == torch.float32 and db.shape == bb.shape
    torch.testing.assert_close(db, db_p, atol=1e-4, rtol=1e-4)
    if causal:
        above = torch.ones(sq, sk, dtype=torch.bool, device=dev).triu(1)
        assert not bool(db[:, above].any())
    assert torch.equal(db, flash_attention_bwd_dbias(q, k, v, do, lse, delta,
                                                     *args, bias=bb))
    assert ku.launch_counts()["flash_mma_bwd_dbias"] == \
        counts.get("flash_mma_bwd_dbias", 0) + 2


@pytest.mark.parametrize("b,heads,s,d,causal,chunks", [
    (8, 8, 128, 64, True, 8), (3, 2, 200, 64, False, 3),
    (8, 8, 512, 64, False, 1), (5, 1, 136, 64, True, 5),
    # two batch items a chunk through the two-stage ring (D = 128) and the
    # one stage (D = 256)
    (4, 4, 512, 128, False, 2), (3, 4, 512, 256, True, 2)])
def test_mma_dbias_batch_chunks_match_plain(dev, b, heads, s, d, causal,
                                            chunks):
    """The tensor-core d(bias) over ``_dbias_chunks`` ordered chunks of the
    batch (T5's decoder: 8; its encoder: 1), their partials added in
    chunk order by the second launch: within 1e-4 of the plain d(bias),
    zero above the causal diagonal, bitwise over repeats."""
    assert port_attention._dbias_chunks(heads, s, s, b) == chunks
    q, k, v, do, bb = _flash_bias_case(dev, torch.bfloat16, b, heads, s, s,
                                       d, b * s + heads)
    args = (1 / math.sqrt(d), causal, 0.0, 0)
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bb)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    db = flash_attention_bwd_dbias(q, k, v, do, lse, delta, *args, bias=bb)
    db_p = flash_attention_bwd_dbias_reference(q, k, v, o, lse, do, *args,
                                               bias=bb)
    torch.cuda.synchronize()
    torch.testing.assert_close(db, db_p, atol=1e-4, rtol=1e-4)
    if causal:
        above = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
        assert not bool(db[:, above].any())
    for _ in range(2):
        assert torch.equal(db, flash_attention_bwd_dbias(
            q, k, v, do, lse, delta, *args, bias=bb))


D512_CASES = [  # batch, heads, sq, sk, d, causal, dropout rate, bias
    (1, 2, 128, 128, 512, True, 0.1, True), (1, 2, 72, 200, 320, False,
                                             0.0, True),
    (1, 2, 200, 200, 264, True, 0.0, False), (2, 2, 96, 96, 512, False,
                                              0.2, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,sq,sk,d,causal,rate,bias", D512_CASES)
def test_head_dims_264_to_512_match_plain(dev, dtype, b, heads, sq, sk, d,
                                          causal, rate, bias):
    """The CUDA-core kernels' D = 512 (32-row tiles), fp32 and bf16: o,
    lse, dq, dk, dv and d(bias) vs their plain versions with the flash
    tolerances (fp32 1e-4, bf16 1e-2 + 2**-7, d(bias) 1e-4), one launch
    each of the CUDA-core entries, and the causal d(bias) zero above the
    diagonal."""
    q, k, v, do, bb = _flash_bias_case(dev, dtype, b, heads, sq, sk, d,
                                       sq * d + b)
    bb = bb if bias else None
    args = (1 / math.sqrt(d), causal, rate, 17)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2 ** -7)
    counts = ku.launch_counts()
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bb)
    o_p, lse_p = flash_attention_fwd_reference(q, k, v, *args, bias=bb)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, *args, bias=bb)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args, bias=bb)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, *args,
                                         bias=bb)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=name)
    if bias:
        db = flash_attention_bwd_dbias(q, k, v, do, lse, delta, *args,
                                       bias=bb)
        db_p = flash_attention_bwd_dbias_reference(q, k, v, o, lse, do,
                                                   *args, bias=bb)
        torch.testing.assert_close(db, db_p, atol=1e-4, rtol=1e-4)
        if causal:
            above = torch.ones(sq, sk, dtype=torch.bool, device=dev).triu(1)
            assert not bool(db[:, above].any())
    after = ku.launch_counts()
    for name in _flash_names(dtype, d):
        assert name.startswith("flash_attention")
        assert after[name] == counts.get(name, 0) + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,causal", [(320, 512, True), (256, 320, False)])
def test_varlen_head_dims_264_to_512_match_plain(dev, dtype, s, d, causal):
    """The varlen kernels' D = 512 (32-row tiles over the 64-row tile
    tables) vs their plain versions, flash's tolerances; pad rows 0."""
    from apex_tpu_torch.ops.attention_varlen import (
        flash_varlen_bwd_dkv, flash_varlen_bwd_dq,
        flash_varlen_bwd_reference, flash_varlen_fwd,
        flash_varlen_fwd_reference)
    q, k, v, do, seg_q, seg_k = _varlen_case(dev, dtype, 1, 2, s, d, s + d,
                                             foreign_tile=not causal)
    args = (1 / math.sqrt(d), causal)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2 ** -7)
    o, lse = flash_varlen_fwd(q, k, v, seg_q, seg_k, *args)
    o_p, lse_p = flash_varlen_fwd_reference(q, k, v, seg_q, seg_k, *args)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = flash_varlen_bwd_dq(q, k, v, seg_q, seg_k, do, lse, delta, *args)
    dk, dv = flash_varlen_bwd_dkv(q, k, v, seg_q, seg_k, do, lse, delta,
                                  *args)
    want = flash_varlen_bwd_reference(q, k, v, seg_q, seg_k, o, lse, do,
                                      *args)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=name)
    pad_q = (seg_q < 0)[:, None, :].expand(-1, 2, -1)
    assert not bool(o[pad_q].any()) and not bool(dq[pad_q].any())



# ---------------------------------------------------------------------------
# thirteenth slice: the one-pass norm backward; paged attention above 256

# the shapes the card's main paths run (GPT-2's, T5-small's encoder and
# decoder rows, GPT-3's width: a cluster of two), ragged row counts, and
# the widest row JAX's gate admits (a cluster of five)
NORM_BWD_SHAPES = [(8192, 768), (4096, 512), (1024, 512), (2048, 12288),
                   (1000, 768), (7, 384), (333, 2560), (40, 37376)]


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("xt,wt", NORM_TYPES)
@pytest.mark.parametrize("rows,hidden", NORM_BWD_SHAPES)
def test_norm_bwd_one_pass_matches_plain(dev, kind, xt, wt, rows, hidden):
    """The one-pass backward (LayerNorm and RMSNorm) against its plain
    version and the emulation of its sum order, in all four type pairs:
    dx at the file's tolerance, dw/db at the sums' (sqrt(rows) atol); one
    launch counted; dx, dw and db bitwise equal over three repeats."""
    x, w, b, dy = _norm_case(dev, xt, wt, rows, hidden, rows + 3 * hidden)
    name = "layer_norm_bwd" if kind == "ln" else "rms_norm_bwd"
    if kind == "ln":
        _, mean, rstd = layer_norm_fwd(x, w, b, stats=True)
        run = lambda: layer_norm_bwd(dy, x, mean, rstd, w)
        plain = layer_norm_bwd_reference(dy, x, mean, rstd, w)
    else:
        mean = None
        _, rstd = rms_norm_fwd(x, w, stats=True)
        run = lambda: rms_norm_bwd(dy, x, rstd, w)
        plain = rms_norm_bwd_reference(dy, x, rstd, w)
    before = ku.launch_counts().get(name, 0)
    got = run()
    assert ku.launch_counts()[name] == before + 1
    emulated = norm_bwd_split_reference(dy, x, mean, rstd, w)
    for want in (plain, emulated):
        _close_norm(got[0], want[0], xt)
        for g, wnt in zip(got[1:], want[1:]):
            _close_norm(g, wnt, wt, rows)
    for _ in range(3):
        again = run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_norm_bwd_refuses_a_width_off_its_chunks(dev):
    """The backward takes hidden % 8 == 0 (its 8-column chunks): an fp32
    row of 100 columns, which the forward takes, is refused by name."""
    x = torch.randn(8, 100, device=dev)
    w = torch.ones(100, device=dev)
    _, mean, rstd = layer_norm_fwd(x, w, w, stats=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        layer_norm_bwd(x, x, mean, rstd, w)
    with pytest.raises(ValueError, match="multiple of 8"):
        rms_norm_bwd(x, x, rstd, w)


PAGED_WIDE_DIMS = [264, 320, 512, 1024, 2056]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("hd", PAGED_WIDE_DIMS)
def test_paged_wide_head_dims_match_plain(dev, dtype, mode, hd):
    """Above head_dim 256 both types take ``paged_wide_fwd``: against the
    plain version at the paged routes' tolerances (fp32 2e-5; bf16 1e-3
    with full-precision pools, 1e-2 with quantized ones), groups of 5,
    one slot's rows past its blocks, a ctx == 0 row zeros."""
    q, layer, cfg, bt, ctx = _paged_groups(dev, dtype, mode, 3, 5, hd,
                                           seed=hd, mb=12)
    assert _paged_route(dtype, hd) == "paged_wide_fwd"
    before = ku.launch_counts().get("paged_wide_fwd", 0)
    got = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=5)
    assert ku.launch_counts()["paged_wide_fwd"] == before + 1
    want = paged_attention_reference(q, layer, cfg, bt, ctx)
    torch.cuda.synchronize()
    atol = 2e-5 if dtype == torch.float32 else \
        1e-3 if mode == "none" else 1e-2     # bf16 and fp16: the bf16 gate
    rtol = 2e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[0].float().abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_paged_wide_rows_bitwise_whatever_their_group(dev, dtype, mode):
    """At head_dim 512 the same rows as groups of 32, 5 and 1 give
    identical bits, and a launch repeats bitwise."""
    q, layer, cfg, bt, ctx = _paged_groups(dev, dtype, mode, 3, 32, 512,
                                           seed=9, mb=8)
    g32 = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=32)
    g1 = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=1)
    keep = (torch.arange(q.shape[0], device=dev) % 32) < 30
    g5 = paged_attention(q[keep].contiguous(), layer, cfg, bt[keep],
                         ctx[keep], rows_per_table=5)
    again = paged_attention(q, layer, cfg, bt, ctx, rows_per_table=32)
    torch.cuda.synchronize()
    assert torch.equal(g32, g1)
    assert torch.equal(g32[keep], g5)
    assert torch.equal(g32, again)


# ---------------------------------------------------------------------------
# fifteenth slice: the LayerNorm and RMSNorm forward, x read once, a row's
# sum order set by ops.layer_norm._fwd_plan(hidden) alone


def _norm_fwd(kind, x, w, b, stats=True):
    if kind == "ln":
        return layer_norm_fwd(x, w, b, stats=stats)
    return rms_norm_fwd(x, w, stats=stats)


def _norm_fwd_plain(kind, x, w, b):
    if kind == "ln":
        return layer_norm_fwd_reference(x, w, b)
    return rms_norm_fwd_reference(x, w)


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("xt,wt", NORM_TYPES)
@pytest.mark.parametrize("hidden", [128, 512, 768, 896, 4096, 12288, 37376])
def test_norm_fwd_kernel_at_the_plan_edges(dev, kind, xt, wt, hidden):
    """The forward at the plan's edges (one warp of 1-3 chunks, a two-warp
    team, 6- and 16-warp teams, a wide team of 30 warps of 5 chunks) and
    at 1, 3, 7, 37 and 8192 rows: one launch, y within the file's
    tolerance of the plain version, mean and rstd within 2e-5; y, mean and
    rstd bitwise over two launches, and y the same without statistics."""
    name = "layer_norm_fwd" if kind == "ln" else "rms_norm_fwd"
    for rows in (1, 3, 7, 37, 8192):
        x, w, b, _ = _norm_case(dev, xt, wt, rows, hidden, rows + hidden)
        before = ku.launch_counts().get(name, 0)
        got = _norm_fwd(kind, x, w, b)
        assert ku.launch_counts()[name] == before + 1
        want = _norm_fwd_plain(kind, x, w, b)
        _close_norm(got[0], want[0], xt)
        for g, c in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, c, atol=2e-5, rtol=2e-5)
        again = _norm_fwd(kind, x, w, b)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(got, again)), rows
        assert torch.equal(_norm_fwd(kind, x, w, b, stats=False), got[0])
        del x, got, want, again


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("xt,wt", NORM_TYPES)
@pytest.mark.parametrize("hidden", [512, 768, 12288])
def test_norm_fwd_rows_bitwise_whatever_the_call(dev, kind, xt, wt, hidden):
    """Row-count invariance: 8 rows alone give the same y, mean and rstd
    bits as the same 8 rows inside an 8192-row call, first, in the middle
    and last (the engine's 8-row decode and 64-row chunk calls rest on
    it)."""
    x, w, b, _ = _norm_case(dev, xt, wt, 8192, hidden, hidden + 1)
    full = _norm_fwd(kind, x, w, b)
    for start in (0, 4001, 8184):
        part = _norm_fwd(kind, x[start:start + 8].contiguous(), w, b)
        torch.cuda.synchronize()
        assert all(torch.equal(a[start:start + 8], c)
                   for a, c in zip(full, part)), start


# ---------------------------------------------------------------------------
# eighteenth slice: per-tenant LoRA on the per-op path, and use_pallas


def _lora_case(dev, dtype, n, q=5, hidden=256, heads=4, seed=0):
    """A 2-layer GPT, an adapter pool with two adapters (slots 1, 2), pools
    holding random context for every slot, and fed rows whose slots use
    adapters 0, 1 and 2 in turn."""
    from apex_tpu_torch.serve.adapters import (init_adapter_pool,
                                               make_adapter_weights,
                                               write_adapter)

    cfg = GPTConfig(vocab_size=128, max_seq=256, hidden=hidden,
                    num_layers=2, num_heads=heads, dtype=dtype)
    params = init_gpt_params(cfg, seed=seed, device=dev)
    pool = init_adapter_pool(cfg, 8, 2, device=dev)
    for slot in (1, 2):
        w = make_adapter_weights(cfg, 8, torch.Generator().manual_seed(
            seed + slot), std=0.05, device=dev)
        write_adapter(pool, slot, w, scale=2.0)
    hd, bs, mb = hidden // heads, 16, 8
    kv = KVCacheConfig(num_layers=2, num_heads=heads, head_dim=hd,
                       num_blocks=n * mb, block_size=bs, dtype=dtype)
    cache = init_kv_cache(kv, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    bt = torch.from_numpy(rng.permutation(n * mb).reshape(n, mb)
                          .astype(np.int32)).to(dev)
    start = torch.from_numpy(rng.integers(1, 100, n).astype(np.int32)).to(
        dev)
    pos = torch.arange(mb * bs, device=dev).repeat(n)
    old = pos < start.repeat_interleave(mb * bs)
    for li in range(2):
        layer = {k: v[li] for k, v in cache.items()}
        kk = torch.randn(heads, n * mb * bs, hd, device=dev, generator=g)
        vv = torch.randn(heads, n * mb * bs, hd, device=dev, generator=g)
        paged_write(layer, kv, kk.to(dtype), vv.to(dtype),
                    bt.repeat_interleave(mb * bs, dim=0), pos, old)
    toks = torch.from_numpy(rng.integers(0, 128, (n, q)).astype(
        np.int32)).to(dev)
    n_fed = torch.from_numpy(rng.integers(1, q + 1, n).astype(
        np.int32)).to(dev)
    ids = (torch.arange(n, device=dev) % 3).to(torch.int32)
    return params, cfg, kv, cache, pool, bt, start, toks, n_fed, ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_rows_do_not_depend_on_the_batch(dev, dtype):
    """Adapter traffic through the per-op verify (q=5) and decode calls:
    a slot's logits are bitwise the same when it is the only active slot
    of an 8-slot call, among 8 active slots and among 32; and its decode
    row equals its first verify row (the property that keeps spec_k > 0
    streams equal to spec_k = 0 ones under adapters)."""
    from apex_tpu_torch.serve.decode import gpt_decode_step, gpt_verify_step

    (params, cfg, kv, cache, pool, bt, start, toks, n_fed,
     ids) = _lora_case(dev, dtype, 32)

    def run(n, only=None, q=5):
        active = torch.ones(n, dtype=torch.bool, device=dev)
        if only is not None:
            active = torch.arange(n, device=dev) == only
        c = {k: v.clone() for k, v in cache.items()}
        if q == 1:
            return gpt_decode_step(params, toks[:n, 0].contiguous(),
                                   start[:n], active, c, bt[:n], cfg, kv,
                                   adapters=pool, adapter_ids=ids[:n])[1]
        return gpt_verify_step(params, toks[:n], start[:n], n_fed[:n],
                               active, c, bt[:n], cfg, kv, adapters=pool,
                               adapter_ids=ids[:n])[1]

    before = ku.launch_counts().get("layer_norm_fwd", 0)
    v32, v8, d32, d8 = run(32), run(8), run(32, q=1), run(8, q=1)
    assert ku.launch_counts()["layer_norm_fwd"] > before
    for i in (1, 2, 5):
        nf = int(n_fed[i])
        alone_v, alone_d = run(8, only=i), run(8, only=i, q=1)
        torch.cuda.synchronize()
        for got in (v8[i, :nf], alone_v[i, :nf]):
            assert torch.equal(got, v32[i, :nf]), i
        for got in (d8[i], alone_d[i], v32[i, 0]):
            assert torch.equal(got, d32[i]), i


def _small_engine(dev, dtype=torch.bfloat16, **kw):
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = GPTConfig(vocab_size=128, max_seq=256, hidden=256, num_layers=2,
                    num_heads=4, dtype=dtype)
    params = init_gpt_params(cfg, seed=0, device=dev)
    scfg = {k: v for k, v in kw.items() if k in (
        "spec_k", "lora_rank", "max_adapters", "megakernel")}
    eng_kw = {k: v for k, v in kw.items() if k not in scfg}
    return cfg, InferenceEngine(params, cfg, ServeConfig(
        num_slots=8, block_size=16, prefill_chunk=32, **scfg), device=dev,
        **eng_kw)


def _requests(n=8, adapters=()):
    from apex_tpu_torch.serve import Request

    rng = np.random.default_rng(1)
    return [Request(f"r{i}", rng.integers(0, 128, 20 + 7 * i).tolist(),
                    max_new_tokens=12,
                    adapter=adapters[i % len(adapters)] if adapters
                    else None) for i in range(n)]


def test_engine_use_pallas_false_launches_no_kernel(dev):
    """use_pallas=False on a CUDA engine runs the plain versions: no
    kernel launch in a whole run (decode_kernel 'plain', even with
    megakernel='auto'); the default launches the kernels."""
    _, eng = _small_engine(dev, use_pallas=False)
    assert eng.decode_kernel == "plain" and not eng.megakernel_enabled
    before = ku.launch_counts()
    out = eng.run(_requests())
    torch.cuda.synchronize()
    assert ku.launch_counts() == before and len(out) == 8
    _, eng = _small_engine(dev)
    eng.run(_requests())
    assert ku.launch_counts() != before


def test_engine_lora_on_the_card(dev):
    """A CUDA adapter engine: megakernel='auto' falls back to the per-op
    kernels ('cuda') with JAX's reason, 'on' raises; base traffic is
    bitwise the engine without adapters; spec_k=4 streams equal spec_k=0
    streams with adapter traffic."""
    from apex_tpu_torch.serve.adapters import make_adapter_weights

    with pytest.raises(ValueError, match="LoRA adapters"):
        _small_engine(dev, lora_rank=8, max_adapters=2, megakernel="on")
    cfg, eng = _small_engine(dev, lora_rank=8, max_adapters=2)
    assert eng.decode_kernel == "cuda"
    base = _small_engine(dev, megakernel="off")[1].run(_requests())
    assert eng.run(_requests()) == base
    outs = []
    for k in (0, 4):
        _, e = _small_engine(dev, lora_rank=8, max_adapters=2, spec_k=k)
        for name, seed in (("t1", 1), ("t2", 2)):
            e.load_adapter(name, make_adapter_weights(
                cfg, 8, torch.Generator().manual_seed(seed), std=0.05,
                device=dev))
        outs.append(e.run(_requests(adapters=("t1", "t2", None))))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# hidden dropout (csrc/dropout.cu) and the remat policies


def _dropout_key(seed):
    from apex_tpu_torch.transformer.tensor_parallel import prng_key
    return prng_key(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1024, 768), (8, 512, 512), (1001,),
                                   (3, 7), (5,)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hidden_dropout_kernel_bitwise_equals_plain(dev, dtype, shape, rate):
    """The kernel's y and dx bitwise the plain version's (the int64
    threefry draw) at GPT's and T5's sites, odd counts and a count below
    one vector; one launch a forward and one a backward."""
    from apex_tpu_torch.ops.dropout import (hidden_dropout,
                                            hidden_dropout_fwd,
                                            hidden_dropout_reference)
    g = torch.Generator(device=dev).manual_seed(len(shape))
    x = torch.randn(*shape, device=dev, generator=g).to(dtype)
    dy = torch.randn(*shape, device=dev, generator=g).to(dtype)
    key = _dropout_key(sum(shape))
    got = hidden_dropout_fwd(x, rate, key)
    torch.cuda.synchronize()
    assert torch.equal(got, hidden_dropout_reference(x, rate, key))
    xr = x.clone().requires_grad_()
    before = ku.launch_counts().get("hidden_dropout", 0)
    y = hidden_dropout(xr, rate, key)
    y.backward(dy)
    assert ku.launch_counts()["hidden_dropout"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(y, got)
    assert torch.equal(xr.grad, hidden_dropout_reference(dy, rate, key))
    if x.numel() > 10000:
        keep = (got != 0).float().mean().item()
        sigma = math.sqrt(rate * (1 - rate) / x.numel())
        assert abs(keep - (1 - rate)) < 5 * sigma


def test_hidden_dropout_kernel_counter_high_word(dev):
    """Past 2**32 elements the counter's high word is the index's upper
    bits: the last elements of a (2**32 + 40)-element bf16 tensor equal
    the threefry draw at their own (hi, lo) words."""
    from apex_tpu_torch.ops.dropout import hidden_dropout_fwd
    from apex_tpu_torch.transformer.tensor_parallel import random as trandom
    n = 2 ** 32 + 40
    x = torch.ones(n, dtype=torch.bfloat16, device=dev)
    key = _dropout_key(5)
    y = hidden_dropout_fwd(x, 0.5, key)[-80:].float().cpu()
    del x
    torch.cuda.empty_cache()
    idx = torch.arange(n - 80, n, dtype=torch.int64)
    b0, b1 = trandom.threefry2x32(key, idx >> 32, idx & trandom.M32)
    keep = ((b0 ^ b1) >> 9) < trandom.keep_threshold(0.5)
    assert torch.equal(y, torch.where(keep, 2.0, 0.0))


def test_hidden_dropout_kernel_refuses_other_types(dev):
    from apex_tpu_torch.ops.dropout import hidden_dropout_fwd
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        hidden_dropout_fwd(torch.ones(8, device=dev, dtype=torch.float64),
                           0.1, _dropout_key(0))
    x = torch.arange(20, device=dev, dtype=torch.float32)
    sliced = x[1:]  # 4 bytes past a 16-byte boundary
    from apex_tpu_torch.ops.dropout import hidden_dropout_reference
    assert torch.equal(hidden_dropout_fwd(sliced, 0.3, _dropout_key(1)),
                       hidden_dropout_reference(sliced, 0.3,
                                                _dropout_key(1)))


@pytest.mark.parametrize("policy,flash_fwd", [("full", 4), ("dots", 4),
                                              ("dots_attn", 2)])
def test_remat_policy_flash_launches_and_bitwise_grads(dev, policy,
                                                       flash_fwd):
    """A 2-layer bf16 GPT step with both dropout rates 0.1: the flash
    forward launches 4 times under ``full`` and ``dots`` (forward and
    recompute), 2 under ``dots_attn``; ``hidden_dropout`` 12 times under
    each; loss and gradients bitwise ``full``'s."""
    from apex_tpu_torch.transformer.testing import gpt_loss
    base = dict(num_layers=2, attention_dropout=0.1, hidden_dropout=0.1)
    params = init_gpt_params(GPTConfig(**base), seed=0, device=dev)
    leaves = [p for _, p in named_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    tok = torch.randint(0, 50304, (2, 1024), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    tgt = torch.roll(tok, -1, dims=1)
    key = _dropout_key(3)

    def run(pol):
        for p in leaves:
            p.grad = None
        ku.reset_launch_counts()
        loss = gpt_loss(params, tok, tgt, GPTConfig(remat_policy=pol, **base),
                        dropout_key=key)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), [p.grad.clone() for p in leaves], \
            ku.launch_counts()

    loss_f, grads_f, _ = run("full")
    loss, grads, counts = run(policy)
    assert counts["flash_mma_fwd"] == flash_fwd
    assert counts["hidden_dropout"] == 12
    assert torch.equal(loss, loss_f)
    for a, b in zip(grads, grads_f):
        assert torch.equal(a, b)


def test_no_dropout_launch_when_rates_are_zero(dev):
    """A GPT step with a key but both rates 0 (and one without a key) runs
    no dropout kernel and gives the eval loss bitwise."""
    from apex_tpu_torch.transformer.testing import gpt_loss
    cfg = GPTConfig(num_layers=2)
    params = init_gpt_params(cfg, seed=0, device=dev)
    tok = torch.randint(0, 50304, (2, 256), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    tgt = torch.roll(tok, -1, dims=1)
    ku.reset_launch_counts()
    with torch.no_grad():
        a = gpt_loss(params, tok, tgt, cfg, dropout_key=_dropout_key(1))
        b = gpt_loss(params, tok, tgt, cfg)
    torch.cuda.synchronize()
    assert "hidden_dropout" not in ku.launch_counts()
    assert torch.equal(a, b)
