"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode) and skips without one. This file imports neither jax nor apex_tpu,
so it also runs on a machine that has no JAX; the repo's conftest imports
jax, so run it there with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: fp32 atol/rtol 2e-5 (summation order and fused multiply-adds
differ from the plain version's kernels); bf16 atol 1e-3, rtol 2**-7 (one
rounding step of the bf16 output).
"""

import math

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_fwd,
                                           layer_norm_reference)
from apex_tpu_torch.serve.decode import (paged_attention, paged_attention_fwd,
                                         paged_attention_reference)
from apex_tpu_torch.serve.kv_cache import KVCacheConfig

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 2 ** -7)}


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
                                         (512, 1024), (5, 4096)])
def test_layer_norm_kernel_matches_plain(dev, dtype, rows, hidden):
    g = torch.Generator(device=dev).manual_seed(rows * hidden)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2 + 1).to(dtype)
    w = torch.randn(hidden, device=dev, generator=g).to(dtype)
    b = torch.randn(hidden, device=dev, generator=g).to(dtype)
    before = ku.launch_counts().get("layer_norm_fwd", 0)
    got = layer_norm(x, w, b)
    assert ku.launch_counts()["layer_norm_fwd"] == before + 1
    _close(got, layer_norm_reference(x, w, b), dtype)
    assert got.dtype == dtype and got.shape == x.shape


def test_layer_norm_kernel_refuses_what_it_cannot_take(dev):
    x = torch.randn(4, 100, device=dev)        # 100 % 4 fp32 ok; bf16 not
    w, b = torch.ones(100, device=dev), torch.zeros(100, device=dev)
    layer_norm_fwd(x, w, b)
    with pytest.raises(ValueError, match="multiple"):
        layer_norm_fwd(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="weight"):
        layer_norm_fwd(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="affine"):
        layer_norm(x)                          # no plain detour on CUDA
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(torch.randn(100, 4, device=dev).t(), w, b)
    with ku.force_plain():
        torch.testing.assert_close(layer_norm(x), layer_norm_reference(x))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,heads,hd,bs,mb", [
    (8, 12, 64, 16, 64), (3, 2, 32, 8, 3), (40, 4, 128, 16, 5),
    (5, 3, 64, 4, 33)])
def test_paged_attention_kernel_matches_plain(dev, dtype, n, heads, hd, bs,
                                              mb):
    q, pools, cfg, bt, ctx = _paged(dev, dtype, n, heads, hd, bs, mb,
                                    seed=n + hd)
    before = ku.launch_counts().get("paged_attention_fwd", 0)
    got = paged_attention(q, pools, cfg, bt, ctx)
    assert ku.launch_counts()["paged_attention_fwd"] == before + 1
    want = paged_attention_reference(q, pools, cfg, bt, ctx)
    _close(got, want, dtype)
    assert not got[0].float().abs().max()        # ctx == 0 -> zeros


def test_paged_attention_kernel_refuses_what_it_cannot_take(dev):
    q, pools, cfg, bt, ctx = _paged(dev, torch.float32, 4, 2, 64, 16, 2, 1)
    scale = 1 / math.sqrt(64)
    paged_attention_fwd(q, pools, cfg, bt, ctx, scale)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_fwd(q[..., :48].contiguous(),
                            {k: v[..., :48].contiguous()
                             for k, v in pools.items()},
                            cfg, bt, ctx, scale)
    with pytest.raises(ValueError, match="pool"):
        paged_attention_fwd(q, {k: v.bfloat16() for k, v in pools.items()},
                            cfg, bt, ctx, scale)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_fwd(q.transpose(0, 1).contiguous().transpose(0, 1),
                            pools, cfg, bt, ctx, scale)
    with pytest.raises(ValueError, match="rows"):
        paged_attention_fwd(q, pools, cfg, bt[:3], ctx, scale)
