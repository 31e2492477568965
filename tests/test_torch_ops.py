"""apex_tpu_torch ops and package rules, on the CPU, against apex_tpu.

The same numpy inputs go through the JAX function and its port; the JAX
side runs as its own tests run it on the CPU (the plain reference, or the
Pallas kernel in interpret mode). On the CPU the port's wrappers take
their plain PyTorch versions; the CUDA kernels are held against those
plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``).
"""

import ast
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.attention import attention_reference as jax_attention
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import layer_norm_reference as jax_ln_ref
from apex_tpu.serve import KVCacheConfig as JKV
from apex_tpu.serve import paged_attention as jax_paged
from apex_tpu.serve import paged_attention_reference as jax_paged_ref
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch import resolve_device
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops.attention import attention_reference
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_fwd,
                                           layer_norm_reference)
from apex_tpu_torch.serve import KVCacheConfig
from apex_tpu_torch.serve.decode import (paged_attention, paged_attention_fwd,
                                         paged_attention_reference)
from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# LayerNorm


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(affine):
    """Port vs JAX reference and the JAX Pallas kernel (interpret mode), at
    a shape its gate takes (rows % 8 == 0, hidden % 128 == 0). atol 1e-6:
    same fp32 formula, summation order the only difference."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 128)) * 3 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    args = (w, b) if affine else (None, None)
    got = layer_norm(_t(x), *(None if a is None else _t(a) for a in args))
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    want_ref = np.asarray(jax_ln_ref(jnp.asarray(x), *jargs))
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-6, rtol=0)
    if affine:
        want_k = np.asarray(jax_layer_norm(jnp.asarray(x), *jargs,
                                           use_pallas=True))
        np.testing.assert_allclose(got.numpy(), want_k, atol=1e-6, rtol=0)


@pytest.mark.parametrize("rows", [1, 3, 4, 12])
def test_layer_norm_any_row_count(rows):
    """The port takes every row count (the TPU gate refused rows % 8);
    held against the JAX reference, atol 1e-6."""
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 2, 96)).astype(np.float32)
    w = rng.standard_normal(96).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    got = layer_norm(_t(x), _t(w), _t(b))
    want = jax_ln_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_layer_norm_constant_rows_stay_finite():
    """E[x²]−E[x]² can dip below 0 on constant rows: the clamp keeps the
    result finite, as in the JAX reference."""
    x = torch.full((8, 128), 3.0)
    y = layer_norm_reference(x)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jax_ln_ref(jnp.full((8, 128), 3.0))), atol=1e-6)


def test_layer_norm_bf16_rounds_like_jax():
    """bf16 in -> bf16 out after fp32 math; equal to the JAX reference up
    to one bf16 rounding step (2**-7 relative)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x).to(torch.bfloat16)
    got = layer_norm(xt).float().numpy()
    want = np.asarray(jax_ln_ref(xj).astype(jnp.float32))
    assert layer_norm(xt).dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# attention reference + paged attention


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    """atol 1e-6: fp32 softmax(QKᵀ)V in both packages."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    mask = rng.random((2, 1, 5, 7)) < 0.3
    got = attention_reference(_t(q), _t(k), _t(v), mask=_t(mask),
                              causal=causal)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         mask=jnp.asarray(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _paged_case(seed, n=6, heads=4, hd=32, bs=8, mb=5):
    """Random pools, ragged contexts (one idle row, one full row) and a
    block table of shuffled block ids."""
    rng = np.random.default_rng(seed)
    blocks = n * mb
    kp = rng.standard_normal((heads, blocks, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((heads, blocks, bs, hd)).astype(np.float32)
    q = rng.standard_normal((n, heads, hd)).astype(np.float32)
    bt = rng.permutation(blocks).reshape(n, mb).astype(np.int32)
    ctx = rng.integers(1, mb * bs + 1, n).astype(np.int32)
    ctx[0], ctx[1] = 0, mb * bs
    return q, kp, vp, bt, ctx, blocks


def test_paged_attention_matches_jax():
    """Port plain version vs JAX Pallas kernel (interpret mode) and JAX
    reference over the active rows (ctx > 0); the idle row is zeros in the
    port. atol 1e-5."""
    q, kp, vp, bt, ctx, blocks = _paged_case(0)
    heads, _, bs, hd = kp.shape
    jcfg = JKV(num_layers=1, num_heads=heads, head_dim=hd, num_blocks=blocks,
               block_size=bs, dtype=jnp.float32)
    jl = {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}
    args = (jnp.asarray(q), jl, jcfg, jnp.asarray(bt), jnp.asarray(ctx))
    want_k = np.asarray(jax_paged(*args, use_pallas=True, interpret=True))
    want_r = np.asarray(jax_paged_ref(*args))
    cfg = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                        num_blocks=blocks, block_size=bs, dtype=torch.float32)
    layer = {"k": _t(kp), "v": _t(vp)}
    got = paged_attention_reference(_t(q), layer, cfg, _t(bt), _t(ctx))
    live = ctx > 0
    np.testing.assert_allclose(got.numpy()[live], want_k[live], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy()[live], want_r[live], atol=1e-5,
                               rtol=0)
    assert not got.numpy()[~live].any()          # ctx == 0 -> zeros
    # the dispatching front door takes the plain version on the CPU
    front = paged_attention(_t(q), layer, cfg, _t(bt), _t(ctx))
    torch.testing.assert_close(front, got, atol=0, rtol=0)


def test_paged_attention_bf16_pools():
    """bf16 q and pools: fp32 math inside, bf16 out; equal to the fp32
    computation on the same bf16 values up to one bf16 rounding."""
    q, kp, vp, bt, ctx, blocks = _paged_case(1)
    heads, _, bs, hd = kp.shape
    cfg16 = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                          num_blocks=blocks, block_size=bs,
                          dtype=torch.bfloat16)
    cfg32 = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                          num_blocks=blocks, block_size=bs,
                          dtype=torch.float32)
    l16 = {"k": _t(kp).bfloat16(), "v": _t(vp).bfloat16()}
    q16 = _t(q).bfloat16()
    got = paged_attention(q16, l16, cfg16, _t(bt), _t(ctx))
    assert got.dtype == torch.bfloat16
    want = paged_attention(q16.float(), {k: v.float() for k, v in l16.items()},
                           cfg32, _t(bt), _t(ctx))
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel dispatch rules


def test_use_kernel_dispatch_by_device():
    assert ku.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no kernel"):
        ku.use_kernel(torch.zeros(1, device="meta"))
    with ku.force_plain():
        assert ku._FORCE_PLAIN[0]
    assert not ku._FORCE_PLAIN[0]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor never reaches a kernel
    wrapper quietly, and the launch counters do not move."""
    before = ku.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_fwd(torch.zeros(4, 128), torch.ones(128),
                       torch.zeros(128))
    cfg = KVCacheConfig(num_layers=1, num_heads=2, head_dim=64,
                        num_blocks=2, block_size=16, dtype=torch.float32)
    pools = {k: torch.zeros(2, 3, 16, 64) for k in "kv"}
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_fwd(torch.zeros(1, 2, 64), pools, cfg,
                            torch.zeros(1, 2, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32), 0.125)
    assert ku.launch_counts() == before


def test_kernel_library_names_track_sources():
    """Each library is named by a hash of its source and the nvcc flags,
    so an edited kernel is rebuilt rather than loaded stale."""
    paths = {n: ku._lib_path(n) for n in ku.KERNEL_SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == ku.BUILD_DIR and p.name.startswith(f"lib{name}-")
        assert (ku.CSRC_DIR / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in ku.NVCC_FLAGS


# ---------------------------------------------------------------------------
# params, devices, package rules


def test_params_from_numpy_bf16_bit_exact():
    """JAX bf16 leaves (ml_dtypes bfloat16 on the host) cross as raw bits."""
    cfg = JGPTConfig(vocab_size=64, max_seq=16, hidden=32, num_layers=2,
                     num_heads=4, dtype=jnp.bfloat16, fused_loss=False)
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    got = params_from_numpy(tree, "cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        t = got
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(leaf).view(np.int16))


def test_init_gpt_params_layout_matches_jax():
    """Same keys, shapes and init statistics as the JAX tree."""
    jcfg = JGPTConfig(vocab_size=96, max_seq=32, hidden=64, num_layers=3,
                      num_heads=4, dtype=jnp.float32, fused_loss=False)
    cfg = GPTConfig(vocab_size=96, max_seq=32, hidden=64, num_layers=3,
                    num_heads=4, dtype=torch.float32)
    jt = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    pt = init_gpt_params(cfg, seed=0, device="cpu")
    jflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_leaves_with_path(jt)}
    pflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_leaves_with_path(
                 jax.tree.map(lambda t: t.numpy(), pt))}
    assert sorted(jflat) == sorted(pflat)
    for k in jflat:
        assert jflat[k].shape == pflat[k].shape, k
    out_std = 0.02 / math.sqrt(2 * 3)
    assert abs(pt["layers"]["out_kernel"].std().item() - out_std) < 2e-4
    assert abs(pt["embed"]["tok"].std().item() - 0.02) < 1e-3


def test_device_rule_without_cuda():
    """Entry points default to CUDA and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_gpt_params(GPTConfig(vocab_size=8, max_seq=4, hidden=8,
                                  num_layers=1, num_heads=2))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_apex_tpu():
    """No module of apex_tpu_torch, not chip_smoke.py, and not the rank
    functions the multi-process tests spawn (tests/torch_dist_workers.py)
    imports jax or the JAX package (module names matched exactly:
    apex_tpu_torch itself has apex_tpu as a prefix)."""
    files = sorted((REPO / "apex_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "torch_dist_workers.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "apex_tpu", "flax", "optax"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad
