"""fp16 through the port's kernel paths (ROADMAP C4, C6) and the Megatron
GradScaler's ``axis_names`` (C5), against the JAX package on the CPU.

The same numpy inputs go through JAX's function and the port's. JAX's
Pallas wrappers have no dtype gate, so its kernels run fp16 in interpret
mode as their own tests run them (``use_pallas=True``, ``interpret=True``
where the wrapper takes it); the port's wrappers run their plain PyTorch
versions on CPU tensors, fp16 included (the CUDA kernels are held to
those on the card: ``tests/test_torch_kernels_cuda.py::
test_kernels_take_fp16``).

Tolerances: fp16 outputs within atol 2e-3 + rtol 2**-9 (two fp16 steps:
both sides round once, from fp32 sums in other orders); gradients of
flash, varlen and the LM head within atol 1e-2 + rtol 2**-7, the gates
their bf16 parity tests hold (p, ds and dl rounded to fp16 on both sides
from fp32 values that differ in the last bits); fp32 statistics and the
Adam tail's fp32 moments within 1e-5; dropout bitwise.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.attention import flash_attention as jax_flash
from apex_tpu.ops.attention_varlen import (
    flash_attention_varlen as jax_varlen)
from apex_tpu.ops.fused_update import fused_adam_tail as jax_tail
from apex_tpu.ops.layer_norm import layer_norm as jax_ln
from apex_tpu.ops.layer_norm import rms_norm as jax_rms
from apex_tpu.ops.lm_head_loss import lm_head_loss as jax_lm
from apex_tpu.transformer.amp import GradScaler as JGradScaler
from apex_tpu.transformer.testing.standalone_gpt import (
    _hidden_dropout as jax_hidden_dropout)

from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops.dropout import dropout_scale, hidden_dropout
from apex_tpu_torch.ops.fused_update import fused_adam_tail
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from apex_tpu_torch.transformer.amp import GradScaler

# the modules (``apex_tpu_torch.ops`` also exports functions of these names)
pattn = importlib.import_module("apex_tpu_torch.ops.attention")
pvl = importlib.import_module("apex_tpu_torch.ops.attention_varlen")
plm = importlib.import_module("apex_tpu_torch.ops.lm_head_loss")

H = torch.float16


def _t(a):
    return torch.from_numpy(np.array(a))


def _np32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(_np32(got), _np32(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _fp16(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float16)


# ---------------------------------------------------------------------------
# C5: GradScaler(axis_names=())


@pytest.mark.parametrize("kw", [
    dict(init_scale=2.0 ** 10, growth_factor=4.0, backoff_factor=0.25,
         growth_interval=2, hysteresis=2),
    dict(init_scale=2.0 ** 16, growth_interval=3)])
def test_grad_scaler_axis_names_empty_matches_jax_unsynced(kw):
    """``axis_names=()``: ``update_scale(synced=False)`` runs on one
    device (the flag's sync is the identity, as JAX's loop over no axes),
    every state and skip equal to JAX's on the same flag sequence."""
    flags = [0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0]
    s, js = GradScaler(axis_names=(), **kw), JGradScaler(axis_names=(), **kw)
    st, jst = s.init_state(device="cpu"), js.init_state()
    for f in flags:
        st, sk = s.update_scale(st, torch.tensor(f), synced=False)
        jst, jsk = js.update_scale(jst, jnp.asarray(f), synced=False)
        assert (float(st.loss_scale), int(st.unskipped),
                int(st.hysteresis_left), bool(sk)) == (
            float(jst.loss_scale), int(jst.unskipped),
            int(jst.hysteresis_left), bool(jsk))
    flag = torch.tensor(1.0)
    assert s.sync_found_inf(flag) is flag


def test_grad_scaler_mesh_axes_raise_naming_a7():
    """Mesh axis names, ported with the tensor-parallel slice (held across
    ranks in ``tests/test_torch_tensor_parallel.py``): the scaler takes
    them; syncing needs a mesh, which names how to build one."""
    s = GradScaler(axis_names=("tp",))
    with pytest.raises(RuntimeError, match="build_mesh"):
        s.sync_found_inf(torch.tensor(1.0))
    with pytest.raises(ValueError, match="not both"):
        GradScaler(axis_names=(), group=object())


# ---------------------------------------------------------------------------
# C4: the routes and the C entries' type codes


@pytest.mark.parametrize("d", [8, 40, 64, 128, 256])
def test_fp16_flash_and_varlen_take_the_tensor_cores_up_to_256(d):
    assert pattn._flash_route(H, d) == "tensor_core"
    assert pvl._varlen_route(H, d) == "tensor_core"


@pytest.mark.parametrize("d", [264, 512, 1024, 2048, 2056, 4096])
def test_fp16_flash_and_varlen_above_256_take_the_cuda_cores(d):
    assert pattn._flash_route(H, d) == "cuda_core"
    assert pvl._varlen_route(H, d) == "cuda_core"


def test_dtype_codes_match_the_c_entries():
    """0 fp32, 1 bf16, 2 fp16 (csrc/common.cuh apex::kF32 / kBF16 /
    kF16); another type raises."""
    assert [ku.dtype_code(t) for t in (torch.float32, torch.bfloat16, H)] \
        == [0, 1, 2]
    src = (ku.CSRC_DIR / "common.cuh").read_text()
    assert "constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;" in src
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        ku.dtype_code(torch.float64)


def test_tensor_core_sources_instantiate_f16_mma():
    """The tensor-core tile code issues ``mma.sync ... .f16.f16`` for fp16
    operands beside the bf16 form, and the flash, varlen and LM-head
    entries dispatch fp16 (``apex::kF16``) to it."""
    tile = (ku.CSRC_DIR / "flash_mma.cuh").read_text()
    assert "m16n8k16.row.col.f32.f16.f16.f32" in tile
    assert "m16n8k16.row.col.f32.bf16.bf16.f32" in tile
    for name in ("flash_mma.cu", "flash_varlen_mma.cu", "lm_head_mma.cu"):
        assert "apex::kF16" in (ku.CSRC_DIR / name).read_text(), name


@pytest.mark.parametrize("entry", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("d", [64, 320])
def test_flash_wrappers_pass_the_fp16_code(monkeypatch, entry, d):
    """The flash wrappers hand fp16 tensors to their routed C entry with
    type code 2, no cast before it (the argument is the tensor's own
    pointer)."""
    calls = []

    class _Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, args))
                return 0
            return fn

    monkeypatch.setattr(pattn, "_check_flash",
                        lambda what, q3, *a: (1, q3.shape[0], q3.shape[1],
                                              q3.shape[1], q3.shape[2]))
    monkeypatch.setattr(ku, "load_kernel", lambda name, table: _Lib())
    monkeypatch.setattr(ku, "check_status", lambda *a: None)
    monkeypatch.setattr(ku, "stream_handle", lambda t: None)
    q = torch.zeros(2, 64, d, dtype=H)
    row = torch.zeros(2, 64, 1)
    fn = {"fwd": lambda: pattn.flash_attention_fwd(q, q, q, 0.1, True),
          "bwd_dq": lambda: pattn.flash_attention_bwd_dq(
              q, q, q, q, row, row, 0.1, True),
          "bwd_dkv": lambda: pattn.flash_attention_bwd_dkv(
              q, q, q, q, row, row, 0.1, True)}[entry]
    fn()
    prefix = "flash_mma" if d <= 256 else "flash_attention"
    assert calls[0][0] == f"{prefix}_{entry}"
    args = calls[0][1]
    assert args[1] == q.data_ptr() and args[-2] == 2


# ---------------------------------------------------------------------------
# C4: the plain versions in fp16 against JAX's interpret-mode kernels


@pytest.mark.parametrize("wdt", ["float16", "float32"])
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norms_fp16_match_jax_kernels(kind, wdt):
    """LayerNorm / RMSNorm forward and gradients with fp16 x and an fp16
    or fp32 weight: y and dx fp16, dw (and db) in the weight's type."""
    rng = np.random.default_rng(3)
    x = _fp16(rng, (64, 256), 2.0)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(wdt)
    b = (0.1 * rng.standard_normal(256)).astype(wdt)
    dy = _fp16(rng, (64, 256))
    if kind == "layer_norm":
        jfn = lambda x, w, b: jax_ln(x, w, b, use_pallas=True)
        pfn = layer_norm
        args = (x, w, b)
    else:
        jfn = lambda x, w: jax_rms(x, w, use_pallas=True)
        pfn = rms_norm
        args = (x, w)
    y_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    grads_j = vjp(jnp.asarray(dy))
    leaves = [_t(a).requires_grad_() for a in args]
    y = pfn(*leaves)
    y.backward(_t(dy))
    assert y.dtype == H and y_j.dtype == jnp.float16
    _close(y, y_j, 2e-3, 2 ** -9, "y")
    _close(leaves[0].grad, grads_j[0], 2e-3, 2 ** -9, "dx")
    for got, want in zip(leaves[1:], grads_j[1:]):
        assert str(got.grad.dtype).endswith(wdt)
        # a sum over 64 rows of fp16 products, rounded once
        _close(got.grad, want, 2e-2, 2 ** -9, "dw/db")


@pytest.mark.parametrize("causal,rate", [(True, 0.0), (False, 0.0),
                                         (True, 0.2)])
def test_flash_fp16_matches_jax_kernels(causal, rate):
    """Flash forward and gradients in fp16 (with the counter-hash
    dropout): the port's plain versions vs JAX's Pallas kernels in
    interpret mode."""
    rng = np.random.default_rng(int(causal) + int(rate * 10))
    q, k, v, do = (_fp16(rng, (2, 2, 128, 64)) for _ in range(4))
    kw = dict(causal=causal)
    if rate:
        kw.update(dropout_rate=rate, dropout_seed=1234)
    o_j, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, use_pallas=True, interpret=True, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = pattn.flash_attention(*leaves, **kw)
    o.backward(_t(do))
    assert o.dtype == H and o_j.dtype == jnp.float16
    _close(o, o_j, 2e-3, 2 ** -9, "o")
    for t, want, name in zip(leaves, g_j, "qkv"):
        assert t.grad.dtype == H
        _close(t.grad, want, 1e-2, 2 ** -7, "d" + name)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_fp16_matches_jax_kernels(causal):
    """Packed varlen attention in fp16, forward and gradients, against
    JAX's varlen Pallas kernels in interpret mode."""
    rng = np.random.default_rng(7 + int(causal))
    seg = np.repeat(np.arange(4), [50, 30, 28, 20])[None].astype(np.int32)
    q, k, v, do = (_fp16(rng, (1, 2, 128, 32)) for _ in range(4))
    o_j, vjp = jax.vjp(lambda q, k, v: jax_varlen(
        q, k, v, jnp.asarray(seg), causal=causal, use_pallas=True,
        interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = pvl.flash_attention_varlen(*leaves, _t(seg), causal=causal)
    o.backward(_t(do))
    assert o.dtype == H
    _close(o, o_j, 2e-3, 2 ** -9, "o")
    for t, want, name in zip(leaves, g_j, "qkv"):
        _close(t.grad, want, 1e-2, 2 ** -7, "d" + name)


def test_lm_head_fp16_matches_jax_kernels():
    """The fused LM-head loss in fp16: per-row loss (fp32) and the fp16
    dx, dw against JAX's Pallas kernels."""
    rng = np.random.default_rng(11)
    x = _fp16(rng, (128, 128))
    w = _fp16(rng, (300, 128), 0.05)
    t = rng.integers(0, 300, 128).astype(np.int32)
    g = rng.standard_normal(128).astype(np.float32)
    loss_j, vjp = jax.vjp(lambda x, w: jax_lm(x, w, jnp.asarray(t),
                                              use_pallas=True),
                          jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    loss = plm.lm_head_loss(tx, tw, _t(t).long())
    loss.backward(_t(g))
    assert loss.dtype == torch.float32 and tx.grad.dtype == H
    _close(loss, loss_j, 2e-5, 2e-5, "loss")
    _close(tx.grad, dx_j, 1e-2, 2 ** -7, "dx")
    _close(tw.grad, dw_j, 1e-2, 2 ** -7, "dw")


@pytest.mark.parametrize("wd,adam_w", [(0.0, True), (0.01, True),
                                       (0.01, False)])
def test_adam_tail_fp16_matches_jax_kernel(wd, adam_w):
    """The Adam tail with fp16 g and p, fp32 m and v: u, m', v' (fp32)
    against JAX's Pallas tail."""
    rng = np.random.default_rng(5)
    g, p = _fp16(rng, 4096), _fp16(rng, 4096)
    m = rng.standard_normal(4096).astype(np.float32)
    v = rng.random(4096).astype(np.float32)
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
              adam_w_mode=adam_w)
    want = jax_tail(jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                    jnp.asarray(p), 0.271, 0.003, use_pallas=True, **kw)
    got = fused_adam_tail(_t(g), _t(m), _t(v), _t(p), 0.271, 0.003, **kw)
    for a, b, name in zip(got, want, ("u", "m", "v")):
        assert a.dtype == torch.float32, name
        _close(a, b, 1e-5, 1e-5, name)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hidden_dropout_fp16_bitwise_jax(rate):
    """Hidden dropout in fp16 and its vjp bitwise JAX's ``_hidden_dropout``:
    the keep scale rounded once to fp16, as JAX's weakly typed scalar."""
    rng = np.random.default_rng(9)
    x = _fp16(rng, (7, 333), 3.0)
    dy = _fp16(rng, (7, 333))
    jk = jax.random.key(17)
    y_j, vjp = jax.vjp(lambda a: jax_hidden_dropout(a, rate, jk),
                       jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dy))
    key = np.asarray(jax.random.key_data(jk))
    tx = _t(x).requires_grad_()
    y = hidden_dropout(tx, rate, key)
    y.backward(_t(dy))
    assert y.dtype == H and tx.grad.dtype == H
    for got, want in ((y, y_j), (tx.grad, dx_j)):
        np.testing.assert_array_equal(
            got.detach().numpy().view(np.uint16),
            np.asarray(want).view(np.uint16))
    assert dropout_scale(rate, H) == float(
        (jnp.ones((), jnp.float16) * (1.0 / (1.0 - rate))).astype(
            jnp.float32))


# ---------------------------------------------------------------------------
# C6 (recorded): JAX's serving and codec kernels compute fp16, the port's
# gates refuse it


def test_c6_jax_serving_and_codec_kernels_take_fp16_the_port_refuses(
        monkeypatch):
    """JAX's paged attention (#19), fused decode layer (#20) and codec
    (#16-18) compute fp16 in interpret mode (finite outputs); since C6 was
    closed the port's paged route, fused-layer gate and quantize kernel
    wrapper take fp16 as well (the tensor-core route, the fused layer, the
    codec's own type), and refuse only a type none of the kernels takes
    (float64). The port's fp16 results themselves are held to JAX's in
    ``test_torch_fp16_serve.py``."""
    from apex_tpu.comm import quantize as jq
    from apex_tpu.serve import KVCacheConfig as JKV
    from apex_tpu.serve import init_kv_cache as jax_init_cache
    from apex_tpu.serve import paged_attention as jax_paged
    from apex_tpu.serve import paged_write as jax_write
    from apex_tpu.serve.megakernel import fused_layer_decode
    from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
    from apex_tpu.transformer.testing import init_gpt_params as jax_init
    from apex_tpu_torch.comm import quantize as pq
    from apex_tpu_torch.serve import KVCacheConfig
    from apex_tpu_torch.serve.decode import _paged_route
    from apex_tpu_torch.serve.megakernel import megakernel_refusal
    from apex_tpu_torch.transformer.testing import GPTConfig

    f16 = jnp.float16
    rng = np.random.default_rng(2)
    heads, hd, bs, blocks = 2, 32, 4, 8
    jkv = JKV(num_layers=1, num_heads=heads, head_dim=hd, num_blocks=blocks,
              block_size=bs, dtype=f16)
    n_tok = blocks * bs
    layer = {kk: vv[0] for kk, vv in jax_init_cache(jkv).items()}
    layer = jax_write(layer, jkv,
                      jnp.asarray(rng.standard_normal((heads, n_tok, hd)),
                                  f16),
                      jnp.asarray(rng.standard_normal((heads, n_tok, hd)),
                                  f16),
                      jnp.asarray(np.tile(np.arange(blocks, dtype=np.int32),
                                          (n_tok, 1))),
                      jnp.asarray(np.arange(n_tok, dtype=np.int32)),
                      jnp.ones(n_tok, bool))
    tables = jnp.asarray(np.stack([np.arange(blocks)] * 2).astype(np.int32))
    ctx = jnp.asarray(np.array([13, 32], np.int32))
    q = jnp.asarray(rng.standard_normal((2, heads, hd)), f16)
    paged = jax_paged(q, layer, jkv, tables, ctx, use_pallas=True,
                      interpret=True)
    jcfg = JGPTConfig(vocab_size=64, max_seq=64, hidden=64, num_layers=1,
                      num_heads=heads, dtype=f16, fused_loss=False)
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    lp = {k: v[0] for k, v in params["layers"].items()}
    fused = fused_layer_decode(
        jnp.asarray(rng.standard_normal((2, 64)), f16), lp, layer, jcfg,
        jkv, tables, ctx)
    x = jnp.asarray(rng.standard_normal(32 * 256), f16)
    codes, scales = jq.quantize_blockwise(x, 256, use_pallas=True)
    back = jq.dequantize_blockwise(codes, scales, 256, use_pallas=True)
    assert paged.dtype == f16
    for name, out in (("paged", paged), ("fused", fused[0]),
                      ("codec", back), ("scales", scales)):
        assert bool(jnp.isfinite(out.astype(jnp.float32)).all()), name
    assert float(jnp.abs(back.astype(jnp.float32)
                         - x.astype(jnp.float32)).max()) < 0.05
    assert _paged_route(H, hd) == "paged_mma_fwd"
    assert _paged_route(H, 320) == "paged_wide_fwd"
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        _paged_route(torch.float64, hd)
    cfg = GPTConfig(vocab_size=64, max_seq=64, hidden=64, num_layers=1,
                    num_heads=heads, dtype=H)
    kv = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                       num_blocks=blocks, block_size=bs, dtype=H)
    # the fused layer's gate as a card sees it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert megakernel_refusal(cfg, kv, allow_interpret=False) is None
    # the quantize wrapper's type check takes fp16 (a CPU tensor is
    # refused for its device; the card tests launch it)
    assert H in ku.KERNEL_DTYPES
    with pytest.raises(ValueError, match="CUDA tensor"):
        pq.quantize_blocks(torch.zeros(8, 256, dtype=H))
