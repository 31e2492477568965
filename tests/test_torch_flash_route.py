"""The port's flash attention routes and its kernels' C interface, on the
CPU.

* JAX parity above head_dim 256 (the CUDA-core kernels' D = 512, 1024 and
  2048: 32-, 16- and 8-row tiles; above 2048 the wide kernels, the head
  dim in chunks of 2048 columns): the port's ``flash_attention`` goes
  through its flash autograd function (the kernels on the card, their
  plain versions here) and gives JAX's interpret-mode kernel's output and
  gradients, causal, full, with a T5 bias and at a tail length; the
  packed varlen path likewise.
* The route table (``ops.attention._flash_route``): bf16 with head_dim <=
  256 takes the tensor-core forward, dQ, dK/dV and d(bias)
  (``csrc/flash_mma.cu``); fp32 at any head_dim and bf16 above 256 the
  CUDA-core ones (``csrc/flash_attention.cu``); a head_dim that is not a
  positive multiple of 8 raises.
* The tensor-core d(bias)'s batch split: its chunk count
  (``_dbias_chunks``) and a plain emulation of the chunks' in-order sum;
  bf16 parity of the port's plain dQ and d(bias) with JAX's
  interpret-mode backward kernels.
* A static check of every ``extern "C"`` entry point in ``csrc/*.cu``
  against the ctypes table its wrapper loads it with: the same argument
  count, and ``c_void_p`` exactly where the C side takes a pointer (a
  pointer passed as a 32-bit int would be cut).

The kernels themselves run only on the card (``tests/test_torch_kernels_
cuda.py``, ``chip_smoke.py``).
"""

import ctypes
import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import attention_varlen as jvl
from apex_tpu.ops.attention import _fa_bwd, _fa_fwd
from apex_tpu.ops.attention import _pallas_ok as jax_pallas_ok
from apex_tpu.ops.attention import flash_attention as jax_flash

from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_varlen as port_varlen
from apex_tpu_torch.ops.attention import flash_attention


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# (a) JAX parity above head_dim 256


@pytest.mark.parametrize("sq,sk,d,causal,bias", [
    (64, 64, 264, True, False), (72, 136, 320, False, True),
    (128, 128, 512, True, True), (40, 40, 512, False, False),
    (200, 200, 320, True, False),
    # D = 1024 (16-row tiles) and D = 2048 (8-row tiles)
    (40, 40, 520, True, False), (24, 56, 1024, False, True),
    (48, 48, 1032, True, True), (32, 32, 2048, False, False),
    (24, 24, 2048, True, True),
    # above 2048: the wide kernels, two chunks (the second of 8 columns)
    # and two full ones
    (40, 40, 2056, True, False), (24, 72, 2056, False, True),
    (32, 32, 4096, True, True), (16, 48, 4096, False, False)])
def test_flash_head_dims_above_256_match_jax_kernel(monkeypatch, sq, sk, d,
                                                    causal, bias):
    """head_dim 264-4096, causal and full, with a bias and at tail lengths
    (not multiples of the kernels' 32-, 16- or 8-row tile): JAX's
    gate takes them, so does the port (one call of its flash autograd
    function), and o and every gradient, the bias's included, equal
    ``jax.vjp`` of JAX's interpret-mode kernel at one block per sequence:
    atol 2e-5 (o) and 1e-4 (grads), as the flash tests of
    ``test_torch_train.py``."""
    assert jax_pallas_ok(sq, sk, d, causal, allow_interpret=True)
    rng = np.random.default_rng(sq + sk + d)
    q, do = (rng.standard_normal((1, 2, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, sk, d)).astype(np.float32)
            for _ in range(2))
    b = rng.standard_normal((2, sq, sk)).astype(np.float32) if bias else None
    args = [q, k, v] + ([b] if bias else [])

    def jfn(q, k, v, *bb):
        return jax_flash(q, k, v, causal=causal, bias=bb[0] if bb else None,
                         use_pallas=True, block_q=sq, block_k=sk)

    o_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(do))
    calls = []
    real = port_attention.FlashAttention.apply

    def count(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(port_attention.FlashAttention, "apply", count)
    leaves = [_t(a).requires_grad_() for a in args]
    o = flash_attention(*leaves[:3], causal=causal,
                        bias=leaves[3] if bias else None)
    o.backward(_t(do))
    assert calls == [(2, sq, d)]
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=2e-5)
    for got, ref, name in zip(leaves, want, ("q", "k", "v", "bias")):
        np.testing.assert_allclose(_np(got.grad), np.asarray(ref),
                                   atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("d,causal", [(320, True), (512, False),
                                     (1024, True), (2048, False),
                                     (2056, True), (2056, False)])
def test_varlen_head_dims_above_256_match_jax_kernel(d, causal):
    """The packed varlen path at head_dim 320-2056 (the varlen kernels'
    D = 512, 1024 and 2048 on the card and above it the wide kernels,
    their plain versions here): o and q, k, v
    gradients of the port's ``flash_attention_varlen`` equal ``jax.vjp``
    of JAX's interpret-mode varlen kernel; atol 2e-5 (o), 1e-4 (grads).
    Two documents and a pad tail over 192 tokens."""
    rng = np.random.default_rng(d)
    s = 192
    seg = np.array([[0] * 70 + [1] * 90 + [-1] * 32], dtype=np.int32)
    q, k, v, do = (rng.standard_normal((1, 2, s, d)).astype(np.float32)
                   for _ in range(4))

    def jfn(q, k, v):
        return jvl.flash_attention_varlen(q, k, v, jnp.asarray(seg),
                                          causal=causal, use_pallas=True,
                                          interpret=True, block_q=64,
                                          block_k=64)

    o_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = port_varlen.flash_attention_varlen(*leaves, _t(seg), causal=causal)
    o.backward(_t(do))
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=2e-5)
    for got, ref, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(_np(got.grad), np.asarray(ref),
                                   atol=1e-4, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# (b) the route table


@pytest.mark.parametrize("d", [8, 40, 64, 128, 136, 192, 256])
def test_bf16_up_to_256_takes_the_tensor_cores(d):
    assert port_attention._flash_route(torch.bfloat16, d) == "tensor_core"
    assert port_attention._flash_route(torch.float32, d) == "cuda_core"


@pytest.mark.parametrize("d", [264, 320, 400, 512])
def test_head_dims_264_to_512_take_the_cuda_cores(d):
    for dtype in (torch.bfloat16, torch.float32):
        assert port_attention._flash_route(dtype, d) == "cuda_core"


@pytest.mark.parametrize("d", [520, 1024, 1032, 2048])
def test_head_dims_520_to_2048_take_the_cuda_cores(d):
    for dtype in (torch.bfloat16, torch.float32):
        assert port_attention._flash_route(dtype, d) == "cuda_core"


@pytest.mark.parametrize("d", [2056, 4096, 6144, 8200])
def test_head_dims_above_2048_take_the_cuda_cores(d):
    """Above 2048 the wide kernels (the head dim in chunks of 2048
    columns) run in both types: JAX's gate takes any d % 8 == 0."""
    assert jax_pallas_ok(64, 64, d, True, allow_interpret=True)
    for dtype in (torch.bfloat16, torch.float32):
        assert port_attention._flash_route(dtype, d) == "cuda_core"


@pytest.mark.parametrize("d", [36, 0, -8, 12])
def test_route_refuses_what_no_kernel_takes(d):
    with pytest.raises(ValueError,
                       match=f"head_dim {d} must be a positive multiple of 8"):
        port_attention._flash_route(torch.bfloat16, d)


def _entries_launched(monkeypatch, dtype, d, bias):
    """The C entries the four wrappers launch at this dtype and head dim
    (``_launch`` stubbed: nothing runs), with the ints each passes after
    is_bf16."""
    seen = []
    monkeypatch.setattr(port_attention, "_launch",
                        lambda entry, *a, extra=(): seen.append(
                            (entry, extra)))
    q = torch.zeros(2, 64, d, dtype=dtype)
    row = torch.zeros(2, 64, 1)
    b = torch.zeros(2, 64, 64) if bias else None
    port_attention.flash_attention_fwd(q, q, q, 0.1, True, bias=b)
    port_attention.flash_attention_bwd_dq(q, q, q, q, row, row, 0.1, True,
                                          bias=b)
    port_attention.flash_attention_bwd_dkv(q, q, q, q, row, row, 0.1, True,
                                           bias=b)
    if bias:
        port_attention.flash_attention_bwd_dbias(q, q, q, q, row, row, 0.1,
                                                 True, bias=b)
    return seen


@pytest.mark.parametrize("dtype,d,prefix", [
    (torch.bfloat16, 64, "flash_mma"), (torch.bfloat16, 256, "flash_mma"),
    (torch.bfloat16, 264, "flash_attention"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 512, "flash_attention"),
    (torch.bfloat16, 2048, "flash_attention"),
    (torch.bfloat16, 4096, "flash_attention"),
    (torch.float32, 2056, "flash_attention")])
@pytest.mark.parametrize("bias", [False, True])
def test_wrappers_launch_the_routed_entries(monkeypatch, dtype, d, prefix,
                                            bias):
    """Each wrapper launches the entry of its route, all four on one
    route (``flash_mma_*`` for bf16 up to 256, ``flash_attention_*``
    otherwise); the tensor-core d(bias) passes its batch chunk count (1
    here: one batch item); every entry launched is in the table of the
    library ``_launch`` loads it from (``flash_mma`` for the tensor-core
    ones)."""
    seen = _entries_launched(monkeypatch, dtype, d, bias)
    names = ["fwd", "bwd_dq", "bwd_dkv"] + (["bwd_dbias"] if bias else [])
    assert [e for e, _ in seen] == [f"{prefix}_{n}" for n in names]
    for entry, extra in seen:
        table = (port_attention._MMA_SIGNATURES
                 if entry.startswith("flash_mma")
                 else port_attention._SIGNATURES)
        assert entry in table
        assert extra == ((1,) if entry == "flash_mma_bwd_dbias" else ())


def test_the_tensor_core_source_is_built_with_the_others():
    assert "flash_mma" in ku.KERNEL_SOURCES
    assert (ku.CSRC_DIR / "flash_mma.cu").is_file()
    assert set(port_attention._MMA_SIGNATURES) == {
        "flash_mma_fwd", "flash_mma_bwd_dq", "flash_mma_bwd_dkv",
        "flash_mma_bwd_dbias"}


# ---------------------------------------------------------------------------
# (b') the tensor-core d(bias)'s batch split, and bf16 parity of the plain
# dQ and d(bias) with JAX's kernels


@pytest.mark.parametrize("heads,sq,sk,nb,want", [
    (8, 512, 512, 8, 1),      # T5-small's encoder: 512 tiles, no split
    (8, 128, 128, 8, 8),      # its decoder: 32 tiles, a chunk a batch item
    (8, 200, 328, 8, 2),      # tails: 192 tiles
    (8, 256, 256, 2, 2),      # capped by the batch
    (12, 1024, 1024, 8, 1),   # GPT-2's width with a bias
    (1, 64, 64, 3, 3)])
def test_dbias_chunks_fill_the_card(heads, sq, sk, nb, want):
    """Enough chunks that (output tiles x heads x chunks) reaches 264
    blocks, at most one a batch item; a function of the shape alone."""
    chunks = port_attention._dbias_chunks(heads, sq, sk, nb)
    assert chunks == want
    assert chunks == port_attention._dbias_chunks(heads, sq, sk, nb)
    tiles = heads * -(-sq // 64) * -(-sk // 64)
    assert 1 <= chunks <= nb
    assert chunks == nb or tiles * chunks >= 264


@pytest.mark.parametrize("nb,chunks", [(8, 8), (8, 3), (5, 2), (3, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_dbias_chunk_partials_merged_in_order_equal_the_one_pass_sum(
        nb, chunks, causal):
    """The tensor-core d(bias)'s batch split, emulated: chunk c sums items
    [c·nb // chunks, (c + 1)·nb // chunks) in order (the chunks cover the
    batch once, none empty), the partials added in chunk order; equal to
    the one-pass plain d(bias) within fp32 rounding (atol/rtol 1e-5: the
    sum runs in another order)."""
    bounds = [(c * nb // chunks, (c + 1) * nb // chunks)
              for c in range(chunks)]
    assert [b for b0, b1 in bounds for b in range(b0, b1)] == list(range(nb))
    assert all(b1 > b0 for b0, b1 in bounds)
    rng = np.random.default_rng(nb * 10 + chunks)
    heads, s, d = 2, 48, 16
    q, k, v, do = (_t(rng.standard_normal((nb * heads, s, d))
                      .astype(np.float32)) for _ in range(4))
    bias = _t(rng.standard_normal((heads, s, s)).astype(np.float32))
    args = (0.25, causal)
    o, lse = port_attention.flash_attention_fwd_reference(q, k, v, *args,
                                                          bias=bias)
    want = port_attention.flash_attention_bwd_dbias_reference(
        q, k, v, o, lse, do, *args, bias=bias)
    got = port_attention.flash_attention_bwd_dbias_chunked_reference(
        q, k, v, o, lse, do, *args, bias=bias, chunks=chunks)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,sq,sk,rate", [
    (False, 64, 64, 0.0), (True, 64, 64, 0.0), (False, 32, 96, 0.2),
    (True, 64, 64, 0.3)])
def test_bf16_plain_dq_and_dbias_match_jax_kernels(causal, sq, sk, rate):
    """bf16 inputs (what the tensor-core dQ and d(bias) take on the card):
    the port's plain dQ and d(bias) vs JAX's Pallas backward kernels
    (``_fa_bwd``, interpret mode, 32-row blocks) from the same o and lse,
    with a (heads, sq, sk) bias and the counter-hash dropout. dQ bf16
    within atol 1e-2 + rtol 2**-7 (both round ds to bf16 before its
    product, from fp32 sums in other orders: one rounding step apart at
    most); d(bias) fp32 within 2e-4 (no bf16 rounding of the summand, as
    the fp32 parity test holds it)."""
    rng = np.random.default_rng(sq + sk + int(causal))
    b, h, d = 2, 2, 32
    q, do = (rng.standard_normal((b * h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b * h, sk, d)).astype(np.float32)
            for _ in range(2))
    bias = (2.0 * rng.standard_normal((h, sq, sk))).astype(np.float32)
    scale, seed = 1 / np.sqrt(d), 77
    jseed = jnp.asarray([seed], jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jb = jnp.asarray(bias)
    o_j, lse_j = _fa_fwd(jq, jk, jv, scale, causal, 32, 32, True, rate,
                         jseed, bias=jb)
    want = _fa_bwd(jq, jk, jv, o_j, lse_j, jdo, scale, causal, 32, 32, True,
                   rate, jseed, bias=jb)
    t16 = lambda a: _t(np.asarray(jnp.asarray(a).astype(jnp.float32))) \
        .to(torch.bfloat16)
    args = (t16(jq), t16(jk), t16(jv), t16(o_j), _t(np.asarray(lse_j)),
            t16(jdo), scale, causal, rate, seed)
    dq = port_attention.flash_attention_bwd_reference(*args,
                                                      bias=_t(bias))[0]
    db = port_attention.flash_attention_bwd_dbias_reference(*args,
                                                            bias=_t(bias))
    assert dq.dtype == torch.bfloat16 and db.dtype == torch.float32
    want_dq = np.asarray(want[0].astype(jnp.float32))
    torch.testing.assert_close(dq.float(), _t(want_dq), atol=1e-2,
                               rtol=2 ** -7)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[3]), atol=2e-4)


# ---------------------------------------------------------------------------
# (c) the C entry points against their ctypes tables

# csrc/<source>.cu -> (module, table) that loads it
_TABLES = {
    "layer_norm": ("apex_tpu_torch.ops.layer_norm", "_SIGNATURES"),
    "paged_attention": ("apex_tpu_torch.serve.decode", "_SIGNATURES"),
    "paged_mma": ("apex_tpu_torch.serve.decode", "_MMA_SIGNATURES"),
    "flash_attention": ("apex_tpu_torch.ops.attention", "_SIGNATURES"),
    "flash_mma": ("apex_tpu_torch.ops.attention", "_MMA_SIGNATURES"),
    "flash_varlen": ("apex_tpu_torch.ops.attention_varlen", "_SIGNATURES"),
    "flash_varlen_mma": ("apex_tpu_torch.ops.attention_varlen",
                         "_MMA_SIGNATURES"),
    "lm_head_loss": ("apex_tpu_torch.ops.lm_head_loss", "_SIGNATURES"),
    "lm_head_mma": ("apex_tpu_torch.ops.lm_head_loss", "_MMA_SIGNATURES"),
    "fused_update": ("apex_tpu_torch.ops.fused_update", "_SIGNATURES"),
    "megakernel": ("apex_tpu_torch.serve.megakernel", "_SIGNATURES"),
    "quantize": ("apex_tpu_torch.comm.quantize", "_SIGNATURES"),
    "dropout": ("apex_tpu_torch.ops.dropout", "_SIGNATURES"),
}
_C_TYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_entries(path: pathlib.Path):
    """{name: [parameter types]} of the ``extern "C"`` functions of a
    source."""
    src = path.read_text()
    out = {}
    for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                         src):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = [re.sub(r"\s*\b\w+$", "", p) for p in params]
    return out


def test_every_source_has_a_table():
    assert set(_TABLES) == set(ku.KERNEL_SOURCES)
    assert {p.stem for p in ku.CSRC_DIR.glob("*.cu")} == set(_TABLES)


@pytest.mark.parametrize("source", sorted(_TABLES))
def test_c_entry_points_match_their_ctypes_signatures(source):
    module, attr = _TABLES[source]
    table = getattr(importlib.import_module(module), attr)
    entries = _c_entries(ku.CSRC_DIR / f"{source}.cu")
    assert set(table) <= set(entries), sorted(set(table) - set(entries))
    for name, argtypes in table.items():
        params = entries[name]
        assert len(argtypes) == len(params), (name, len(argtypes),
                                               len(params))
        for i, (c_type, py_type) in enumerate(zip(params, argtypes)):
            if "*" in c_type:
                assert py_type is ctypes.c_void_p, (name, i, c_type)
            else:
                assert py_type is _C_TYPES[c_type], (name, i, c_type,
                                                     py_type)
