"""The port's ``transformer.sequence_parallel`` (ring and Ulysses
attention) against the JAX package's, and the flash kernels' dropout
offsets (C7).

Ring / Ulysses: JAX's ``ring_attention`` / ``ulysses_attention`` run
inside ``jax.shard_map`` over an sp = W mesh of the conftest's CPU
devices (q, k, v, the cotangent and the bias strip split along the
sequence), differentiated with ``jax.vjp`` inside the mesh program; the
port's on W ``gloo`` ranks (one spawn a world size). W = 2 and 4, fp32,
(b, h, S, d) = (2, 4, 16·W, 16): the chunked-flash ring causal and not,
with the T5-style bias strip, with dropout under a seed (the kernels'
counter hash at each chunk's global offsets, so it equals JAX's bit for
bit in its mask), the einsum scan, and Ulysses with and without dropout
(the sp rank folded into the seed by ``fold_seed``). Outputs and the
q / k / v / strip gradients within rtol 1e-5, atol 2e-6 of JAX's, and the
ring within the same of the dense ``flash_attention`` of the gathered
sequence (the port's own), dropout included.

C8: the einsum scan's per-step remat (``remat_steps``, JAX's
``jax.checkpoint`` of a step): bitwise the same outputs and gradients,
no (s, s) tensor saved, and a rank's saved bytes at sp 4 at most 1/sp of
the one-rank scan's (JAX's ``tests/test_ring_memory.py`` claim).

C7: the port's plain flash forward, dQ, dK/dV and d(bias) with ``(seed,
q_off, k_off)`` against JAX's Pallas kernels in interpret mode
(``_fa_fwd`` / ``_fa_bwd`` with ``seed=[seed, q_off, k_off]``) at 32-row
blocks, and offsets 0 giving the earlier bits and launch arguments.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.ops.attention import _fa_bwd, _fa_fwd
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.sequence_parallel import (
    ring_attention as jring,
    ulysses_attention as julysses,
)
from apex_tpu_torch.ops import attention as pa
from apex_tpu_torch.parallel.multiproc import spawn

import torch_tp_workers as workers

WORLDS = (2, 4)
RTOL, ATOL = 1e-5, 2e-6
SEED = 1234
CASES = {
    "auto_causal": dict(causal=True),
    "auto_full": dict(causal=False),
    "auto_bias": dict(causal=False, bias=True),
    "auto_bias_causal": dict(causal=True, bias=True),
    "auto_dropout": dict(causal=True, dropout_rate=0.2, dropout_seed=SEED),
    "auto_bias_dropout": dict(causal=False, bias=True, dropout_rate=0.2,
                              dropout_seed=SEED),
    "scan_causal": dict(causal=True, impl="scan"),
    "scan_full": dict(causal=False, impl="scan"),
    "ulysses_causal": dict(causal=True, ulysses=True),
    "ulysses_dropout": dict(causal=True, ulysses=True, dropout_rate=0.2,
                            dropout_seed=SEED),
}


def _inputs(world):
    rng = np.random.default_rng(50 + world)
    b, h, s, d = 2, 4, 16 * world, 16
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f32(b, h, s, d), f32(b, h, s, d), f32(b, h, s, d), \
        f32(b, h, s, d), 0.5 * f32(h, s, s)


def _long_inputs():
    """C8's memory shapes: a long sequence over narrow heads, so the (S, S)
    scores dominate what attention saves."""
    rng = np.random.default_rng(7)
    return tuple(rng.standard_normal((1, 2, 256, 8)).astype(np.float32)
                 for _ in range(3))


@functools.lru_cache(maxsize=None)
def _spawned(world):
    q, k, v, do, bias = _inputs(world)
    return spawn(workers.several, world, {
        "ring": ("ring", (q, k, v, do, bias, SEED, CASES)),
        "remat": ("ring_remat", (q, k, v, do, _long_inputs()))})


@functools.lru_cache(maxsize=None)
def _jax(world, name):
    q, k, v, do, bias = _inputs(world)
    kw = dict(CASES[name])
    has_bias = kw.pop("bias", False)
    ulysses = kw.pop("ulysses", False)
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(sequence_parallel_size_=world)
    seq = P(None, None, "sp", None)

    def body(q, k, v, do, strip):
        def f(q, k, v, strip):
            if ulysses:
                return julysses(q, k, v, **kw)
            return jring(q, k, v, bias_strip=strip if has_bias else None,
                         **kw)

        o, vjp = jax.vjp(f, q, k, v, strip)
        return (o,) + vjp(do)

    f = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=(seq,) * 4 + (P(None, "sp", None),),
                          out_specs=(seq,) * 4 + (P(None, "sp", None),)))
    out = [np.asarray(a) for a in f(q, k, v, do, bias)]
    jps.destroy_model_parallel()
    return out


def _shard(a, rank, world, axis):
    n = a.shape[axis] // world
    return np.take(a, range(rank * n, (rank + 1) * n), axis=axis)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(world):
    assert not any(r["jax_loaded"] for r in _spawned(world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring_and_ulysses_match_jax(world, name):
    want = _jax(world, name)
    has_bias = CASES[name].get("bias", False)
    for rank, r in enumerate(_spawned(world)):
        got = r["ring"][name]
        for i, what in enumerate(("o", "dq", "dk", "dv")):
            np.testing.assert_allclose(
                got[i].numpy(), _shard(want[i], rank, world, 2), rtol=RTOL,
                atol=ATOL, err_msg=f"{name} {what} rank {rank}")
        if has_bias:
            np.testing.assert_allclose(
                got[4].numpy(), _shard(want[4], rank, world, 1), rtol=RTOL,
                atol=ATOL, err_msg=f"{name} d(strip) rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["auto_causal", "auto_bias_dropout",
                                  "auto_dropout"])
def test_ring_equals_the_dense_call(world, name):
    """The ring's shards are the dense ``flash_attention``'s slices, with
    the same seed's mask: dropout does not see the sharding."""
    q, k, v, do, bias = (torch.from_numpy(a) for a in _inputs(world))
    kw = dict(CASES[name])
    has_bias = kw.pop("bias", False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    b = bias.clone().requires_grad_() if has_bias else None
    o = pa.flash_attention(*leaves, bias=b, **kw)
    grads = torch.autograd.grad(o, leaves + ([b] if has_bias else []), do)
    for rank, r in enumerate(_spawned(world)):
        got = r["ring"][name]
        for g, w, axis in zip(got, (o,) + grads, (2, 2, 2, 2, 1)):
            np.testing.assert_allclose(
                g.numpy(), _shard(w.detach().numpy(), rank, world, axis),
                rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [True, False])
def test_c8_remat_steps_is_bitwise(world, causal):
    """C8: ``remat_steps=True`` recomputes each step of the einsum scan
    in backward: output and q / k / v gradients bitwise those of
    ``remat_steps=False``."""
    for rank, r in enumerate(_spawned(world)):
        on, off = r["remat"][(causal, True)], r["remat"][(causal, False)]
        for a, b, what in zip(on, off, ("o", "dq", "dk", "dv")):
            assert torch.equal(a, b), f"{what} rank {rank}"


@pytest.mark.parametrize("world", WORLDS)
def test_c8_remat_steps_keeps_no_scores(world):
    """With ``remat_steps=True`` no saved tensor ends in the (s, s) of a
    step's scores (s the local sequence, 256 / sp tokens over heads of 8),
    which ``False`` keeps."""
    s = _long_inputs()[0].shape[2] // world
    for rank, r in enumerate(_spawned(world)):
        shapes_on = r["remat"][("long", True)][2]
        shapes_off = r["remat"][("long", False)][2]
        assert not any(sh[-2:] == (s, s) for sh in shapes_on), shapes_on
        assert any(sh[-2:] == (s, s) for sh in shapes_off), shapes_off


def test_c8_ring_divides_the_saved_scores_by_sp():
    """JAX's ``tests/test_ring_memory.py`` claim, per rank at sp 4 on a
    256-token sequence: without per-step remat each rank saves exactly
    1/sp of the (S, S)-tailed bytes the one-rank scan saves (sp steps of
    (S/sp)² scores); with it (the default) a rank's whole saved footprint
    is at most 1/sp of the one-rank scan's."""
    from apex_tpu_torch.transformer.sequence_parallel import ring_attention

    world = 4
    leaves = [torch.from_numpy(a).requires_grad_() for a in _long_inputs()]
    _, total_1, square_1, _ = workers.saved_bytes(
        ring_attention, *leaves, causal=True, impl="scan",
        remat_steps=False)
    for rank, r in enumerate(_spawned(world)):
        total_on, square_on, _ = r["remat"][("long", True)]
        total_off, square_off, _ = r["remat"][("long", False)]
        assert square_off * world == square_1, (rank, square_off, square_1)
        assert square_on == 0
        assert total_on * world <= total_1, (rank, total_on, total_1)


def test_ring_refusals_and_one_rank():
    """JAX's refusals; with no mesh (one sp rank) the ring is the dense
    call and Ulysses the identity re-shard."""
    from apex_tpu_torch.transformer.sequence_parallel import (
        ring_attention,
        ulysses_attention,
    )

    q = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="dropout_seed"):
        ring_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="bias_strip"):
        ring_attention(q, q, q, impl="scan",
                       bias_strip=torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="bias_strip must be"):
        ring_attention(q, q, q, bias_strip=torch.zeros(2, 8, 9))
    o = ring_attention(q + 1, q, q, causal=True)
    np.testing.assert_allclose(
        o.numpy(), pa.flash_attention(q + 1, q, q, causal=True).numpy(),
        rtol=1e-6, atol=1e-7)
    assert ulysses_attention(q, q, q).shape == q.shape


# ---------------------------------------------------------------------------
# C7: the kernels' [seed, q_off, k_off]


def _c7_inputs(sq, sk):
    rng = np.random.default_rng(9)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f32(4, sq, 16), f32(4, sk, 16), f32(4, sk, 16), f32(4, sq, 16),
            f32(2, sq, sk))


@pytest.mark.parametrize("causal,sq,sk,q_off,k_off", [
    (True, 32, 32, 64, 64),        # a diagonal ring chunk
    (False, 32, 32, 96, 32),       # a full chunk below the diagonal
    (False, 32, 64, 1 << 31, 5)])  # rectangular, offsets past int32
def test_c7_plain_flash_with_offsets_matches_jax_kernels(causal, sq, sk,
                                                         q_off, k_off):
    """The plain forward, dQ, dK/dV and d(bias) with ``(seed, q_off,
    k_off)`` against JAX's interpret-mode Pallas kernels given the SMEM
    triple ``[seed, q_off, k_off]``: o and lse atol 2e-5 / 1e-5, the
    gradients atol 1e-4, d(bias) 2e-4 (``tests/test_torch_t5.py``'s
    tolerances); and the offsets change the mask."""
    q, k, v, do, bias = _c7_inputs(sq, sk)
    scale, rate = 1 / np.sqrt(16), 0.3
    triple = np.array([SEED, q_off, k_off], np.uint32).view(np.int32)
    jq, jk, jv, jdo, jb = (jnp.asarray(a) for a in (q, k, v, do, bias))
    o_j, lse_j = _fa_fwd(jq, jk, jv, scale, causal, 32, 32, True, rate,
                         jnp.asarray(triple), bias=jb)
    want = _fa_bwd(jq, jk, jv, o_j, lse_j, jdo, scale, causal, 32, 32, True,
                   rate, jnp.asarray(triple), bias=jb)
    t = torch.from_numpy
    offs = dict(q_off=q_off, k_off=k_off)
    o, lse = pa.flash_attention_fwd_reference(
        t(q), t(k), t(v), scale, causal, rate, SEED, bias=t(bias), **offs)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5)
    args = (t(q), t(k), t(v), t(np.array(o_j)), t(np.array(lse_j)),
            t(do), scale, causal, rate, SEED)
    got = pa.flash_attention_bwd_reference(*args, bias=t(bias), **offs)
    db = pa.flash_attention_bwd_dbias_reference(*args, bias=t(bias), **offs)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=what)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[3]), atol=2e-4)
    o0, _ = pa.flash_attention_fwd_reference(t(q), t(k), t(v), scale,
                                             causal, rate, SEED,
                                             bias=t(bias))
    assert not torch.equal(o0, o)


def test_c7_offsets_zero_keep_the_earlier_bits():
    """Offsets 0 are the whole-sequence call: the plain versions' results
    and masks are bitwise those without offsets, and the C entries get the
    earlier dropout arguments followed by two zeros."""
    q, k, v, do, bias = (torch.from_numpy(a) for a in _c7_inputs(32, 32))
    args = (q, k, v, 0.25, True, 0.2, SEED)
    for a, b in zip(pa.flash_attention_fwd_reference(*args, bias=bias),
                    pa.flash_attention_fwd_reference(*args, bias=bias,
                                                     q_off=0, k_off=0)):
        assert torch.equal(a, b)
    o, lse = pa.flash_attention_fwd_reference(*args)
    bwd = (q, k, v, o, lse, do, 0.25, True, 0.2, SEED)
    for a, b in zip(pa.flash_attention_bwd_reference(*bwd),
                    pa.flash_attention_bwd_reference(*bwd, q_off=0,
                                                     k_off=0)):
        assert torch.equal(a, b)
    assert torch.equal(pa.attention_dropout_mask(SEED, 0.2, 4, 32, 32),
                       pa.attention_dropout_mask(SEED, 0.2, 4, 32, 32, 0, 0))
    on, seed, thresh, inv, q0, k0 = pa._dropout_args(0.2, SEED)
    assert (on, seed, q0, k0) == (1, SEED, 0, 0)
    assert pa._dropout_args(0.2, (SEED, 0, 0)) == (on, seed, thresh, inv,
                                                    0, 0)
    assert pa._dropout_args(0.0, (SEED, 7, 9)) == (0, 0, 0, 1.0, 0, 0)
    # every flash entry's ctypes table carries the offsets after inv_keep
    assert pa._FLASH_ARGS[10:13] == [pa.ctypes.c_float, pa.ctypes.c_uint,
                                     pa.ctypes.c_uint]


def test_c7_chunk_masks_tile_the_dense_mask():
    """A ring chunk's mask at offsets (i·s, j·s) is the (i, j) block of the
    dense mask: the property that makes the ring drop the dense call's
    entries."""
    full = pa.attention_dropout_mask(SEED, 0.3, 2, 64, 64)
    for i in range(4):
        for j in range(4):
            chunk = pa.attention_dropout_mask(SEED, 0.3, 2, 16, 16, 16 * i,
                                              16 * j)
            assert torch.equal(chunk, full[:, 16 * i:16 * i + 16,
                                           16 * j:16 * j + 16])
