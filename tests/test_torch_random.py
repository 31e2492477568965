"""apex_tpu_torch's threefry keys, draws and hidden dropout on the CPU,
against jax.random and apex_tpu.

Every comparison is bitwise: the port computes JAX's threefry-2x32 (with
``jax_threefry_partitionable``, JAX's default) in numpy on the host and in
torch int64 for tensors, and the dropout's plain version draws its mask
from the same bits (``ops/dropout.py``; the CUDA kernel is held against
the plain version on the card, ``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.transformer.tensor_parallel import random as jrandom
from apex_tpu.transformer.testing.standalone_gpt import (
    _hidden_dropout as jax_hidden_dropout)

from apex_tpu_torch.ops.dropout import (dropout_scale, hidden_dropout,
                                        hidden_dropout_reference)
from apex_tpu_torch.transformer.tensor_parallel import random as trandom

SEEDS = [0, 1, 42, -1, -7, 2 ** 31 - 1, -2 ** 31, 2 ** 32 + 5,
         2 ** 40 + 3, -2 ** 40, 2 ** 63 - 1, -2 ** 63]
SHAPES = [(), (7,), (3, 5, 8), (2, 64, 96)]


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    """``prng_key`` equals ``key_data(jax.random.key(seed))`` bitwise,
    negative and 64-bit seeds included (JAX wraps them to 32 bits)."""
    got = trandom.prng_key(seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, _key(seed))


def test_prng_key_refuses_seeds_past_int64_like_jax():
    for seed in (2 ** 64, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            jax.random.key(seed)
        with pytest.raises(OverflowError):
            trandom.prng_key(seed)


@pytest.mark.parametrize("seed", [0, 42, -5, 2 ** 40 + 3])
def test_fold_in_and_split_match_jax(seed):
    """``fold_in`` over data words up to 2**32 - 1 and ``split`` into 1-40
    keys, bitwise."""
    jk = jax.random.key(seed)
    k = _key(seed)
    for d in (0, 1, 7, 100, 101, 2718, 0x0E0B, 2 ** 31 + 3, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            trandom.fold_in(k, d),
            np.asarray(jax.random.key_data(jax.random.fold_in(jk, d))))
    for n in (1, 2, 3, 16, 17, 40):
        np.testing.assert_array_equal(
            trandom.split(k, n),
            np.asarray(jax.random.key_data(jax.random.split(jk, n))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 3, -9, 2 ** 33 + 1])
def test_bits_uniform_and_bernoulli_match_jax(seed, shape):
    """``random_bits``, fp32 ``uniform`` and ``bernoulli`` (p = 0.9, 0.8,
    0.5 and one that is no short binary fraction) bitwise JAX's; the
    dropout's integer threshold gives the same mask; the torch int64 draw
    gives the same bits."""
    jk, k = jax.random.key(seed), _key(seed)
    bits = trandom.random_bits(k, shape)
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    got_u = trandom.uniform(k, shape)
    assert got_u.dtype == np.float32 and got_u.shape == shape
    np.testing.assert_array_equal(got_u,
                                  np.asarray(jax.random.uniform(jk, shape)))
    for p in (0.9, 0.8, 0.5, 0.123456789):
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        np.testing.assert_array_equal(trandom.bernoulli(k, p, shape), want)
        np.testing.assert_array_equal(
            (bits >> 9) < trandom.keep_threshold(p), want)
    n = int(np.prod(shape))
    np.testing.assert_array_equal(
        trandom.random_bits_tensor(k, n).numpy().astype(np.uint32),
        bits.reshape(-1))


def test_random_bits_counter_high_word():
    """Past 2**32 elements the counter's high word is the flat index's upper
    bits: the int64 draw at indices 2**32 - 2 .. 2**32 + 1 equals the
    Python-int threefry2x32 at (hi, lo) of each index, as JAX's
    ``iota_2x32_shape`` splits it (both are held to JAX's bits above; the
    kernel past 2**32 elements is held on the card)."""
    k = _key(11)
    idx = torch.tensor([2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 1])
    b0, b1 = trandom.threefry2x32(k, idx >> 32, idx & trandom.M32)
    for i, j in enumerate(idx.tolist()):
        w0, w1 = trandom.threefry2x32(k, j >> 32, j & trandom.M32)
        assert int(b0[i] ^ b1[i]) == w0 ^ w1


@pytest.mark.parametrize("seed", [0, 7, -5, 2 ** 35])
@pytest.mark.parametrize("rank", [0, 1])
def test_attention_dropout_seed_and_model_parallel_key_match_jax(seed, rank):
    """``attention_dropout_seed`` (a signed int32) and
    ``model_parallel_key`` equal JAX's inside a mesh program, where JAX
    folds ``lax.axis_index(tp)``: rank 0 at tp = 1, both ranks at tp = 2."""
    tp = rank + 1
    mesh = build_mesh(tp=tp, pp=1, sp=1, devices=jax.devices()[:tp])

    def body(k):
        s = jrandom.attention_dropout_seed(k)[None]
        mk = jax.random.key_data(jrandom.model_parallel_key(k))[None]
        return s, mk

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(),
                              out_specs=(P("tp"), P("tp")), check_vma=False))
    seeds, keys = f(jax.random.key(seed))
    k = _key(seed)
    assert trandom.attention_dropout_seed(k, rank) == int(seeds[rank])
    assert -2 ** 31 <= trandom.attention_dropout_seed(k, rank) < 2 ** 31
    np.testing.assert_array_equal(trandom.model_parallel_key(k, rank),
                                  np.asarray(keys[rank]))
    np.testing.assert_array_equal(trandom.data_parallel_key(k), k)


def test_tracker_key_sequence_matches_jax():
    """After ``model_parallel_seed`` both trackers hand out the same key
    sequence on both streams, a restored state replays it, and the
    reference's errors are raised."""
    jrandom.model_parallel_seed(123)
    states = trandom.model_parallel_seed(123)
    jt, tt = jrandom.get_rng_tracker(), trandom.get_cuda_rng_tracker()
    assert tt is trandom.get_rng_tracker()
    seq = []
    for name in ("default", "model-parallel-rng", "model-parallel-rng"):
        want = np.asarray(jax.random.key_data(jt.key(name)))
        got = tt.key(name)
        np.testing.assert_array_equal(got, want)
        seq.append(got)
    with tt.fork() as k:
        np.testing.assert_array_equal(
            k, np.asarray(jax.random.key_data(jt.key("model-parallel-rng"))))
    tt.set_states(states)
    np.testing.assert_array_equal(tt.key("default"), seq[0])
    with pytest.raises(RuntimeError, match="already exists"):
        tt.add("default", 5)
    with pytest.raises(RuntimeError, match="not added"):
        tt.key("nope")
    tt.add("mine", 9)
    np.testing.assert_array_equal(tt.key("mine"),
                                  trandom.fold_in(trandom.prng_key(9), 0))
    with pytest.raises(RuntimeError, match="seed 9 already exists"):
        tt.add("again", 9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5, 0.3333])
@pytest.mark.parametrize("shape", [(3, 5, 8), (2, 64, 96), (1001,)])
def test_hidden_dropout_and_vjp_match_jax(dtype, rate, shape):
    """``hidden_dropout`` forward and backward bitwise JAX's
    ``_hidden_dropout`` and its vjp, fp32 and bf16 (the bf16 scale rounded
    once to bf16, as JAX's weakly typed scalar); an odd element count
    included."""
    rng = np.random.default_rng(len(shape) + int(rate * 100))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jk = jax.random.key(17)
    y_j, vjp = jax.vjp(lambda a: jax_hidden_dropout(a, rate, jk),
                       jnp.asarray(x, jdt))
    (dx_j,) = vjp(jnp.asarray(dy, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    y = hidden_dropout(tx, rate, _key(17))
    y.backward(torch.from_numpy(dy).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt
    for got, want in ((y, y_j), (tx.grad, dx_j)):
        np.testing.assert_array_equal(
            got.detach().float().numpy().view(np.uint32),
            np.asarray(want.astype(jnp.float32)).view(np.uint32))
    scale = float((jnp.ones((), jdt) * (1.0 / (1.0 - rate))).astype(
        jnp.float32))
    assert dropout_scale(rate, tdt) == scale
    keep = y.detach() != 0
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.1


def test_hidden_dropout_is_a_function_of_key_and_index():
    """The same key gives the same mask on any input (so the backward and a
    remat replay drop the same elements); another key another mask; rate
    outside [0, 1) raises."""
    x = torch.ones(4, 33)
    a = hidden_dropout_reference(x, 0.3, _key(1))
    assert torch.equal(a, hidden_dropout_reference(2 * x, 0.3, _key(1)) / 2)
    assert not torch.equal(a, hidden_dropout_reference(x, 0.3, _key(2)))
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            hidden_dropout(x, rate, _key(1))
