"""The port's ``transformer.tensor_parallel`` (the seven mappings, the
layers, the vocab-parallel cross-entropy, the data broadcast, the memory
buffers), ``lm_head_loss(axis_name="tp")`` and ``GradScaler``'s
model-parallel sync, against the JAX package's at W = 2 and 4 tp ranks.

JAX runs each inside ``jax.shard_map`` on a tp = W mesh of the conftest's
8 CPU devices; the port in ``gloo`` groups of W spawned ranks (one spawn
a world size for the whole file), numpy-seeded fp32 inputs.

* The mappings: each rank's output and input gradient under a per-rank
  output cotangent (the same on every rank where the output is replicated,
  the reduce and the gathers: JAX's gradient of a per-rank loss sums the
  ranks' losses, the port's counts one replicated loss once), JAX's from
  ``jax.grad`` inside the mesh program. rtol 1e-5.
* The layers: the column → row composition (plain and
  ``sequence_parallel``), the embedding and the cross-entropy against
  JAX's tp functions under ``shard_map`` differentiated from outside
  (global gradients; the port's shards compared with their slices).
  rtol 1e-5, atol 1e-6.
* ``lm_head_loss(axis_name="tp")``: the loss, dx (summed over tp by the
  copy mapping) and each rank's dw shard against JAX's under
  ``shard_map``, rtol 1e-5 / atol 1e-6 (the merged lse is the shards'
  logsumexp taken in another order).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.ops.lm_head_loss import lm_head_loss as jlm_head_loss
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu_torch.parallel.multiproc import spawn

import torch_tp_workers as workers

WORLDS = (2, 4)
RTOL, ATOL = 1e-5, 1e-6
# replicated outputs take one cotangent on every rank
REPLICATED_OUT = ("reduce_from_tensor_model_parallel_region",
                  "gather_from_tensor_model_parallel_region")
INVARIANT_IN = ("copy_to_tensor_model_parallel_region",
                "scatter_to_tensor_model_parallel_region",
                "scatter_to_sequence_parallel_region")


def _rng(world):
    return np.random.default_rng(100 + world)


def _mapping_cases(world):
    """name -> (per-rank inputs, per-rank output cotangents)."""
    rng = _rng(world)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, s, h = 2, 2 * world, 4 * world
    cases = {}
    for name, in_shape, out_shape in (
            ("copy_to_tensor_model_parallel_region", (b, h), (b, h)),
            ("reduce_from_tensor_model_parallel_region", (b, h), (b, h)),
            ("scatter_to_tensor_model_parallel_region", (b, h),
             (b, h // world)),
            ("gather_from_tensor_model_parallel_region", (b, 3),
             (b, 3 * world)),
            ("gather_from_sequence_parallel_region", (b, s, 5),
             (b, s * world, 5)),
            ("reduce_scatter_to_sequence_parallel_region", (b, s, 5),
             (b, s // world, 5)),
            ("scatter_to_sequence_parallel_region", (b, s, 5),
             (b, s // world, 5))):
        x = f32(world, *in_shape)
        if name in INVARIANT_IN:
            x = np.repeat(x[:1], world, 0)
        cot = f32(world, *out_shape)
        if name in REPLICATED_OUT:
            cot = np.repeat(cot[:1], world, 0)
        cases[name] = (x, cot)
    return cases


def _layer_inputs(world):
    rng = _rng(world)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, s, h, f, v = 2, 2 * world, 8, 4 * world, 8 * world
    return dict(
        x=f32(b, s, h), col_k=0.3 * f32(h, f), col_b=0.1 * f32(f),
        row_k=0.3 * f32(f, h), row_b=0.1 * f32(h), cot=f32(b, s, h),
        emb=f32(v, 6), ids=rng.integers(0, v, (b, s)),
        emb_cot=f32(b, s, 6), logits=f32(b, s, v),
        tgt=rng.integers(0, v, (b, s)))


def _lm_inputs(world):
    rng = _rng(world)
    n, h, v = 16, 128, 32 * world
    return (rng.standard_normal((n, h)).astype(np.float32),
            (0.1 * rng.standard_normal((v, h))).astype(np.float32),
            rng.integers(0, v, (n,)))


@functools.lru_cache(maxsize=None)
def _spawned(world):
    calls = {"mappings": ("mappings", (_mapping_cases(world),)),
             "layers": ("layers", tuple(_layer_inputs(world).values())),
             "lm": ("lm_head", (*_lm_inputs(world), "float32")),
             "scaler": ("grad_scaler", (world - 1,))}
    return spawn(workers.several, world, calls)


def _mesh(world):
    jps.destroy_model_parallel()
    return jps.initialize_model_parallel(tensor_model_parallel_size_=world)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(world):
    assert not any(r["jax_loaded"] for r in _spawned(world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(_mapping_cases(2)))
def test_mapping_forward_and_backward_match_jax(world, name):
    x, cot = _mapping_cases(world)[name]
    mesh = _mesh(world)
    fn = getattr(jtp, name)
    inv_in, inv_out = name in INVARIANT_IN, name in REPLICATED_OUT

    def body(xs, cs):
        xi = xs if inv_in else xs[0]
        ci = cs if inv_out else cs[0]
        g = jax.grad(lambda v: jnp.sum(fn(v) * ci))(xi)
        return fn(xi)[None], g[None]

    f = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=(P() if inv_in else P("tp"),
                                    P() if inv_out else P("tp")),
                          out_specs=(P("tp"), P("tp"))))
    y, g = (np.asarray(a) for a in f(x[0] if inv_in else x,
                                     cot[0] if inv_out else cot))
    jps.destroy_model_parallel()
    for rank, r in enumerate(_spawned(world)):
        py, pg = r["mappings"][name]
        _close(py.numpy(), y[rank], f"{name} y rank {rank}")
        _close(pg.numpy(), g[rank], f"{name} dx rank {rank}")


def _cols(a, rank, world, dim):
    n = a.shape[dim] // world
    return np.take(a, range(rank * n, (rank + 1) * n), axis=dim)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sp", [False, True])
def test_column_row_composition_matches_jax(world, sp):
    d = _layer_inputs(world)
    mesh = _mesh(world)
    seq = P(None, "tp", None) if sp else P()

    def body(x, ck, cb, rk, rb):
        h = jtp.column_parallel_linear(x, ck, cb, gather_output=False,
                                       sequence_parallel=sp)
        return jtp.row_parallel_linear(jnp.tanh(h), rk, rb,
                                       input_is_parallel=True,
                                       sequence_parallel=sp)

    f = shard_map(body, mesh=mesh,
                  in_specs=(seq, P(None, "tp"), P("tp"), P("tp", None), P()),
                  out_specs=seq)
    args = [jnp.asarray(d[k]) for k in ("x", "col_k", "col_b", "row_k",
                                        "row_b")]
    y, grads = jax.jit(lambda a, c: (lambda y_vjp: (
        y_vjp[0], y_vjp[1](c)))(jax.vjp(f, *a)))(args, jnp.asarray(d["cot"]))
    grads = [np.asarray(g) for g in grads]
    y = np.asarray(y)
    jps.destroy_model_parallel()
    for rank, r in enumerate(_spawned(world)):
        py, dx, dck, dcb, drk, drb = (t.numpy() for t in
                                      r["layers"][f"colrow_sp{int(sp)}"])
        cut = (lambda a, dim: _cols(a, rank, world, dim))
        _close(py, cut(y, 1) if sp else y, "y")
        _close(dx, cut(grads[0], 1) if sp else grads[0], "dx")
        _close(dck, cut(grads[1], 1), "d col kernel")
        _close(dcb, cut(grads[2], 0), "d col bias")
        _close(drk, cut(grads[3], 0), "d row kernel")
        _close(drb, grads[4], "d row bias")


@pytest.mark.parametrize("world", WORLDS)
def test_gather_output_and_scattered_row_input_match_dense(world):
    d = _layer_inputs(world)
    hidden = np.asarray(jnp.dot(d["x"], d["col_k"]) + d["col_b"])
    y = np.tanh(hidden) @ d["row_k"] + d["row_b"]
    for r in _spawned(world):
        _close(r["layers"]["col_gather"].numpy(), hidden, "gather_output")
        _close(r["layers"]["row_scatter"].numpy(), y, "row input scattered")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sp", [False, True])
def test_vocab_embedding_and_grad_match_jax(world, sp):
    d = _layer_inputs(world)
    mesh = _mesh(world)
    out_spec = P(None, "tp", None) if sp else P()
    f = shard_map(lambda ids, w: jtp.vocab_parallel_embedding(
        ids, w, sequence_parallel=sp), mesh=mesh,
        in_specs=(P(), P("tp", None)), out_specs=out_spec)
    e, (dw,) = jax.jit(lambda ids, w, c: (lambda y_vjp: (
        y_vjp[0], y_vjp[1](c)))(jax.vjp(lambda w: f(ids, w), w)))(
        jnp.asarray(d["ids"]), jnp.asarray(d["emb"]),
        jnp.asarray(d["emb_cot"]))
    jps.destroy_model_parallel()
    for rank, r in enumerate(_spawned(world)):
        pe, pdw = (t.numpy() for t in r["layers"][f"embed_sp{int(sp)}"])
        _close(pe, _cols(np.asarray(e), rank, world, 1) if sp
               else np.asarray(e), "embedding")
        _close(pdw, _cols(np.asarray(dw), rank, world, 0), "d table")


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_cross_entropy_matches_jax(world):
    d = _layer_inputs(world)
    mesh = _mesh(world)
    f = shard_map(jtp.vocab_parallel_cross_entropy, mesh=mesh,
                  in_specs=(P(None, None, "tp"), P()), out_specs=P())
    tgt = jnp.asarray(d["tgt"])
    loss, dl = jax.jit(lambda lg: (f(lg, tgt), jax.grad(
        lambda lg: jnp.mean(f(lg, tgt)))(lg)))(jnp.asarray(d["logits"]))
    loss, dl = np.asarray(loss), np.asarray(dl)
    jps.destroy_model_parallel()
    for rank, r in enumerate(_spawned(world)):
        pl, pdl = (t.numpy() for t in r["layers"]["xent"])
        _close(pl, loss, "loss")
        _close(pdl, _cols(dl, rank, world, 2), "d logits")


@pytest.mark.parametrize("world", WORLDS)
def test_modules_are_tp_invariant_and_helpers(world):
    """The modules' shards are slices of one master weight (torch.nn.init
    on a generator); the memory buffer hands out views of one budget; the
    data broadcast takes the first tp rank's members."""
    import torch

    gens = [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    masters = []
    for shape, g in (((8, 4 * world), gens[0]), ((4 * world, 8), gens[1])):
        m = torch.empty(shape)
        torch.nn.init.xavier_normal_(m, generator=g)
        masters.append(m.numpy())
    m = torch.empty(8 * world, 6)
    torch.nn.init.normal_(m, std=0.02, generator=gens[2])
    masters.append(m.numpy())
    for rank, r in enumerate(_spawned(world)):
        col, row, emb, dup = r["layers"]["modules"]
        np.testing.assert_array_equal(col.numpy(),
                                      _cols(masters[0], rank, world, 1))
        np.testing.assert_array_equal(row.numpy(),
                                      _cols(masters[1], rank, world, 0))
        np.testing.assert_array_equal(emb.numpy(),
                                      _cols(masters[2], rank, world, 0))
        assert dup == (rank == 0)
        shapes1, shapes2, used, overflow, total = r["layers"]["memory"]
        assert (shapes1, shapes2, used, total) == ((2, 3), (4,), 10, 6.0)
        assert "overflow" in overflow
        bc = r["layers"]["broadcast"]
        assert bc["a"].tolist() == [[0] * 3] * 2
        assert bc["b"].tolist() == [10] * 4


@pytest.mark.parametrize("world", WORLDS)
def test_lm_head_loss_vocab_parallel_matches_jax(world):
    x, w, t = _lm_inputs(world)
    mesh = _mesh(world)

    def body(x, w, t):
        x = jtp.copy_to_tensor_model_parallel_region(x)
        return jlm_head_loss(x, w, t, axis_name="tp", use_pallas=False)

    f = shard_map(body, mesh=mesh, in_specs=(P(), P("tp", None), P()),
                  out_specs=P())
    tj = jnp.asarray(t)
    loss, (dx, dw) = jax.jit(lambda x, w: (f(x, w, tj), jax.grad(
        lambda x, w: jnp.mean(f(x, w, tj)), argnums=(0, 1))(x, w)))(
        jnp.asarray(x), jnp.asarray(w))
    loss, dx, dw = np.asarray(loss), np.asarray(dx), np.asarray(dw)
    jps.destroy_model_parallel()
    for rank, r in enumerate(_spawned(world)):
        pl, pdx, pdw = (a.numpy() for a in r["lm"])
        _close(pl, loss, "loss")
        _close(pdx, dx, "dx")
        _close(pdw, _cols(dw, rank, world, 0), "dw shard")


@pytest.mark.parametrize("world", WORLDS)
def test_grad_scaler_skips_on_every_rank(world):
    """An inf on the last tp rank only: the synced flag is 1 on every rank
    under parallel_state's default axes and ``axis_names=("tp",)``, so
    every rank backs the scale off and skips; ``axis_names=()`` syncs
    nothing."""
    runs = _spawned(world)
    hit = runs[-1]["scaler"]["none"]        # the rank that saw the inf
    assert hit[0] == 1.0 and hit[2] == 1.0
    for rank, r in enumerate(runs):
        assert r["scaler"]["default"] == hit
        assert r["scaler"]["tp"] == hit
        if rank != world - 1:
            assert r["scaler"]["none"][0] == 0.0
            assert r["scaler"]["none"][2] == 0.0
