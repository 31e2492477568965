"""The port's ``comm.overlap`` (the decomposed collective matmuls on
point-to-point rings) and its overlap record against the JAX package's.

JAX's ops run inside ``jax.shard_map`` (the tp rings on a tp = W mesh of
the conftest's CPU devices, the FSDP-position ring on a dp-only mesh of W
of them), each rank's rows stacked on a leading axis, their gradients
from ``jax.vjp`` inside the mesh program under each rank's cotangent; the
port's in ``gloo`` groups of W spawned ranks (one spawn a world size).
W = 2 and 4, fp32, ``bidirectional`` gather rings too.

* Outputs and gradients equal JAX's (rtol 1e-5, atol 1e-6: the reduce
  rings sum in ring order, so do JAX's) and the monolithic forms computed
  in numpy (rtol 2e-5: another order of the same sums).
* ``matmul_all_reduce``'s output is replicated, so the port takes the
  whole cotangent on every rank (Megatron's row-parallel backward); JAX's
  ring output is rank-varying and its backward sums the ranks'
  cotangents: JAX gets each rank's share, the port their sum, and both
  give the same gradients.
* Each forward's hops, priced by ``collective_report``, equal JAX's
  ``*_wire_bytes`` model of the op; the wire models equal JAX's
  functions; every hop of a ring op has a product issued while it is in
  flight (``overlap_report``: all async pairs hidden), but
  ``matmul_all_reduce``'s broadcast leg, which has none (half its
  bytes exposed).
* JAX's ``tests/test_fsdp.py::test_matmul_param_gather_matches_monolithic``
  misses its ``assert_array_equal`` by 5.3e-5 under jax 0.9 here; the port
  holds the FSDP-position ring to JAX's op and to the monolithic form
  within the tolerances above instead.
"""

import functools

import numpy as np
import pytest

import jax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.comm import overlap as jov
from apex_tpu.parallel.mesh import build_mesh as jbuild_mesh
from apex_tpu_torch.comm import overlap as ov
from apex_tpu_torch.parallel.multiproc import spawn

import torch_tp_workers as workers

WORLDS = (2, 4)
RTOL, ATOL = 1e-5, 1e-6


def _cases(world):
    """name -> (op, axis, kwargs, x, k, dy), per-rank rows."""
    rng = np.random.default_rng(7 + world)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, s, h, n = 2, 2 * world, 16, 8
    cases = {}
    for bidir in (False, True):
        cases[f"ag{int(bidir)}"] = (
            "all_gather_matmul", "tp",
            dict(gather_axis=1, bidirectional=bidir),
            f32(world, b, s, h), f32(world, h, n),
            f32(world, b, s * world, n))
    cases["rs"] = ("matmul_reduce_scatter", "tp", dict(scatter_axis=1),
                   f32(world, b, s, h), f32(world, h, n),
                   f32(world, b, s // world, n))
    cases["ar"] = ("matmul_all_reduce", "tp", dict(scatter_axis=1),
                   f32(world, b, s, h), f32(world, h, n),
                   f32(world, b, s, n))
    for bidir in (False, True):
        cases[f"pg{int(bidir)}"] = (
            "matmul_param_gather", "dp", dict(bidirectional=bidir),
            f32(world, b, s, h), f32(world, h, n),
            f32(world, b, s, n * world))
    return cases


def _linear(world):
    rng = np.random.default_rng(30 + world)
    return (rng.standard_normal((world, 3, 16)).astype(np.float32),
            rng.standard_normal((16, 4 * world)).astype(np.float32),
            rng.standard_normal((world, 3, 4 * world)).astype(np.float32))


def _port_cases(world):
    """The port's inputs: matmul_all_reduce's replicated output takes the
    ranks' summed cotangent on every rank."""
    cases = dict(_cases(world))
    op, axis, kw, x, k, dy = cases["ar"]
    cases["ar"] = (op, axis, kw, x, k,
                   np.repeat(dy.sum(0, keepdims=True), world, 0))
    return cases


@functools.lru_cache(maxsize=None)
def _spawned(world):
    return spawn(workers.several, world, {
        "overlap": ("overlap", (_port_cases(world), _linear(world)))})


@functools.lru_cache(maxsize=None)
def _jax(world, name):
    op, axis, kw, x, k, dy = _cases(world)[name]
    devices = jax.devices()[:world] if axis == "dp" else None
    mesh = jbuild_mesh(tp=world if axis == "tp" else 1, devices=devices)
    fn = getattr(jov, op)

    def body(x, k, dy):
        y, vjp = jax.vjp(lambda x, k: fn(x, k, axis_name=axis, **kw), x[0],
                         k[0])
        dx, dk = vjp(dy[0])
        return y[None], dx[None], dk[None]

    spec = P(axis)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                          out_specs=(spec,) * 3))
    return [np.asarray(a) for a in f(x, k, dy)]


def _monolithic(world, name):
    """The op's meaning in numpy: (y, dx, dk) of every rank."""
    op, _, kw, x, k, dy = _port_cases(world)[name]
    W = world
    ys, dxs, dks = [], [], []
    if op == "all_gather_matmul":
        xg = np.concatenate(list(x), 1)
        s = x.shape[2]
        for r in range(W):
            ys.append(xg @ k[r])
            dks.append(np.einsum("bsh,bsn->hn", xg, dy[r]))
        full = sum(dy[j] @ k[j].T for j in range(W))
        dxs = [full[:, r * s:(r + 1) * s] for r in range(W)]
    elif op == "matmul_reduce_scatter":
        tot = sum(x[j] @ k[j] for j in range(W))
        s = tot.shape[1] // W
        dyg = np.concatenate(list(dy), 1)
        for r in range(W):
            ys.append(tot[:, r * s:(r + 1) * s])
            dxs.append(dyg @ k[r].T)
            dks.append(np.einsum("bsh,bsn->hn", x[r], dyg))
    elif op == "matmul_all_reduce":
        tot = sum(x[j] @ k[j] for j in range(W))
        for r in range(W):
            ys.append(tot)
            dxs.append(dy[r] @ k[r].T)
            dks.append(np.einsum("bsh,bsn->hn", x[r], dy[r]))
    else:
        wg = np.concatenate(list(k), -1)
        n = k.shape[-1]
        for r in range(W):
            ys.append(x[r] @ wg)
            dxs.append(dy[r] @ wg.T)
            dks.append(sum(np.einsum("bsh,bsn->hn", x[j],
                                     dy[j][..., r * n:(r + 1) * n])
                           for j in range(W)))
    return ys, dxs, dks


def _wire_model(world, name):
    op, _, kw, x, k, dy = _cases(world)[name]
    if op == "all_gather_matmul":
        return jov.all_gather_matmul_wire_bytes(x[0].size, 4, world)
    if op == "matmul_reduce_scatter":
        return jov.matmul_reduce_scatter_wire_bytes(dy[0].size, 4, world)
    if op == "matmul_all_reduce":
        return jov.matmul_all_reduce_wire_bytes(dy[0].size // world, 4,
                                                world)
    return jov.matmul_param_gather_wire_bytes(k[0].size, 4, world)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(world):
    assert not any(r["jax_loaded"] for r in _spawned(world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(_cases(2)))
def test_ring_matches_jax_and_the_monolithic_form(world, name):
    y, dx, dk = _jax(world, name)
    my, mdx, mdk = _monolithic(world, name)
    for rank, r in enumerate(_spawned(world)):
        got = r["overlap"][name]
        for key, want, mono in (("y", y, my), ("dx", dx, mdx),
                                ("dk", dk, mdk)):
            g = got[key].numpy()
            np.testing.assert_allclose(g, mono[rank], rtol=2e-5, atol=2e-5,
                                       err_msg=f"{name} {key} monolithic")
            np.testing.assert_allclose(g, want[rank], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {key} JAX")


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_backward_is_the_row_parallel_one(world):
    """JAX's rank r gets (Σ_j dy_j)·k_rᵀ from dy_r alone; the port's rank r
    the same from the summed cotangent it holds."""
    _, dx, dk = _jax(world, "ar")
    for rank, r in enumerate(_spawned(world)):
        got = r["overlap"]["ar"]
        np.testing.assert_allclose(got["dx"].numpy(), dx[rank], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["dk"].numpy(), dk[rank], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(_cases(2)))
def test_wire_bytes_agree_with_the_model_and_hops_hide(world, name):
    want = _wire_model(world, name)
    for r in _spawned(world):
        got = r["overlap"][name]
        assert got["fwd_wire"] == want
        assert got["fwd_counts"]["collective-permute"] == sum(
            op[2] for op in got["fwd_rings"])
        rep = got["report"]
        assert rep["async_pairs"] > 0
        total = sum(op[5] for op in got["rings"])
        if name == "ar":
            # the broadcast leg's hops have no product to hide behind
            assert rep["hidden_wire_bytes"] == rep["exposed_wire_bytes"]
            assert rep["hidden_wire_bytes"] + rep["exposed_wire_bytes"] \
                == total == want
            continue
        assert rep["async_hidden"] == rep["async_pairs"]
        assert rep["exposed_wire_bytes"] == 0.0
        assert rep["hidden_wire_bytes"] == total


def test_wire_models_equal_jax():
    for world in (1, 2, 3, 8):
        for elems, itemsize in ((10, 2), (4096, 4)):
            for name in ("all_gather_matmul_wire_bytes",
                         "matmul_reduce_scatter_wire_bytes",
                         "matmul_all_reduce_wire_bytes"):
                assert getattr(ov, name)(elems, itemsize, world) == \
                    getattr(jov, name)(elems, itemsize, world)
            for bwd in (False, True):
                assert ov.matmul_param_gather_wire_bytes(
                    elems, itemsize, world, bwd) == \
                    jov.matmul_param_gather_wire_bytes(elems, itemsize,
                                                       world, bwd)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_linear_bidirectional_matches_monolithic(world):
    """``FSDP(bidirectional=True).linear``: forward exact against the
    gathered weight; dx and this rank's dW shard of the dp-summed
    gradient within fp reorder."""
    x, w, dy = _linear(world)
    n = w.shape[1] // world
    dw = sum(x[j].T @ dy[j] for j in range(world))
    for rank, r in enumerate(_spawned(world)):
        y, dx, dws = (t.numpy() for t in r["overlap"]["fsdp_linear"])
        np.testing.assert_allclose(y, x[rank] @ w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dx, dy[rank] @ w.T, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(dws, dw[:, rank * n:(rank + 1) * n],
                                   rtol=2e-5, atol=2e-5)
