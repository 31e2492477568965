"""SyncBatchNorm across ranks, ``contrib.groupbn`` and
``contrib.bottleneck``'s halo exchange, the port against the JAX package.

The port runs in 4 spawned ``gloo`` ranks (``torch_dist_workers``,
which imports no JAX); JAX on the first 4 of the conftest's 8 CPU
devices (``shard_map``, ``check_vma=False``): a dp-only mesh for the
norms, an sp-only one for the split conv. The same numpy NHWC batches go
to both; each rank's own batch, scale and bias gradients are compared
(JAX's parameters enter per device, so its gradients are the rank's own,
with the statistics' cross-device terms through the psum).

Tolerances (fp32): statistics, outputs and running statistics within
1e-5 (atol) + 1e-5 (rtol); gradients within 1e-4 of the leaf's largest
|value| (the ranks' sums in another order, divided by a batch's std);
the split conv within 1e-5 of JAX's and of the unsplit convolution.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.contrib.bottleneck import spatial_conv3x3 as jspatial
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBatchNorm2d_NHWC
from apex_tpu.parallel.mesh import build_mesh as jbuild_mesh
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JSyncBN
from apex_tpu.parallel.sync_batchnorm import (
    create_syncbn_process_group as jgroups,
    sync_batch_stats as jstats,
)

from apex_tpu_torch.parallel.multiproc import spawn

import torch_dist_workers as workers

W, GROUP, MOMENTUM = 4, 2, 0.1
B, H, WD, C = 2, 4, 5, 8


def _inputs():
    rng = np.random.default_rng(9)
    xs = (rng.standard_normal((W, B, H, WD, C)) * 1.5 + 0.3).astype(
        np.float32)
    xs += np.arange(W, dtype=np.float32)[:, None, None, None, None]
    cots = rng.standard_normal(xs.shape).astype(np.float32)
    scale = np.linspace(0.5, 1.5, C, dtype=np.float32)
    bias = np.linspace(-0.2, 0.3, C, dtype=np.float32)
    return xs, cots, scale, bias


@functools.lru_cache(maxsize=None)
def _port():
    xs, cots, scale, bias = _inputs()
    return spawn(workers.syncbn, W, xs, cots, GROUP, MOMENTUM, scale, bias)


def _dp_mesh():
    return jbuild_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:W])


def _per_device(fn, *stacked):
    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda o: o[None], out)

    return jax.tree_util.tree_map(np.asarray, jax.jit(shard_map(
        body, mesh=_dp_mesh(), in_specs=tuple(P("dp") for _ in stacked),
        out_specs=P("dp"), check_vma=False))(*stacked))


def _groups(label):
    return None if label == "whole" else jgroups(GROUP, W)


@functools.lru_cache(maxsize=None)
def _jax_module(label):
    """JAX's SyncBatchNorm: two training calls (x, then 2x + 1) threading
    batch_stats, d/d(x, scale, bias) of Σ y·cot + Σ y2·cot, then eval."""
    xs, cots, scale, bias = _inputs()
    bn = JSyncBN(momentum=MOMENTUM, axis_index_groups=_groups(label))
    stats0 = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def dev(x, cot, s, b):
        def loss(x, s, b):
            params = {"scale": s, "bias": b}
            y, u = bn.apply({"params": params, "batch_stats": stats0}, x,
                            mutable=["batch_stats"])
            y2, u2 = bn.apply({"params": params, **u}, x * 2.0 + 1.0,
                              mutable=["batch_stats"])
            return jnp.sum(y * cot) + jnp.sum(y2 * cot), (y, y2, u2)

        (_, (y, y2, u2)), (gx, gs, gb) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(x, s, b)
        ev = bn.apply({"params": {"scale": s, "bias": b}, **u2}, x,
                      use_running_average=True)
        st = u2["batch_stats"]
        return {"y": y, "y2": y2, "mean": st["mean"], "var": st["var"],
                "gx": gx, "gscale": gs, "gbias": gb, "eval": ev}

    rep = lambda a: np.broadcast_to(a, (W,) + a.shape).copy()  # noqa: E731
    return _per_device(dev, xs, cots, rep(scale), rep(bias))


def _close(got, want, atol=1e-5, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _grad_close(got, want, what=""):
    tol = 1e-4 * max(float(np.abs(want).max()), 1e-12)
    _close(got, want, atol=tol, rtol=1e-4, what=what)


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _port())


@pytest.mark.parametrize("label", ["whole", "grouped"])
def test_sync_batch_stats_match_jax(label):
    """``sync_batch_stats`` over the 4 ranks (whole, and in groups of 2
    summed in rank order): each rank's mean, var and count are JAX's."""
    xs = _inputs()[0]
    want = _per_device(lambda x: jstats(x, (0, 1, 2), "dp", _groups(label)),
                       xs)
    for r, p in enumerate(_port()):
        for got, w, name in zip(p[("stats", label)], want,
                                ("mean", "var", "count")):
            _close(got.numpy(), w[r], what=f"{label} {name} rank {r}")


@pytest.mark.parametrize("label", ["whole", "grouped"])
def test_grouped_statistics_are_the_groups(label):
    """The group's ranks share their statistics and the groups differ
    (each rank's batch is offset by its rank)."""
    means = [p[("stats", label)][0].numpy() for p in _port()]
    if label == "whole":
        assert all((m == means[0]).all() for m in means)
    else:
        assert (means[0] == means[1]).all() and (means[2] == means[3]).all()
        assert not np.allclose(means[0], means[2])


@pytest.mark.parametrize("label", ["whole", "grouped"])
@pytest.mark.parametrize("what", ["y", "y2", "mean", "var", "eval"])
def test_sync_batchnorm_forward_and_running_stats_match_jax(label, what):
    """The two training outputs, the running mean and unbiased running
    var after both calls, and the eval output, rank by rank."""
    want = _jax_module(label)[what]
    for r, p in enumerate(_port()):
        _close(p[("module", label)][what].numpy(), want[r],
               what=f"{label} {what} rank {r}")


@pytest.mark.parametrize("label", ["whole", "grouped"])
@pytest.mark.parametrize("what", ["gx", "gscale", "gbias"])
def test_sync_batchnorm_backward_matches_jax(label, what):
    """The gradients of the input, scale and bias through the all-reduce
    (its autograd rule: JAX's transpose of psum, or of the grouped
    all-gather) on every rank."""
    want = _jax_module(label)[what]
    for r, p in enumerate(_port()):
        _grad_close(p[("module", label)][what].numpy(), want[r],
                    what=f"{label} {what} rank {r}")


def test_groupbn_matches_jax():
    """``BatchNorm2d_NHWC(bn_group=2, fuse_relu=True)``: the groups, the
    forward and the input gradient are JAX's (``world_size`` 4)."""
    xs, cots, _, _ = _inputs()
    jbn = JBatchNorm2d_NHWC(C, fuse_relu=True, bn_group=GROUP, world_size=W)

    def dev(x, cot):
        v = jbn.init(jax.random.PRNGKey(0), x)

        def loss(x):
            y, _ = jbn.apply(v, x, mutable=["batch_stats"])
            return jnp.sum(y * cot), y

        (_, y), gx = jax.value_and_grad(loss, has_aux=True)(x)
        return {"y": y, "gx": gx}

    want = _per_device(dev, xs, cots)
    for r, p in enumerate(_port()):
        assert p["groupbn"]["groups"] == jgroups(GROUP, W)
        _close(p["groupbn"]["y"].numpy(), want["y"][r])
        _grad_close(p["groupbn"]["gx"].numpy(), want["gx"][r])


def test_convert_syncbn_model_over_the_axis():
    """``convert_syncbn_model(BatchNorm2d, axis_name="dp")``: a
    SyncBatchNorm over the axis whose channel-first output is the
    normalization by JAX's whole-axis statistics."""
    xs = _inputs()[0]
    mean, var, _ = _per_device(lambda x: jstats(x, (0, 1, 2), "dp"), xs)
    for r, p in enumerate(_port()):
        assert p["convert"]["type"] == "SyncBatchNorm"
        assert p["convert"]["axis"] == "dp"
        want = (xs[r] - mean[r]) / np.sqrt(var[r] + 1e-5)
        _close(p["convert"]["y"].numpy(), want)


# ---------------------------------------------------------------------------
# the bottleneck's split conv


BH, BW, CIN, COUT = 8, 6, 4, 5


@functools.lru_cache(maxsize=None)
def _bottleneck():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, BH, BW, CIN)).astype(np.float32)
    k = (0.3 * rng.standard_normal((3, 3, CIN, COUT))).astype(np.float32)
    cot = rng.standard_normal((2, BH, BW, COUT)).astype(np.float32)
    port = spawn(workers.bottleneck, W, x, k, cot)
    mesh = jbuild_mesh(tp=1, pp=1, sp=W, devices=jax.devices()[:W])

    def split(x, k):
        return jax.jit(shard_map(
            lambda a, b: jspatial(a, b), mesh=mesh,
            in_specs=(P(None, "sp"), P()), out_specs=P(None, "sp"),
            check_vma=False))(x, k)

    y = split(x, k)
    gx = jax.grad(lambda a: jnp.sum(split(a, k) * cot))(x)

    def full(x, k):
        return lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    yf = full(x, k)
    gxf, gkf = jax.grad(lambda a, b: jnp.sum(full(a, b) * cot),
                        argnums=(0, 1))(x, k)
    return port, [np.asarray(v) for v in (y, gx, yf, gxf, gkf)]


def test_spatial_conv3x3_forward_matches_jax_and_the_unsplit_conv():
    """H split 4 ways: each rank's output rows are JAX's split conv's and
    the unsplit SAME convolution's."""
    port, (y, _, yf, _, _) = _bottleneck()
    h = BH // W
    assert not any(r["jax_loaded"] for r in port)
    assert all(r["same_class"] for r in port)
    got = np.concatenate([port[i]["y"].numpy() for i in range(W)], axis=1)
    assert [r["index"] for r in port] == list(range(W))
    _close(got, y)
    _close(got, yf)
    assert got.shape[1] == h * W


def test_spatial_conv3x3_backward_matches_jax_and_the_unsplit_conv():
    """The halo's backward sends the halo rows' gradients home: each
    rank's input gradient is JAX's and the unsplit conv's; the ranks'
    kernel gradients sum to the unsplit conv's."""
    port, (_, gx, _, gxf, gkf) = _bottleneck()
    got = np.concatenate([port[i]["gx"].numpy() for i in range(W)], axis=1)
    _close(got, gx)
    _close(got, gxf)
    gk = sum(port[i]["gk"].numpy().astype(np.float64) for i in range(W))
    _grad_close(gk, gkf)
