"""The port's mesh, compressed collectives, accounting and amp's found_inf
across ranks, against the JAX package.

The port runs in ``gloo`` groups of W spawned ranks
(``parallel.multiproc.spawn``; the rank functions in
``torch_dist_workers.py``, which imports no JAX); JAX runs in this
process on the conftest's 8-device CPU mesh (a dp-only mesh over the
first W devices, inside ``shard_map`` with ``check_vma=False``). The
same numpy buffers from a seed go to both. One spawn per W serves every
test of that W.

Tolerances. Pass 1's codes and scales: bitwise (both codecs divide).
The all-reduce: within one pass-3 code step (the block's requantization
scale) of JAX's — the exchanged sums add the same W values in another
order, so a code at a rounding boundary may move by one. The exchanged
shard (reduce-scatter): within 8·W fp32 ulps of its largest value. The
EF residuals: within one pass-3 step of JAX's, pass 1's error within
2 ulps of the buffer's largest value (XLA's CPU program fuses x − q·s
into one FMA); the port's telescoping identity within 1e-6. Below ``min_elements`` (and ``none``): within
8·W ulps of JAX's psum.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.amp.scaler import LossScaler as JLossScaler
from apex_tpu.comm import collectives as jcoll
from apex_tpu.parallel.mesh import build_mesh as jbuild_mesh

from apex_tpu_torch.comm import collectives as pcoll
from apex_tpu_torch.parallel import mesh as pmesh
from apex_tpu_torch.parallel.multiproc import spawn

import torch_dist_workers as workers

POLICIES = ("int8", "int8_ef", "int4", "int4_ef", "none")
BLOCK, MIN_ELEMENTS = 128, 128
SIZES = {"padded": 3000, "aligned": 2048, "small": 100}
WORLDS = (2, 4, 8)


def _inputs(world):
    rng = np.random.default_rng(world)
    bufs = {k: rng.standard_normal((world, n)).astype(np.float32)
            for k, n in SIZES.items()}
    res = {k: (1e-2 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in bufs.items()}
    stoch = rng.standard_normal((world, 4096)).astype(np.float32)
    return bufs, res, stoch


@functools.lru_cache(maxsize=None)
def _port(world):
    bufs, res, stoch = _inputs(world)
    return spawn(workers.collectives, world, bufs, res, POLICIES, BLOCK,
                 MIN_ELEMENTS, stoch)


def _jmesh(world):
    return jbuild_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:world])


def _jax_per_rank(world, fn, *stacked):
    """``fn`` of each device's row of every ``stacked`` array inside
    shard_map on the W-device dp mesh; outputs stacked per rank."""
    def body(*xs):
        outs = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda o: o[None], outs)

    return jax.jit(shard_map(body, mesh=_jmesh(world),
                             in_specs=tuple(P("dp") for _ in stacked),
                             out_specs=P("dp"), check_vma=False))(*stacked)


def _jcfg(policy):
    return jcoll.CompressionConfig(policy=policy, block_size=BLOCK,
                                   min_elements=MIN_ELEMENTS)


@functools.lru_cache(maxsize=None)
def _jax(world, policy, name):
    bufs, res, _ = _inputs(world)
    cfg = _jcfg(policy)
    x, r = bufs[name], res[name]
    if cfg.error_feedback:
        ar = _jax_per_rank(world, lambda a, b: jcoll.compressed_allreduce(
            a, "dp", cfg, residual=b), x, r)
        ps = _jax_per_rank(world, lambda a, b: jcoll.compressed_psum_scatter(
            a, "dp", cfg, residual=b, shard_multiple=BLOCK), x, r)
    else:
        ar = _jax_per_rank(world, lambda a: jcoll.compressed_allreduce(
            a, "dp", cfg)[0], x)
        ps = _jax_per_rank(world, lambda a: jcoll.compressed_psum_scatter(
            a, "dp", cfg, shard_multiple=BLOCK)[0], x)
        ar, ps = (ar, None), (ps, None)
    return jax.tree_util.tree_map(np.asarray, (ar, ps))


def _np(t):
    return None if t is None else t.numpy()


def _pass3_steps(port, policy, name, world):
    """Each output element's pass-3 step: the requantization scale of its
    block, from every rank's shard (the reduce-scatter's) requantized."""
    scales = []
    for r in range(world):
        shard = port[r][(policy, name)]["psum_scatter"]
        q, s = pcoll.CompressionConfig(
            policy=policy, block_size=BLOCK,
            min_elements=MIN_ELEMENTS).quantize(shard)
        scales.append(s.numpy())
    return np.repeat(np.concatenate(scales), BLOCK)


def _ulps(x, world):
    return 8 * world * np.finfo(np.float32).eps * float(np.abs(x).max())


# ---------------------------------------------------------------------------
# fold_seed, _pass_seed


def test_fold_seed_is_bitwise_jax():
    """``fold_seed`` on host ints equals JAX's int32 hash for seeds across
    the int32 range (negative ones too) and salts up to 2**32 - 1."""
    rng = np.random.default_rng(0)
    seeds = np.concatenate([[0, 1, -1, 2 ** 31 - 1, -2 ** 31],
                            rng.integers(-2 ** 31, 2 ** 31, 200)])
    salts = np.concatenate([[0, 1, 2, 2 ** 32 - 1],
                            rng.integers(0, 2 ** 32, 200)])
    pairs = [(int(s), int(t)) for s in seeds[:40] for t in salts[:40]]
    pairs += [(int(s), int(t)) for s, t in zip(seeds, salts)]
    s_arr = np.array([p[0] for p in pairs], np.int32)
    t_arr = np.array([p[1] for p in pairs], np.uint32)
    want = np.asarray(jax.jit(jax.vmap(jcoll.fold_seed))(s_arr, t_arr))
    got = np.array([pcoll.fold_seed(s, t) for s, t in pairs], np.int32)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(OverflowError):
        pcoll.fold_seed(2 ** 31, 0)


def test_pass_seed_per_rank_is_bitwise_jax():
    """``_pass_seed(seed, rank, pass)`` (port, on each of 8 ranks) equals
    JAX's ``_pass_seed(seed, "dp", pass)`` on each device."""
    port = _port(8)
    seeds = (0, 7, -5, 2 ** 31 - 1)
    for i, s in enumerate(seeds):
        want = np.asarray(_jax_per_rank(
            8, lambda _x, s=s: jnp.stack([jcoll._pass_seed(s, "dp", p)
                                          for p in (1, 2)]),
            np.zeros((8, 1), np.float32)))
        got = np.stack([port[r]["pass_seeds"][i].numpy() for r in range(8)])
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the collectives


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(world):
    port = _port(world)
    assert not any(p["jax_loaded"] for p in port)
    assert [p["index"] for p in port] == list(range(world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", ("int8", "int8_ef", "int4", "int4_ef"))
@pytest.mark.parametrize("name", ("padded", "aligned"))
def test_pass1_codes_and_scales_bitwise_jax(world, policy, name):
    """The padded (and, under EF, compensated) buffer's pass-1 codes and
    scales on every rank equal JAX's ``CompressionConfig.quantize``."""
    port = _port(world)
    bufs, res, _ = _inputs(world)
    cfg = _jcfg(policy)
    n = SIZES[name]
    size = -(-n // (BLOCK * world)) * BLOCK * world
    for r in range(world):
        comp = bufs[name][r] + (res[name][r] if cfg.error_feedback else 0)
        padded = np.zeros(size, np.float32)
        padded[:n] = comp
        q, s = cfg.quantize(jnp.asarray(padded))
        rec = port[r][(policy, name)]
        np.testing.assert_array_equal(rec["codes"].numpy(), np.asarray(q))
        np.testing.assert_array_equal(rec["scales"].numpy(), np.asarray(s))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", tuple(SIZES))
def test_compressed_allreduce_matches_jax(world, policy, name):
    """Every rank's all-reduce within one pass-3 step of JAX's (8·W ulps
    on the uncompressed path), and the same bits on every rank."""
    port = _port(world)
    (ar, _), _ = _jax(world, policy, name)
    got = np.stack([port[r][(policy, name)]["allreduce"].numpy()
                    for r in range(world)])
    assert (got == got[0]).all(), "ranks disagree"
    cfg = _jcfg(policy)
    n = SIZES[name]
    if not cfg.compresses(n):
        np.testing.assert_allclose(got, ar, rtol=0,
                                   atol=_ulps(ar, world))
        return
    step = _pass3_steps(port, policy, name, world)[:n]
    assert (np.abs(got - ar) <= step * (1 + 1e-5)).all()
    exact = _inputs(world)[0][name].sum(0)
    if cfg.error_feedback:
        exact = exact + _inputs(world)[1][name].sum(0)
    # and near the true sum: a pass-1 half step on each of W ranks plus a
    # pass-3 half step
    assert np.abs(got[0] - exact).max() < 0.3 * np.abs(exact).max()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", tuple(SIZES))
def test_compressed_psum_scatter_matches_jax(world, policy, name):
    """Each rank's summed shard within 8·W ulps of JAX's (the codes are
    the same bits; only the order of the W adds differs)."""
    port = _port(world)
    _, (ps, _) = _jax(world, policy, name)
    got = np.stack([port[r][(policy, name)]["psum_scatter"].numpy()
                    for r in range(world)])
    assert got.shape == ps.shape
    np.testing.assert_allclose(got, ps, rtol=0, atol=_ulps(ps, world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", ("int8_ef", "int4_ef"))
@pytest.mark.parametrize("name", tuple(SIZES))
def test_error_feedback_residuals_match_jax(world, policy, name):
    """The all-reduce's and the reduce-scatter's new residuals within one
    pass-3 step of JAX's (the reduce-scatter's, pass 1 only: within 2
    ulps of the buffer's largest value); below ``min_elements`` the
    residual passes through."""
    port = _port(world)
    (_, jar_r), (_, jps_r) = _jax(world, policy, name)
    n = SIZES[name]
    ar_r = np.stack([_np(port[r][(policy, name)]["allreduce_res"])
                     for r in range(world)])
    ps_r = np.stack([_np(port[r][(policy, name)]["psum_scatter_res"])
                     for r in range(world)])
    if not _jcfg(policy).compresses(n):
        res = _inputs(world)[1][name]
        np.testing.assert_array_equal(ar_r, res)
        np.testing.assert_array_equal(ps_r, res)
        return
    # XLA's CPU program forms pass 1's error x - q·s as one FMA, the port
    # rounds q·s first: up to an ulp of the buffer's values apart
    bufs, res, _ = _inputs(world)
    fma = 2 * np.finfo(np.float32).eps * float(
        np.abs(bufs[name] + res[name]).max())
    step = _pass3_steps(port, policy, name, world)[:n]
    assert (np.abs(ar_r - jar_r) <= step * (1 + 1e-5) + fma).all()
    np.testing.assert_allclose(ps_r, jps_r, rtol=0, atol=fma)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", ("int8_ef", "int4_ef"))
@pytest.mark.parametrize("name", ("padded", "aligned"))
def test_residuals_telescope(world, policy, name):
    """Σ_k r_k = Σ_k e1_k + e2 (each shard's pass-3 error from its
    owner), within 1e-6; and the all-reduce plus the residuals' sum is
    the compensated sum within one pass-3 step."""
    port = _port(world)
    n = SIZES[name]
    r_sum = sum(port[r][(policy, name)]["allreduce_res"].double().numpy()
                for r in range(world))
    e1 = sum(port[r][(policy, name)]["e1"].double().numpy()
             for r in range(world))
    e2 = np.concatenate([port[r][(policy, name)]["e2"].double().numpy()
                         for r in range(world)])
    np.testing.assert_allclose(r_sum, (e1 + e2)[:n], rtol=0, atol=1e-6)
    bufs, res, _ = _inputs(world)
    comp = (bufs[name] + res[name]).astype(np.float64).sum(0)
    out = port[0][(policy, name)]["allreduce"].double().numpy()
    np.testing.assert_allclose(out + r_sum, comp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_stochastic_rounding_deterministic_and_unbiased(world):
    """One seed twice: the same bits; another seed: other bits; the mean
    of 32 seeded all-reduces lands nearer the exact sum than one does
    (the errors average out: unbiased), and every rank agrees."""
    port = _port(world)
    runs = np.stack([p["stochastic"].numpy() for p in port])
    assert (runs == runs[0]).all(), "ranks disagree"
    runs = runs[0]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (runs[0] != runs[2]).any()
    exact = _inputs(world)[2].sum(0)
    one = np.abs(runs[3] - exact).mean()
    mean = runs[3:].mean(0)
    assert np.abs(mean - exact).mean() < 0.35 * one
    assert abs((mean - exact).mean()) < 0.05 * one


@pytest.mark.parametrize("world", WORLDS)
def test_collective_report_prices_the_wire_model(world):
    """The issued collectives priced by ``collective_report`` equal
    ``allreduce_wire_bytes`` (JAX's model), and the int8 wire moves ≥ 3.5x
    fewer bytes than fp32 (int4 ≥ 6x): JAX's claim, here on the issued
    collectives."""
    port = _port(world)
    n = 65536
    for policy in ("int8", "int4", "none"):
        cfg = pcoll.CompressionConfig(policy=policy)
        want = jcoll.allreduce_wire_bytes(n, 4, world, _jcfg_default(policy))
        assert float(port[0][("wire", policy)]) == pytest.approx(want,
                                                                 rel=1e-12)
        assert pcoll.allreduce_wire_bytes(n, 4, world, cfg) == want
    counts = port[0][("counts", "int8")]
    assert counts["all-to-all"] == 2 and counts["all-gather"] == 2
    assert port[0][("counts", "none")]["all-reduce"] == 1
    fp32 = float(port[0][("wire", "none")])
    assert fp32 / float(port[0][("wire", "int8")]) >= 3.5
    assert fp32 / float(port[0][("wire", "int4")]) >= 6.0


def _jcfg_default(policy):
    return jcoll.CompressionConfig(policy=policy)


@pytest.mark.parametrize("n,world", [(100, 8), (3000, 2), (3000, 8),
                                     (2048, 4), (10 ** 6, 8)])
@pytest.mark.parametrize("policy", POLICIES)
def test_wire_models_match_jax(n, world, policy):
    """The three wire-byte models equal JAX's."""
    cfg, jcfg = (pcoll.CompressionConfig(policy=policy),
                 jcoll.CompressionConfig(policy=policy))
    assert pcoll.allreduce_wire_bytes(n, 2, world, cfg) == \
        jcoll.allreduce_wire_bytes(n, 2, world, jcfg)
    assert pcoll.psum_scatter_wire_bytes(n, 2, world, cfg, 128) == \
        jcoll.psum_scatter_wire_bytes(n, 2, world, jcfg, 128)
    assert pcoll.all_gather_wire_bytes(n, 2, world) == \
        jcoll.all_gather_wire_bytes(n, 2, world)
    assert cfg.payload_bytes(n) == jcfg.payload_bytes(n)
    assert cfg.compresses(n) == jcfg.compresses(n)


def test_compression_config_checks_match_jax():
    """The policy, block-size and int4-parity checks raise as JAX's; an
    EF policy without a residual raises before any collective."""
    for kw in ({"policy": "int2"}, {"block_size": 0},
               {"policy": "int4", "block_size": 129}):
        with pytest.raises(ValueError) as want:
            jcoll.CompressionConfig(**kw)
        with pytest.raises(ValueError) as got:
            pcoll.CompressionConfig(**kw)
        assert str(got.value) == str(want.value)
    import torch

    with pytest.raises(ValueError, match="residual"):
        pcoll.compressed_allreduce(torch.zeros(4096), "dp",
                                   pcoll.CompressionConfig("int8_ef"))


# ---------------------------------------------------------------------------
# the mesh and found_inf

MESH_SHAPES = ((2, 1, 2), (1, 1, 1), (8, 1, 1), (1, 2, 2))


@functools.lru_cache(maxsize=None)
def _port_mesh():
    return spawn(workers.mesh_and_found_inf, 8, MESH_SHAPES, 5)


@pytest.mark.parametrize("tp,pp,sp,dp", [
    (1, 1, 1, -1), (2, 1, 1, -1), (2, 2, 2, -1), (8, 1, 1, -1),
    (2, 1, 1, 4), (3, 1, 1, -1), (2, 1, 1, 2), (1, 1, 1, 16),
    (16, 1, 1, -1), (1, 4, 1, 2)])
def test_build_mesh_shapes_and_errors_match_jax(tp, pp, sp, dp):
    """``mesh_shape`` (what ``build_mesh`` lays out) gives JAX's
    ``build_mesh`` shape on 8 devices, or JAX's error message."""
    try:
        want = jbuild_mesh(tp=tp, pp=pp, sp=sp, dp=dp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.mesh_shape(8, tp=tp, pp=pp, sp=sp, dp=dp)
        assert str(got.value) == str(e)
        return
    got = pmesh.mesh_shape(8, tp=tp, pp=pp, sp=sp, dp=dp)
    assert dict(zip(pmesh.AXIS_ORDER, got)) == dict(want.shape)
    assert pmesh.model_parallel_axes(want) == ("pp", "sp", "tp")


def test_build_mesh_needs_a_process_group():
    """Outside a process group (the test process never makes one: its
    ranks are spawned) ``build_mesh`` says how to make one."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pmesh.build_mesh()
    assert pmesh.get_mesh(required=False) is None


@pytest.mark.parametrize("which", range(len(MESH_SHAPES)))
def test_rank_coordinates_are_jax_device_coordinates(which):
    """On each mesh, rank r's coordinates, axis indices and group sizes
    are JAX device r's (``lax.axis_index`` inside the mesh program, the
    axis sizes); the ranks' layout is JAX's ``mesh.devices`` ids."""
    port = _port_mesh()
    assert not any(p["jax_loaded"] for p in port)
    tp, pp, sp = MESH_SHAPES[which]
    jm = jbuild_mesh(tp=tp, pp=pp, sp=sp)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(port[0]["meshes"][which]["devices"]
                                  .numpy(), ids)

    def body(_x):
        return jnp.stack([lax.axis_index(a) for a in jm.axis_names]
                         ).reshape(1, 1, 1, 1, 4)

    spec = P(*jm.axis_names)
    idx = np.asarray(jax.jit(shard_map(
        body, mesh=jm, in_specs=spec, out_specs=spec, check_vma=False))(
        np.zeros(jm.devices.shape + (1,), np.float32)))
    idx = idx.reshape(-1, 4)
    for r in range(8):
        m = port[r]["meshes"][which]
        coord = tuple(int(c) for c in np.argwhere(ids == r)[0])
        assert m["coords"] == coord
        assert tuple(m["index"][a] for a in jm.axis_names) == coord
        assert tuple(idx[r]) == coord
        assert m["group_size"] == dict(jm.shape)
        assert m["shape"] == tuple(jm.shape[a] for a in jm.axis_names)


@pytest.mark.parametrize("axes", workers.FOUND_INF_AXES)
def test_found_inf_over_named_axes_is_jax_pmax(axes):
    """``LossScaler.all_reduce_found_inf(flag, axis_names)`` on the (dp 2,
    sp 2, tp 2) mesh, the flag set on rank 5 only: every rank's result is
    JAX's ``all_reduce_found_inf`` (``lax.pmax``) on device r; the input
    is not written."""
    port = _port_mesh()
    jm = jbuild_mesh(tp=2, pp=1, sp=2)
    flags = np.zeros(jm.devices.shape + (1,), np.float32)
    flags.reshape(-1)[5] = 1.0

    def body(f):
        return JLossScaler.all_reduce_found_inf(f, axes)

    want = np.asarray(jax.jit(shard_map(
        body, mesh=jm, in_specs=P(*jm.axis_names),
        out_specs=P(*jm.axis_names), check_vma=False))(flags)).reshape(-1)
    got = [p["found_inf"][axes] for p in port]
    np.testing.assert_array_equal(got, want)
    assert [p["flag_kept"] for p in port] == [float(r == 5)
                                              for r in range(8)]


def test_found_inf_over_a_group_and_the_refusal():
    """``group=`` reduces over a process group (the tp pair of rank 5:
    ranks 4 and 5); with neither axis names nor a group the call raises."""
    import torch

    port = _port_mesh()
    assert [p["found_inf_group"] for p in port] == [
        float(r in (4, 5)) for r in range(8)]
    from apex_tpu_torch.amp import LossScaler

    with pytest.raises(TypeError, match="axis_names"):
        LossScaler.all_reduce_found_inf(torch.tensor(1.0))
