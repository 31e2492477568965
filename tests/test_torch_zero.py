"""The port's ZeRO optimizers (``contrib.optimizers``) against the JAX
package's.

The port runs in ``gloo`` groups of spawned ranks (``torch_dist_workers``
imports no JAX); JAX's ``DistributedFusedAdam`` / ``LAMB`` run inside
``shard_map`` on a dp-only mesh of the conftest's CPU devices
(``build_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:W])``). The
fixture is JAX's (``tests/test_distributed_optimizers.py``): a (13, 7)
and a (5,) leaf, here with per-rank gradients from numpy; 3 steps at W = 2
and W = 8. JAX's ``fused_update="on"`` runs its Pallas tail in interpret
mode, the port's ``"on"`` the kernel's plain version (the CPU).

Tolerances. Params, masters and moments within JAX's own 1e-6 (the
ranks' sum in another order, c1 / c2 from ``pow`` in another library),
compressed too (``int8``, ``int8_ef``, ``int4_ef``; block 8, min 16
elements, so the (13, 7) leaf rides the codec and the (5,) one does
not): the codec's CPU route is JAX's reference, its codes bitwise JAX's
(``tests/test_torch_comm_dist.py``). EF residuals: pass 1's error,
within one code step of the rank's own buffer (its largest |gradient|
over qmax) and 4 ulps. e5m2: the masters bitwise the uncompressed run's
and the params bitwise JAX's clip → model dtype → float8_e5m2 of the
port's own masters. Shard shapes, counts and the wire model: exact;
metrics within 1e-5 (relative), ``update_norm`` within 2·√n·1e-6 (a
norm of differences of masters each held to 1e-6).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.comm import CompressionConfig as JCompressionConfig
from apex_tpu.contrib.optimizers import (
    DistributedFusedAdam as JAdam,
    DistributedFusedLAMB as JLAMB,
)
from apex_tpu.contrib.optimizers.distributed_fused_adam import (
    _zero_wire_bytes as j_zero_wire_bytes,
)
from apex_tpu.monitor import Metrics as JMetrics
from apex_tpu.parallel.mesh import build_mesh as jbuild_mesh

from apex_tpu_torch.comm import CompressionConfig
from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
from apex_tpu_torch.contrib.optimizers import _sharding
from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    _global_norm_shards,
    _local_sq,
    _shard_multiple,
    _zero_wire_bytes,
)
from apex_tpu_torch.parallel.multiproc import spawn

import torch_dist_workers as workers

STEPS = 3
WORLDS = (2, 8)
SHAPES = {"w": (13, 7), "b": (5,)}
CODEC = dict(block_size=8, min_elements=16)
QMAX = {8: 127.0, 4: 7.0}
LR = 1e-2

# (label, optimizer, kwargs, codec policy, scale, metrics)
CASES = (
    ("adam_on", "adam", dict(lr=LR, weight_decay=0.01, fused_update="on"),
     None, None, True),
    ("adam_off", "adam", dict(lr=LR, weight_decay=0.01, fused_update="off"),
     None, None, False),
    ("adam_l2", "adam", dict(lr=LR, weight_decay=0.01, adam_w_mode=False),
     None, None, False),
    ("lamb_on", "lamb", dict(lr=LR, weight_decay=0.01, fused_update="on"),
     None, None, True),
    ("lamb_off", "lamb", dict(lr=LR, weight_decay=0.01, max_grad_norm=None,
                              fused_update="off"), None, None, False),
    ("adam_int8", "adam", dict(lr=LR), "int8", None, True),
    ("adam_int8_ef", "adam", dict(lr=LR), "int8_ef", None, False),
    ("adam_int4_ef", "adam", dict(lr=LR), "int4_ef", None, False),
    ("lamb_int8_ef", "lamb", dict(lr=LR), "int8_ef", 4.0, False),
    ("adam_clip_scale", "adam", dict(lr=LR, max_grad_norm=1.0), None, 2.0,
     True),
    ("adam_e5m2", "adam", dict(lr=LR, e5m2_allgather=True), None, None,
     False),
)


def _case(label):
    return next(c for c in CASES if c[0] == label)


def _inputs():
    rng = np.random.default_rng(11)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = {k: (0.1 * rng.standard_normal((8,) + s)).astype(np.float32)
             for k, s in SHAPES.items()}
    residuals = {k: (1e-3 * rng.standard_normal((8,) + s)).astype(
        np.float32) for k, s in SHAPES.items()}
    return params, grads, residuals


PARAMS, GRADS, RESIDUALS = _inputs()


def _grads_for(label, world):
    return {k: GRAD_MULT.get(label, 1.0) * v[:world]
            for k, v in GRADS.items()}


# the clip case's gradients are large (its scale divides them out)
GRAD_MULT = {"adam_clip_scale": 200.0}


def _port_spec(case):
    label, kind, kw, policy, scale, metrics = case
    codec = None if policy is None else dict(policy=policy, **CODEC)
    return (label, kind, kw, codec, scale, metrics,
            GRAD_MULT.get(label, 1.0))


BERT_ARGS = (4, 1e-2, 4, 32)       # steps, lr, batch, seq


@functools.lru_cache(maxsize=None)
def _spawned(world):
    res = {k: v[:world] for k, v in RESIDUALS.items()}
    calls = [("zero_cases", (PARAMS, _grads_for("", world), res,
                             [_port_spec(c) for c in CASES], STEPS))]
    if world == 2:
        calls.append(("bert_lamb", BERT_ARGS))
    return spawn(workers.several, world, calls)


def _port(world):
    return [r["zero_cases"] for r in _spawned(world)]


def _jcfg(policy):
    return None if policy is None else JCompressionConfig(policy=policy,
                                                          **CODEC)


@functools.lru_cache(maxsize=None)
def _jax(label, world):
    _, kind, kw, policy, scale, with_metrics = _case(label)
    cls = JAdam if kind == "adam" else JLAMB
    opt = cls(compression=_jcfg(policy), **kw)
    mesh = jbuild_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:world])
    ef = policy is not None and policy.endswith("_ef")
    sc = None if scale is None else jnp.asarray(scale, jnp.float32)

    def body(p, g, r):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        comm = jax.tree_util.tree_map(lambda x: x[0], r) if ef else None
        st = opt.init(p)
        m = None
        for _ in range(STEPS):
            out = opt.step(g, st, p, scale=sc, comm_state=comm,
                           metrics=JMetrics() if with_metrics else None)
            p, st = out[0], out[1]
            if ef:
                comm = out[2]
            if with_metrics:
                m = out[-1]
        comm = (jax.tree_util.tree_map(lambda x: x[None], comm) if ef
                else None)
        return p, st.master, st.mu, st.nu, comm, m

    tree = jax.tree_util.tree_map(lambda _: P(), PARAMS)
    shard = jax.tree_util.tree_map(lambda _: P("dp"), PARAMS)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(tree, shard, shard),
                          out_specs=(tree, shard, shard, shard,
                                     shard if ef else None,
                                     P() if with_metrics else None),
                          check_vma=False))
    res = {k: v[:world] for k, v in RESIDUALS.items()}
    p, master, mu, nu, comm, m = f(PARAMS, _grads_for(label, world), res)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"params": np_tree(p), "master": np_tree(master),
            "mu": np_tree(mu), "nu": np_tree(nu),
            "comm": None if comm is None else np_tree(comm),
            "metrics": None if m is None else m.as_dict()}


def _cat(ranks, label, what):
    """Each leaf's shards of every rank, in rank order (JAX's P("dp")
    concatenation)."""
    return {k: np.concatenate([r[label][what][k].numpy() for r in ranks])
            for k in SHAPES}


LABELS = [c[0] for c in CASES]


def test_ranks_import_no_jax():
    for world in WORLDS:
        assert not any(r["jax_loaded"] for r in _port(world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", LABELS)
def test_zero_matches_jax(label, world):
    """Params after 3 steps (every rank the same bits), the master and
    moment shards and the step count, against JAX's optimizer in its mesh
    program."""
    ranks = _port(world)
    want = _jax(label, world)
    policy = _case(label)[3]
    for r in ranks:
        for k in SHAPES:
            np.testing.assert_array_equal(r[label]["params"][k].numpy(),
                                          ranks[0][label]["params"][k].numpy())
        assert r[label]["count"] == STEPS
    if label == "adam_e5m2":
        got_m = _cat(ranks, label, "master")
        for k in SHAPES:
            n = int(np.prod(SHAPES[k]))
            emulated = np.asarray(jnp.asarray(np.clip(
                got_m[k][:n], -57344.0, 57344.0)).astype(
                jnp.float8_e5m2).astype(jnp.float32)).reshape(SHAPES[k])
            np.testing.assert_array_equal(
                ranks[0][label]["params"][k].numpy(), emulated)
            np.testing.assert_allclose(got_m[k], want["master"][k],
                                       atol=1e-6)
        return
    tol = dict(atol=1e-6, rtol=0)
    for what in ("master", "mu", "nu"):
        got = _cat(ranks, label, what)
        for k in SHAPES:
            np.testing.assert_allclose(got[k], want[what][k], **tol,
                                       err_msg=f"{what} {k}")
    for k in SHAPES:
        np.testing.assert_allclose(ranks[0][label]["params"][k].numpy(),
                                   want["params"][k], **tol, err_msg=k)
    if policy is None or not policy.endswith("_ef"):
        return
    # the EF residual: pass 1's error, within one code step of the rank's
    # own buffer (its largest |gradient| over qmax) and 4 ulps
    qmax = QMAX[4 if policy.startswith("int4") else 8]
    for i, r in enumerate(ranks):
        for k in SHAPES:
            g = np.abs(_grads_for(label, world)[k][i]).max()
            step = g / qmax + 4 * np.finfo(np.float32).eps * g
            np.testing.assert_allclose(r[label]["comm"][k].numpy(),
                                       want["comm"][k][i], atol=step,
                                       err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_state_shard_shapes_equal_jax(world):
    """The state's shards: ``ceil(n / W)`` rounded to the codec's block
    (``(12,)`` for 91 elements at W = 8), as JAX's."""
    ranks = _port(world)
    for label in LABELS:
        want = _jax(label, world)["mu"]
        for k in SHAPES:
            assert ranks[0][label]["shapes"][k] == (
                want[k].shape[0] // world,), (label, k)
    if world == 8:
        assert ranks[0]["adam_on"]["shapes"]["w"] == (12,)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", [c[0] for c in CASES if c[5]])
def test_zero_metrics_match_jax(label, world):
    """``grad_norm``, ``param_norm``, ``update_norm`` and
    ``comm_wire_bytes`` of the last step: JAX's names and values."""
    got = _port(world)[0][label]["metrics"]
    want = _jax(label, world)["metrics"]
    assert sorted(got) == sorted(want)
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    for k, v in want.items():
        # ‖Δ‖ is a difference of masters each held to 1e-6 (old and new)
        tol = 2e-6 * np.sqrt(n) if k == "update_norm" else 1e-5 * abs(v)
        assert abs(got[k] - v) <= tol, (k, got[k], v)


@pytest.mark.parametrize("world", (1, 2, 8, 64))
@pytest.mark.parametrize("policy", (None, "int8", "int8_ef", "int4_ef"))
@pytest.mark.parametrize("e5m2", (False, True))
def test_zero_wire_bytes_equal_jax(policy, world, e5m2):
    """``_zero_wire_bytes`` over GPT-2-124M's leaf sizes and the fixture's,
    exactly JAX's."""
    sizes = [(50304, 768), (1024, 768), (12, 768), (12, 768, 2304),
             (12, 2304), (12, 768, 3072), (12, 3072, 768), (768,), (13, 7),
             (5,)]
    cfg = None if policy is None else CompressionConfig(policy=policy)
    jcfg = None if policy is None else JCompressionConfig(policy=policy)
    got = _zero_wire_bytes([torch.empty(s, device="meta") for s in sizes],
                           world, cfg, e5m2_allgather=e5m2)
    want = j_zero_wire_bytes([jax.ShapeDtypeStruct(s, jnp.float32)
                              for s in sizes], world, jcfg,
                             e5m2_allgather=e5m2)
    assert got == want


def test_sharding_helpers():
    """``shard_size`` / ``shard_multiple`` / ``shard_multiple_lcm`` are
    JAX's arithmetic; the private aliases stay; an EF policy without its
    state raises; fused_update is checked at construction."""
    from apex_tpu.contrib.optimizers import _sharding as jsh

    for n in (1, 5, 91, 4096, 124_475_904):
        for w in (1, 2, 3, 8, 64):
            for m in (1, 8, 128, 256, 768):
                assert _sharding.shard_size(n, w, m) == jsh.shard_size(
                    n, w, m)
    assert _shard_multiple(None) == 1
    assert _shard_multiple(CompressionConfig("none")) == 1
    assert _shard_multiple(CompressionConfig("int8", block_size=64)) == 64
    assert _sharding.shard_multiple_lcm(
        CompressionConfig("int8", block_size=192),
        CompressionConfig("int4", block_size=256), None) == 768
    assert _local_sq is _sharding.local_sq
    assert _global_norm_shards is _sharding.global_norm_shards
    with pytest.raises(ValueError, match="comm_state"):
        DistributedFusedAdam(compression=CompressionConfig("int8_ef")).step(
            {"w": torch.ones(3)}, None, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="fused_update"):
        DistributedFusedLAMB(fused_update="sometimes")


def test_checkpoint_surface_names_a8():
    """The sharded checkpoint surface raises, naming ROADMAP A8."""
    opt, lamb = DistributedFusedAdam(), DistributedFusedLAMB()
    for call in (lambda: opt.state_dict(None),
                 lambda: opt.load_state_dict(None, {}),
                 lambda: opt.elastic_spec({}, 2),
                 lambda: opt.elastic_comm_spec({}, 2),
                 lambda: lamb.state_dict(None),
                 lambda: lamb.load_state_dict(None, {})):
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            call()


def test_fp16_optimizer_reexport():
    from apex_tpu_torch.contrib.optimizers.fp16_optimizer import (
        FP16_Optimizer,
    )
    from apex_tpu_torch.fp16_utils import FP16_Optimizer as base

    assert FP16_Optimizer is base


# ---------------------------------------------------------------------------
# DistributedFusedLAMB on BERT against FusedLAMB


def _bert():
    return [r["bert_lamb"] for r in _spawned(2)]


def test_dist_lamb_bert_tracks_fused_lamb():
    """A 2-layer BERT at dp = 2, 4 steps: DistributedFusedLAMB (fp32
    masters, the LAMB tail on shards) against DDP + FusedLAMB with the
    same hyperparameters from the same weights: losses within 1e-4, every
    final param within 1e-4 of it (the clip's forms differ: JAX's
    ``min(1, c / (‖g‖ + 1e-6))`` against FusedLAMB's ``‖g‖ / c``); both
    ranks the same; the loss falls."""
    ranks = _bert()
    assert not any(r["jax_loaded"] for r in ranks)
    for r in ranks[1:]:
        for a, b in zip(r["dist_lamb"]["final"], ranks[0]["dist_lamb"]
                        ["final"]):
            assert torch.equal(a, b)
    d, f = ranks[0]["dist_lamb"], ranks[0]["fused_lamb"]
    np.testing.assert_allclose(d["losses"], f["losses"], atol=1e-4)
    for a, b in zip(d["final"], f["final"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    assert d["losses"][-1] < d["losses"][0]
