"""The port's FSDP (``fsdp``: the gather on demand, its reduce-scatter
backward, ``FSDPAdam``) against the JAX package's, and the ZeRO ladder's
training properties on the port's GPT.

The port runs in ``gloo`` groups of spawned ranks; JAX's ``FSDP`` /
``FSDPAdam`` run inside ``shard_map`` on a dp-only mesh of the conftest's
CPU devices, with a loss that is not JAX's GPT (jax 0.9 refuses its
``tp`` psum inside a mesh program): per rank Σ_leaves Σ(full · a_rank) +
½ Σ(full² · c), whose gradient reads the gathered values, so the
weight-gather codec moves it. W = 2 and 4, 3 steps, JAX's fixture leaves
(13, 7) and (5,) and a (24, 20) one the codecs compress (block 16, min
64 elements).

Tolerances. The first step's shard gradients: the W ranks' cotangents
summed in another order, 4·W ulps of Σ_rank |cotangent|. Masters after 3
steps: JAX's 1e-6. The final gather: exact wires 1e-6; a codec one code
step of the leaf (its largest |value| over qmax) and 1e-6. Metrics:
byte models exact, norms 1e-5 relative (``update_norm`` 2·√n·1e-6).

JAX's GPT acceptance properties (``tests/test_fsdp.py:545-604``), which
JAX cannot run here, are held on the port's tiny GPT at dp = 2 (6 steps,
lr 2e-3, targets = tokens as JAX's fixture): FSDP == ZeRO-1 bitwise,
both within 1e-5 of DDP + FusedAdam, the loss falling by > 0.5; the int8
/ int4 weight gathers within 0.02 / 0.1 of DDP and the int8 / int4
gradient wires within 0.05 / 0.15 (JAX's tolerances).
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
from apex_tpu.fsdp import FSDP as JFSDP
from apex_tpu.fsdp import FSDPAdam as JFSDPAdam
from apex_tpu.monitor import Metrics as JMetrics
from apex_tpu.parallel.mesh import build_mesh as jbuild_mesh

from apex_tpu_torch.comm import CompressionConfig
from apex_tpu_torch.fsdp import FSDP, FSDPAdam, LeafMeta
from apex_tpu_torch.parallel.multiproc import spawn

import torch_dist_workers as workers

STEPS = 3
WORLDS = (2, 4)
SHAPES = {"w": (13, 7), "b": (5,), "k": (24, 20)}
CODEC = dict(block_size=16, min_elements=64)
QMAX = {8: 127.0, 4: 7.0}
CASES = {
    "exact": {},
    "gather_int8": {"weight_gather": dict(policy="int8", **CODEC)},
    "gather_int4": {"weight_gather": dict(policy="int4", **CODEC)},
    "grad_int8": {"compression": dict(policy="int8", **CODEC)},
}
GPT_RUNS = (
    ("ddp", "ddp", {}),
    ("zero1", "zero1", {}),
    ("fsdp", "fsdp", {}),
    ("gather_int8", "fsdp", {"weight_gather": dict(policy="int8",
                                                   min_elements=256)}),
    ("gather_int4", "fsdp", {"weight_gather": dict(
        policy="int4", block_size=128, min_elements=256)}),
    ("grad_int8", "fsdp", {"compression": dict(policy="int8",
                                               min_elements=256)}),
    ("grad_int4", "fsdp", {"compression": dict(
        policy="int4", block_size=128, min_elements=256)}),
)
GPT_STEPS, GPT_LR = 6, 2e-3


def _inputs():
    rng = np.random.default_rng(21)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    coefs = {k: (0.1 * rng.standard_normal((4,) + s)).astype(np.float32)
             for k, s in SHAPES.items()}
    curv = {k: rng.uniform(0.5, 1.5, s).astype(np.float32)
            for k, s in SHAPES.items()}
    return params, coefs, curv


PARAMS, COEFS, CURV = _inputs()
TOKENS = np.random.default_rng(1).integers(0, 128, (8, 32))


@functools.lru_cache(maxsize=None)
def _spawned(world):
    coefs = {k: v[:world] for k, v in COEFS.items()}
    calls = [("fsdp_cases", (PARAMS, coefs, CURV, list(CASES.items()),
                             STEPS))]
    if world == 2:
        calls.append(("gpt_ladder", (TOKENS, GPT_STEPS, GPT_LR, GPT_RUNS)))
    return spawn(workers.several, world, calls)


def _port(world):
    return [r["fsdp_cases"] for r in _spawned(world)]


def _gpt():
    return [r["gpt_ladder"] for r in _spawned(2)]


def _jcodecs(label):
    return {k: JCompressionConfig(**v) for k, v in CASES[label].items()}


@functools.lru_cache(maxsize=None)
def _jax(label, world):
    fsdp = JFSDP(**_jcodecs(label))
    opt = JFSDPAdam(fsdp=fsdp, lr=1e-2, weight_decay=0.01)
    meta = fsdp.meta(PARAMS)
    mesh = jbuild_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:world])
    metrics = JMetrics({"grad_norm": 0.0, "param_norm": 0.0,
                        "update_norm": 0.0, "param_gather_bytes": 0.0,
                        "comm_wire_bytes": 0.0, "hbm_params_bytes": 0.0})

    def body(p, a, m):
        a = jax.tree_util.tree_map(lambda x: x[0], a)
        st = opt.init(p)
        first = None
        for i in range(STEPS):
            def loss_fn(master):
                full = fsdp.gather(master, meta)
                return sum(jnp.sum(full[k] * a[k])
                           + 0.5 * jnp.sum(full[k] * full[k] * CURV[k])
                           for k in sorted(full))

            g = jax.grad(loss_fn)(st.master)
            if i == 0:
                first = g
            if i == STEPS - 1:
                st, m = opt.step(g, st, metrics=m, meta=meta)
            else:
                st = opt.step(g, st)
        return first, st.master, fsdp.gather(st.master, meta), m

    tree = jax.tree_util.tree_map(lambda _: P(), PARAMS)
    shard = jax.tree_util.tree_map(lambda _: P("dp"), PARAMS)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(tree, shard, P()),
                          out_specs=(shard, shard, tree, P()),
                          check_vma=False))
    g, master, gathered, m = f(PARAMS, {k: v[:world]
                                        for k, v in COEFS.items()}, metrics)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"grads": np_tree(g), "master": np_tree(master),
            "gathered": np_tree(gathered), "metrics": m.as_dict()}


def _cat(ranks, label, what):
    return {k: np.concatenate([r[label][what][k].detach().numpy()
                               for r in ranks]) for k in SHAPES}


def test_ranks_import_no_jax():
    for world in WORLDS:
        assert not any(r["jax_loaded"] for r in _port(world))
    assert not any(r["jax_loaded"] for r in _gpt())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", list(CASES))
def test_fsdp_shard_grads_match_jax(label, world):
    """The first step's shard gradients: the gather's backward, a
    reduce-scatter (fp32 or the int8 wire) straight into shard layout."""
    ranks = _port(world)
    want = _jax(label, world)["grads"]
    got = _cat(ranks, label, "grads")
    eps = np.finfo(np.float32).eps
    for k in SHAPES:
        assert got[k].shape == want[k].shape
        cot = np.abs(COEFS[k][:world]).sum(0) + world * np.abs(
            PARAMS[k] * CURV[k])
        tol = 4 * world * eps * cot.max()
        if label == "grad_int8":
            # the wire's one code step of the summed shard's block
            tol += cot.max() / QMAX[8]
        n = int(np.prod(SHAPES[k]))
        np.testing.assert_allclose(got[k][:n], want[k][:n], atol=tol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", list(CASES))
def test_fsdp_adam_matches_jax(label, world):
    """Masters after 3 FSDPAdam steps, and the final gather, against
    JAX's; the new masters do not require grad."""
    ranks = _port(world)
    want = _jax(label, world)
    got = _cat(ranks, label, "master")
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want["master"][k], atol=1e-6,
                                   rtol=0, err_msg=k)
    wg = CASES[label].get("weight_gather")
    for r in ranks:
        assert not r[label]["requires_grad"]
        for k in SHAPES:
            g = r[label]["gathered"][k].numpy()
            w = want["gathered"][k]
            tol = 1e-6
            if wg is not None and np.prod(SHAPES[k]) >= CODEC[
                    "min_elements"]:
                tol += np.abs(w).max() / QMAX[4 if "int4" in label else 8]
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", list(CASES))
def test_fsdp_metrics_match_jax(label, world):
    """The last step's metrics with ``meta``: the byte models exactly,
    the norms as the masters."""
    got = _port(world)[0][label]["metrics"]
    want = _jax(label, world)["metrics"]
    assert sorted(got) == sorted(want)
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    for k, v in want.items():
        if k in ("param_gather_bytes", "comm_wire_bytes",
                 "hbm_params_bytes"):
            assert got[k] == v, k
        else:
            tol = 2e-6 * np.sqrt(n) if k == "update_norm" else 1e-5 * v
            assert abs(got[k] - v) <= tol, (k, got[k], v)


def test_shard_multiple_is_lcm_and_codec_refusals():
    """``shard_multiple`` the lcm of both codecs' blocks; error feedback
    and stochastic rounding refused with JAX's messages."""
    f = FSDP(compression=CompressionConfig("int8", block_size=192),
             weight_gather=CompressionConfig("int8", block_size=256))
    jf = JFSDP(compression=JCompressionConfig("int8", block_size=192),
               weight_gather=JCompressionConfig("int8", block_size=256))
    assert f.shard_multiple == jf.shard_multiple == 768
    assert FSDP().shard_multiple == 1
    for name in ("compression", "weight_gather"):
        for kw, match in ((dict(policy="int8_ef"), "error feedback"),
                          (dict(policy="int4_ef"), "error feedback"),
                          (dict(policy="int8", stochastic_rounding=True),
                           "stochastic")):
            with pytest.raises(ValueError, match=match) as got:
                FSDP(**{name: CompressionConfig(**kw)})
            with pytest.raises(ValueError) as want:
                JFSDP(**{name: JCompressionConfig(**kw)})
            assert str(got.value) == str(want.value)


def test_meta_and_policy_dtype_match_jax():
    """``meta`` keeps JAX's dtype names (so the records compare equal);
    ``policy_dtype`` picks the same dtype as JAX's."""
    tp = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
          "b": {"c": torch.zeros(5), "d": torch.zeros(2, dtype=torch.float16)},
          "e": torch.zeros(7, dtype=torch.int8)}
    jp = {"a": jnp.zeros((3, 4), jnp.bfloat16),
          "b": {"c": jnp.zeros(5), "d": jnp.zeros(2, jnp.float16)},
          "e": jnp.zeros(7, jnp.int8)}
    got = FSDP().meta(tp)
    want = JFSDP().meta(jp)
    assert jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, LeafMeta)) == [
        LeafMeta(m.shape, m.dtype) for m in jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: hasattr(x, "dtype"))]
    for sub in (tp, {"x": tp["b"]["c"]}, {"x": tp["a"], "y": tp["b"]["c"]},
                {"x": tp["e"]}):
        jsub = jax.tree_util.tree_map(
            lambda t: jnp.zeros(tuple(t.shape), str(t.dtype).split(".")[1]),
            sub)
        pd, jd = FSDP().policy_dtype(FSDP().meta(sub)), JFSDP().policy_dtype(
            JFSDP().meta(jsub))
        assert (None if pd is None else str(pd).split(".")[1]) == (
            None if jd is None else jnp.dtype(jd).name)


def test_linear_shard_and_refusals():
    """``shard_linear_weight``: this rank's fp32 column slice; 3-D and
    indivisible weights refused; ``FSDP.linear`` names ROADMAP A7c."""
    for world in WORLDS:
        for rank, r in enumerate(_port(world)):
            lin = np.arange(6 * 4 * world, dtype=np.float32).reshape(6, -1)
            np.testing.assert_array_equal(
                r["linear_shard"].numpy(), lin[:, rank * 4:(rank + 1) * 4])
            assert r["linear_shard"].dtype == torch.float32
            assert "2-D kernel" in r["linear_refusals"][0]
            assert "not divisible" in r["linear_refusals"][1]
    with pytest.raises(NotImplementedError, match="ROADMAP A7c"):
        FSDP().linear(torch.zeros(2, 3), torch.zeros(3, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        FSDPAdam().state_dict(None)


# ---------------------------------------------------------------------------
# the ZeRO ladder on the port's GPT at dp = 2


def test_fsdp_equals_zero1_bitwise_and_tracks_ddp():
    """FSDP == ZeRO-1 bitwise (losses and final masters, every rank), both
    within 1e-5 of DDP + FusedAdam on fp32 params, the loss falling by
    more than 0.5 over 6 steps (JAX's ``test_fsdp_matches_ddp_loss_curve``)."""
    ranks = _gpt()
    for r in ranks:
        z, f, d = r["zero1"], r["fsdp"], r["ddp"]
        assert z["losses"] == f["losses"]
        assert all(torch.equal(a, b) for a, b in zip(z["final"], f["final"]))
        np.testing.assert_allclose(f["losses"], d["losses"], atol=1e-5)
        for a, b in zip(f["final"], d["final"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    mean = np.mean([r["ddp"]["losses"] for r in ranks], axis=0)
    assert mean[-1] < mean[0] - 0.5, mean


@pytest.mark.parametrize("label,atol", [("gather_int8", 0.02),
                                        ("gather_int4", 0.1),
                                        ("grad_int8", 0.05),
                                        ("grad_int4", 0.15)])
def test_fsdp_codecs_track_ddp(label, atol):
    """The int8 / int4 weight-gather and gradient wires track DDP's curve
    within JAX's tolerances (``tests/test_fsdp.py:558-604``), the codec
    rounding something; int4 runs still train (> 0.4)."""
    ranks = _gpt()
    got = np.mean([r[label]["losses"] for r in ranks], axis=0)
    base = np.mean([r["ddp"]["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(got, base, atol=atol)
    assert np.any(got != base)
    if "int4" in label:
        assert got[-1] < got[0] - 0.4, got


def test_build_train_step_plans():
    """``build_train_step(plan=)`` at dp = 2 for the ``ddp``, ``zero1``
    and ``fsdp`` presets: the three curves bitwise equal (the fp32 GPT;
    one rank's tokens on both), falling."""
    for r in _gpt():
        t = r["build_train_step"]
        assert t["ddp"] == t["zero1"] == t["fsdp"], t
        assert t["fsdp"][-1] < t["fsdp"][0]


def test_plan_mesh_over_ranks():
    """``ParallelismPlan.mesh()`` over the group's ranks (dp = 2), and an
    indivisible shape refused with JAX's arithmetic."""
    for r in _gpt():
        assert r["plan_mesh"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 1}
        assert "divisible" in r["plan_mesh_refusal"]
