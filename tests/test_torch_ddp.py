"""The port's DistributedDataParallel against the JAX package's.

The port runs in ``gloo`` groups of spawned ranks (``torch_dist_workers``
imports no JAX); JAX's ``DistributedDataParallel`` runs on the conftest's
8-device CPU mesh (dp only, ``shard_map``, ``check_vma=False``). JAX's
GPT is never put inside a mesh program (jax 0.9 refuses its ``tp``
psum there): the gradients fed to both sides are numpy arrays from a
seed, shaped like the tiny GPT's tree.

Tolerances. Bucket lists, labels and the wire-byte metrics: exact.
Uncompressed averages: 8·W ulps (of fp32, or of bf16 on a bf16 wire,
where every add rounds) of the largest Σ_k |g_k| (the ranks' sum in
another order), and bf16 leaves one bf16 rounding. Compressed averages and EF residuals: one pass-3
code step of the output's block — its block's largest |value| over qmax,
read off JAX's output (the block's largest value is a ±qmax code) — plus
2 ulps of the buffer (XLA fuses pass 1's x − q·s into one FMA).
``accumulate_and_average``: bitwise ``average_gradients`` of the summed
gradients. The EF training property: JAX's own gates
(``tests/test_comm_mesh.py:480-490``): int8 EF within 0.02 of the
uncompressed curve at every step, int8 within 0.05, progress > 0.5 over
12 steps.
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
from apex_tpu.comm import error_feedback as jef
from apex_tpu.parallel.distributed import (
    DistributedDataParallel as JDDP,
    _flatten_buckets as jflatten_buckets,
)
from apex_tpu.parallel.mesh import build_mesh as jbuild_mesh
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jinit_gpt

from apex_tpu_torch.comm import CompressionConfig
from apex_tpu_torch.comm import error_feedback as pef
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.optimizers._common import tree_leaves
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    _flatten_buckets,
)
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

import torch_dist_workers as workers

TINY = dict(vocab_size=128, max_seq=32, hidden=64, num_layers=2,
            num_heads=2)
W = 8
BLOCK = 128
QMAX = {8: 127.0, 4: 7.0}

# (label, DDP kwargs, policy, block, metrics, gradient dtype)
CASES = (
    ("none", {}, None, BLOCK, True, "float32"),
    ("predivide", {"gradient_predivide_factor": 4.0}, None, BLOCK, False,
     "float32"),
    ("sum", {"gradient_average": False}, None, BLOCK, False, "float32"),
    ("int8", {}, "int8", BLOCK, True, "float32"),
    ("int8_ef", {}, "int8_ef", BLOCK, True, "float32"),
    ("int4", {}, "int4", BLOCK, False, "float32"),
    ("int4_ef", {"message_size": 20_000}, "int4_ef", BLOCK, True,
     "float32"),
    ("int8_predivide", {"gradient_predivide_factor": 2.0}, "int8_ef", 256,
     False, "float32"),
    ("int8_leafwise", {"flat_buckets": False}, "int8", BLOCK, True,
     "float32"),
    ("bf16_small_msg", {"message_size": 5_000}, None, BLOCK, True,
     "bfloat16"),
    ("bf16_fp32_wire", {"allreduce_always_fp32": True}, None, BLOCK, True,
     "bfloat16"),
    ("bf16_int8_ef", {}, "int8_ef", BLOCK, True, "bfloat16"),
)


def _tree_np():
    """The tiny GPT's tree: per-rank gradients (W, *shape) and EF
    residuals, numpy from a seed, keys as both packages name them."""
    params = init_gpt_params(GPTConfig(dtype=torch.float32, **TINY),
                             device="cpu")
    rng = np.random.default_rng(3)

    def grads(scale):
        out = {}
        for path, t in named_leaves(params):
            node = out
            *head, leaf = path.split(".")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = (scale * rng.standard_normal(
                (W,) + tuple(t.shape))).astype(np.float32)
        return out

    return grads(1e-2), grads(1e-4)


GRADS, RESIDUALS = _tree_np()


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)


@functools.lru_cache(maxsize=None)
def _port_average():
    out = {}
    for dt in ("float32", "bfloat16"):
        cases = [c[:5] for c in CASES if c[5] == dt]
        out[dt] = spawn(workers.ddp_average, W, GRADS, RESIDUALS, cases,
                        dt == "bfloat16")
    return out


def _jcfg(policy, block):
    return None if policy is None else JCompressionConfig(
        policy=policy, block_size=block, min_elements=block)


@functools.lru_cache(maxsize=None)
def _jax_average(label):
    _, kw, policy, block, with_metrics, dt = next(c for c in CASES
                                                  if c[0] == label)
    mesh = jbuild_mesh(tp=1, pp=1, sp=1)
    ddp = JDDP(compression=_jcfg(policy, block), **kw)
    g = _cast(GRADS, jnp.bfloat16 if dt == "bfloat16" else jnp.float32)
    ef = ddp.init_comm_state(GRADS) is not None
    metrics = None
    if with_metrics:
        from apex_tpu.monitor import Metrics

        metrics = Metrics()

    def body(g, r):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        r = jax.tree_util.tree_map(lambda x: x[0], r) if ef else None
        out = ddp.average_gradients(g, comm_state=r, metrics=metrics)
        out = out if isinstance(out, tuple) else (out,)
        grads = jax.tree_util.tree_map(lambda x: x[None], out[0])
        state = (jax.tree_util.tree_map(lambda x: x[None], out[1])
                 if ef else None)
        return grads, state, (out[-1] if with_metrics else None)

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                          out_specs=(P("dp"), P("dp"), P()),
                          check_vma=False))
    grads, state, m = f(g, RESIDUALS)
    return (jax.tree_util.tree_map(np.asarray, grads),
            None if state is None else jax.tree_util.tree_map(np.asarray,
                                                              state),
            None if m is None else m.as_dict())


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _leaves(tree):
    return [_f32(x) for x in tree_leaves(tree)]


def _bucket_steps(want_leaves, buckets, block, bits):
    """Per-element pass-3 steps: each bucket's output (here JAX's)
    flattened in bucket order, cut in blocks from the bucket's start, the
    block's largest |value| over qmax."""
    steps = [None] * len(want_leaves)
    for _dt, idxs in buckets:
        flat = np.concatenate([want_leaves[i].reshape(-1) for i in idxs])
        n = flat.size
        pad = np.zeros(-(-n // block) * block, np.float32)
        pad[:n] = np.abs(flat)
        s = np.repeat(pad.reshape(-1, block).max(1) / QMAX[bits], block)
        off = 0
        for i in idxs:
            k = want_leaves[i].size
            steps[i] = s[off:off + k].reshape(want_leaves[i].shape)
            off += k
    return steps


def _port_case(label):
    dt = next(c[5] for c in CASES if c[0] == label)
    return [r[label] for r in _port_average()[dt]], dt


# ---------------------------------------------------------------------------
# buckets and labels


@pytest.mark.parametrize("message_size", [10_000_000, 1_000_000, 5_000,
                                          20_000, 1])
def test_buckets_of_gpt2_tree_equal_jax(message_size):
    """GPT-2-124M's tree (``GPTConfig()``, bf16; shapes from JAX's
    ``eval_shape``, the port's leaves as meta tensors of the same keys)
    and the tiny tree: the bucket lists equal JAX's ``_flatten_buckets``
    (dtype, leaf indices in tree order)."""
    jshapes = jax.eval_shape(lambda k: jinit_gpt(k, JGPTConfig()),
                             jax.random.PRNGKey(0))
    jleaves = jax.tree_util.tree_leaves(jshapes)
    pleaves = [torch.empty(tuple(x.shape), dtype=torch.bfloat16,
                           device="meta") for x in jleaves]
    got = _flatten_buckets(pleaves, message_size)
    want = jflatten_buckets(jleaves, message_size)
    assert [idx for _, idx in got] == [idx for _, idx in want]
    assert all(str(g).split(".")[1] == str(w) for (g, _), (w, _)
               in zip(got, want))
    # the port's own GPT tree orders its leaves as JAX's does
    port = init_gpt_params(GPTConfig(dtype=torch.float32, **TINY),
                           device="cpu")
    jtiny = jinit_gpt(jax.random.PRNGKey(0),
                      JGPTConfig(dtype=jnp.float32, **TINY))
    assert [tuple(t.shape) for _, t in named_leaves(port)] == [
        x.shape for x in jax.tree_util.tree_leaves(jtiny)]
    pb = _flatten_buckets(tree_leaves(port), message_size)
    jb = jflatten_buckets(jax.tree_util.tree_leaves(jtiny), message_size)
    assert [i for _, i in pb] == [i for _, i in jb]


@pytest.mark.parametrize("label", [c[0] for c in CASES if c[4]])
def test_comm_metrics_equal_jax(label):
    """``comm_bucket{i}_bytes``, ``comm_wire_bytes`` and
    ``comm_compression_ratio``: JAX's labels and values, on every rank."""
    port, _ = _port_case(label)
    _, _, want = _jax_average(label)
    for r in range(W):
        got = port[r]["metrics"]
        assert list(got) == sorted(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6), k


@pytest.mark.parametrize("label", [c[0] for c in CASES if c[4]])
def test_issued_collectives_price_as_the_metrics(label):
    """The collectives the average issued, priced by ``collective_report``,
    move the bytes the metrics model: ``comm_wire_bytes``."""
    port, _ = _port_case(label)
    for r in range(W):
        assert port[r]["wire"] == pytest.approx(
            port[r]["metrics"]["comm_wire_bytes"], rel=1e-9)


def test_int8_wire_moves_3_5x_fewer_bytes_than_fp32():
    """JAX's claim (``test_collective_counts.py``, which cannot compile
    its GPT program under jax 0.9): the int8 gradient wire moves ≥ 3.5x
    fewer bytes than the fp32 one, read off the issued collectives."""
    none, _ = _port_case("none")
    int8, _ = _port_case("int8")
    assert none[0]["wire"] / int8[0]["wire"] >= 3.5


# ---------------------------------------------------------------------------
# averages


def test_ranks_import_no_jax_and_inputs_kept():
    for dt, ranks in _port_average().items():
        assert not any(r["jax_loaded"] for r in ranks), dt
        assert all(r["inputs_kept"] for r in ranks), dt


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_average_gradients_match_jax(label):
    """Every leaf on every rank: JAX's average (sum, predivide, fp32 wire,
    bf16 leaves, every policy, flat and leafwise buckets), in the leaf's
    own dtype; the same bits on every rank."""
    _, kw, policy, block, _, dt = next(c for c in CASES if c[0] == label)
    port, _ = _port_case(label)
    jgrads, _, _ = _jax_average(label)
    want = _leaves(jgrads)
    ref_dtype = torch.bfloat16 if dt == "bfloat16" else torch.float32
    for r in range(W):
        got = port[r]["grads"]
        assert all(t.dtype == ref_dtype for t in tree_leaves(got))
        for a, b in zip(_leaves(got), _leaves(port[0]["grads"])):
            np.testing.assert_array_equal(a, b)
    got = _leaves(port[0]["grads"])
    cfg = _jcfg(policy, block)
    half = 2.0 ** -8 if dt == "bfloat16" else 0.0
    if cfg is None:
        # a bf16 wire adds in bf16, each add rounded: W roundings of the
        # partial sums apart at most
        wire = (2.0 ** -8 if dt == "bfloat16"
                and not kw.get("allreduce_always_fp32") else
                np.finfo(np.float32).eps)
        for g, w, x in zip(got, want, tree_leaves(GRADS)):
            tol = 8 * W * wire * np.abs(x).sum(0).max()
            np.testing.assert_allclose(g, w[0], rtol=half, atol=tol)
        return
    ddp = DistributedDataParallel(**kw)
    buckets = ddp.buckets([torch.empty(x.shape[1:]) for x in want])
    steps = _bucket_steps([w[0] for w in want], buckets, block, cfg.bits)
    fma = 4 * np.finfo(np.float32).eps * max(
        np.abs(x).max() for x in tree_leaves(GRADS))
    for g, w, s in zip(got, want, steps):
        err = np.abs(g - w[0])
        assert (err <= s * (1 + 1e-5) + fma + half * np.abs(w[0])).all()


@pytest.mark.parametrize("label", [c[0] for c in CASES
                                   if c[2] and c[2].endswith("_ef")])
def test_error_feedback_state_matches_jax(label):
    """The new residual tree on every rank within one pass-3 step of
    JAX's (times the predivide: the residual is in predivided units)."""
    _, kw, policy, block, _, dt = next(c for c in CASES if c[0] == label)
    port, _ = _port_case(label)
    jgrads, jstate, _ = _jax_average(label)
    pre = kw.get("gradient_predivide_factor", 1.0)
    post = pre / W
    ddp = DistributedDataParallel(**kw)
    out0 = [w[0] for w in _leaves(jgrads)]
    buckets = ddp.buckets([torch.empty(x.shape) for x in out0])
    steps = _bucket_steps(out0, buckets, block, _jcfg(policy, block).bits)
    fma = 4 * np.finfo(np.float32).eps * max(
        np.abs(x).max() for x in tree_leaves(GRADS))
    half = 2.0 ** -8 if dt == "bfloat16" else 0.0
    want = _leaves(jstate)
    for r in range(W):
        got = _leaves(port[r]["state"])
        for g, w, s, o in zip(got, want, steps, out0):
            err = np.abs(g - w[r])
            assert (err <= s / post * (1 + 1e-5) + fma
                    + half * np.abs(o) / post).all()


# ---------------------------------------------------------------------------
# EF state, accumulation, broadcast


def test_ef_state_dict_round_trips_with_jax():
    """The port's residual ``state_dict`` loads into JAX's (the treedef
    string is JAX's), JAX's loads into the port's, bit for bit; a
    mismatched structure raises in both."""
    port_tree = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a[0].copy()), RESIDUALS)
    d = pef.state_dict(port_tree)
    jtemplate = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape[1:]),
                                       RESIDUALS)
    assert d["treedef"] == str(jax.tree_util.tree_structure(jtemplate))
    back = jef.load_state_dict(jtemplate, d)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(RESIDUALS)):
        np.testing.assert_array_equal(np.asarray(a), b[0])
    jd = jef.state_dict(jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                               RESIDUALS))
    ptemplate = pef.init_error_feedback(port_tree)
    got = pef.load_state_dict(ptemplate, jd)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(RESIDUALS)):
        np.testing.assert_array_equal(a.numpy(), b[1])
    bad = dict(port_tree, extra=torch.zeros(2))
    with pytest.raises(ValueError, match="structure"):
        pef.load_state_dict(bad, d)
    for t in ([torch.zeros(3)], (torch.zeros(1),), {"a": None, "b": 1}):
        assert pef.treedef_str(t) == str(jax.tree_util.tree_structure(t))


@functools.lru_cache(maxsize=None)
def _port_accumulate():
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    xs = rng.standard_normal((4, 3, 16, 64)).astype(np.float32)
    ys = rng.standard_normal((4, 3, 16, 48)).astype(np.float32)
    return spawn(workers.ddp_accumulate, 4, w0, xs, ys), w0


@pytest.mark.parametrize("policy", ["None", "int8_ef"])
def test_accumulate_and_average_equals_average_of_summed(policy):
    """``accumulate_and_average`` over 3 microbatches returns the mean
    loss, the averaged gradients and the new EF state bitwise those of
    ``average_gradients`` of the gradients summed in order."""
    port, _ = _port_accumulate()
    for r in port:
        assert not r["jax_loaded"]
        got, want = r[policy]["got"], r[policy]["want"]
        assert len(got) == len(want) == (3 if policy == "int8_ef" else 2)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


def test_broadcast_params_and_reducer():
    """``broadcast_params``: every rank holds rank 0's values (JAX's masked
    sum); ``Reducer.reduce``: the raw sum over ranks."""
    port, w0 = _port_accumulate()
    for r in port:
        np.testing.assert_array_equal(r["broadcast"]["w"].numpy(), w0)
        np.testing.assert_array_equal(r["broadcast"]["b"].numpy(), 0.0)
        np.testing.assert_allclose(r["reduce"]["w"].numpy(), 4 * w0 + 6,
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(r["reduce"]["b"].numpy(), -6.0)


# ---------------------------------------------------------------------------
# the EF training property


@functools.lru_cache(maxsize=None)
def _training():
    tok = np.random.default_rng(1).integers(0, 128, (16, 32))
    return spawn(workers.gpt_ef_training, 4, tok, (None, "int8_ef", "int8"),
                 12, 2e-3, BLOCK, 6)


def test_int8_ef_training_tracks_uncompressed():
    """The port's tiny GPT, 4 ranks, 12 FusedAdam steps (lr 2e-3) on
    block-128 wires: int8 EF within 0.02 of the uncompressed curve at
    every step (its residual through ``comm_state_dict`` mid-run), int8
    within 0.05, progress > 0.5 — JAX's gates; every rank's curve the
    same."""
    out = _training()
    assert not any(r["jax_loaded"] for r in out)
    for key in ("None", "int8_ef", "int8"):
        assert all(r[key] == out[0][key] for r in out)
    base, ef, raw = (np.array(out[0][k]) for k in ("None", "int8_ef",
                                                   "int8"))
    assert base[-1] < base[0] - 0.5, base
    np.testing.assert_allclose(ef, base, atol=0.02)
    np.testing.assert_allclose(raw, base, atol=0.05)


def test_ef_policies_need_the_state():
    """An EF policy without ``comm_state`` raises, as JAX's; ``enabled``
    must be a bool; ``enabled=False`` returns the gradients and the state
    untouched."""
    ddp = DistributedDataParallel(compression=CompressionConfig("int8_ef"))
    g = [torch.ones(3)]
    with pytest.raises(ValueError, match="comm_state"):
        ddp.average_gradients(g)
    with pytest.raises(TypeError):
        ddp.average_gradients(g, enabled=1)
    st = ddp.init_comm_state(g)
    out, st2 = ddp.average_gradients(g, enabled=False, comm_state=st)
    assert out is g and st2 is st
    assert ddp.replicate(g) is g
