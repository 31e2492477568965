"""The port's ``ParallelismPlan`` (``parallel/plan.py``) and FSDP byte
accounting (``fsdp/accounting.py``) against the JAX package's, exactly.

Both are arithmetic and validation on the host: every preset, every bad
construction of ``tests/test_fsdp.py:65-100`` (the same exception type
and message), ``describe()`` text-equal, the serving hooks' results and
refusals (``tests/test_serve_sharded.py``), the plan's builders; then
every accounting function on GPT-2-124M's tree of shapes (JAX's
``eval_shape`` of its init; the port's leaves as ``meta`` tensors and as
:class:`LeafMeta`) at W = 1, 2, 8, 64 under each codec, equal to JAX's
numbers. The surfaces that wait raise, naming their ROADMAP items.
"""

import functools
import itertools

import pytest
import torch

import jax

from apex_tpu.comm import CompressionConfig as JCompressionConfig
from apex_tpu.fsdp import FSDP as JFSDP
from apex_tpu.fsdp import accounting as jacc
from apex_tpu.parallel import ParallelismPlan as JPlan
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jinit_gpt

from apex_tpu_torch.comm import CompressionConfig
from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
from apex_tpu_torch.fsdp import FSDP, FSDPAdam
from apex_tpu_torch.fsdp import accounting as pacc
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.optimizers._common import tree_map
from apex_tpu_torch.parallel import ParallelismPlan
from apex_tpu_torch.parallel.distributed import DistributedDataParallel
from apex_tpu_torch.parallel.mesh import mesh_shape

WORLDS = (1, 2, 8, 64)
CODECS = {
    "none": None,
    "int8": dict(policy="int8"),
    "int8_small": dict(policy="int8", min_elements=256, block_size=128),
    "int4": dict(policy="int4", block_size=128),
}


def _cfgs(name):
    spec = CODECS[name]
    if spec is None:
        return None, None
    return CompressionConfig(**spec), JCompressionConfig(**spec)


def _pair(**kw):
    """The same plan in both packages (codec fields given as kwargs
    dicts)."""
    pk, jk = dict(kw), dict(kw)
    for f in ("compression", "weight_gather"):
        if f in kw and kw[f] is not None:
            pk[f] = CompressionConfig(**kw[f])
            jk[f] = JCompressionConfig(**kw[f])
    return pk, jk


# ---------------------------------------------------------------------------
# construction, presets, describe


PLANS = (
    dict(),
    dict(data="zero1"),
    dict(data="zero1", optimizer="lamb"),
    dict(data="zero1", e5m2_allgather=True, compression=dict(policy="int8")),
    dict(data="fsdp"),
    dict(data="fsdp", dp=8, compression=dict(policy="int8"),
         weight_gather=dict(policy="int4", block_size=128)),
    dict(data="fsdp", tp=2, overlap_comm=True, bidirectional=True),
    dict(tp=4, overlap_comm=True),
    dict(tp=4),
    dict(pp=2),
    dict(pp=2, tp=2, sp=2, dp=2, fused_update="off"),
    dict(data="ddp", compression=dict(policy="int8_ef")),
)


@pytest.mark.parametrize("name", ["ddp", "zero1", "fsdp", "fsdp+tp"])
def test_presets_equal_jax(name):
    plan, jplan = ParallelismPlan.preset(name), JPlan.preset(name)
    for f in ("data", "dp", "tp", "pp", "sp", "dp_axis", "e5m2_allgather",
              "overlap_comm", "bidirectional", "fused_update", "optimizer"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.describe() == jplan.describe()
    assert plan.model_axes() == jplan.model_axes()
    assert plan.gpt_overrides() == jplan.gpt_overrides()
    assert ParallelismPlan.preset(name, tp=4).tp == 4


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_describe_and_overrides_equal_jax(kw):
    pk, jk = _pair(**kw)
    plan, jplan = ParallelismPlan(**pk), JPlan(**jk)
    assert plan.describe() == jplan.describe()
    assert plan.gpt_overrides() == jplan.gpt_overrides()
    for method in ("serve_strategy", "serve_overrides"):
        try:
            want = getattr(jplan, method)()
        except (ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)) as got:
                getattr(plan, method)()
            assert str(got.value) == str(e)
            continue
        got = getattr(plan, method)()
        if isinstance(want, dict) and want.get("weight_gather") is not None:
            assert got.pop("weight_gather") == pk["weight_gather"]
            want = dict(want)
            want.pop("weight_gather")
        assert got == want


BAD = (
    dict(data="zzz"),
    dict(optimizer="sgd"),
    dict(dp_axis="rows"),
    dict(tp=0),
    dict(pp=-2),
    dict(dp=0),
    dict(sp=1.5),
    dict(data="ddp", weight_gather=dict(policy="int8")),
    dict(data="fsdp", e5m2_allgather=True),
    dict(data="fsdp", optimizer="lamb"),
    dict(data="fsdp", compression=dict(policy="int8_ef")),
    dict(data="fsdp", weight_gather=dict(policy="int8",
                                         stochastic_rounding=True)),
    dict(fused_update="sometimes"),
)


@pytest.mark.parametrize("bad", BAD, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_bad_construction_refused_as_jax(bad):
    pk, jk = _pair(**bad)
    with pytest.raises(ValueError) as want:
        JPlan(**jk)
    with pytest.raises(ValueError) as got:
        ParallelismPlan(**pk)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_unknown_preset_and_cross_checks():
    with pytest.raises(ValueError, match="preset"):
        ParallelismPlan.preset("fsdp+pp")
    with pytest.raises(ValueError, match="reduce-scatter"):
        ParallelismPlan.preset("fsdp").ddp()
    with pytest.raises(ValueError, match="not fsdp"):
        ParallelismPlan.preset("ddp").fsdp()
    with pytest.raises(ValueError, match="divisible"):
        mesh_shape(8, tp=9)


def test_builders():
    """``ddp()``, ``fsdp()`` and ``build_optimizer`` give the port's
    components with the plan's fields; the ``ddp`` strategy's torch
    optimizers take ``params=``."""
    int8 = CompressionConfig("int8")
    ddp = ParallelismPlan(compression=int8).ddp(message_size=5)
    assert isinstance(ddp, DistributedDataParallel)
    assert ddp.compression == int8 and ddp.message_size == 5
    z = ParallelismPlan("zero1", e5m2_allgather=True, compression=int8,
                        fused_update="off").build_optimizer(lr=0.5,
                                                            eps=1e-6)
    assert isinstance(z, DistributedFusedAdam)
    assert (z.lr, z.eps, z.e5m2_allgather, z.compression,
            z.fused_update) == (0.5, 1e-6, True, int8, "off")
    lamb = ParallelismPlan("zero1", optimizer="lamb").build_optimizer()
    assert isinstance(lamb, DistributedFusedLAMB)
    wg = CompressionConfig("int8", block_size=512)
    f = ParallelismPlan("fsdp", weight_gather=wg, bidirectional=True)
    assert f.fsdp() == FSDP(weight_gather=wg, bidirectional=True)
    opt = f.build_optimizer(lr=2e-3)
    assert isinstance(opt, FSDPAdam) and opt.fsdp == f.fsdp()
    assert opt.lr == 2e-3
    p = [torch.zeros(3, requires_grad=True)]
    assert isinstance(ParallelismPlan().build_optimizer(params=p), FusedAdam)
    assert isinstance(ParallelismPlan(optimizer="lamb").build_optimizer(
        params=p), FusedLAMB)
    with pytest.raises(ValueError, match="params="):
        ParallelismPlan().build_optimizer()


def test_waiting_surfaces_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        ParallelismPlan.preset("fsdp").checkpoint_manager("/nonexistent")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        DistributedFusedAdam().state_dict(None)
    with pytest.raises(NotImplementedError, match="ROADMAP A7c"):
        FSDP().linear(torch.zeros(2, 3), torch.zeros(3, 2))


def test_parallel_exports_the_plan():
    import apex_tpu_torch.parallel as par

    assert par.ParallelismPlan is ParallelismPlan
    with pytest.raises(AttributeError):
        par.NoSuchThing  # noqa: B018


# ---------------------------------------------------------------------------
# accounting on GPT-2-124M's tree


@functools.lru_cache(maxsize=None)
def _gpt2_trees():
    """JAX's GPT-2-124M shapes (bf16) and the port's mirror: ``meta``
    tensors of the same keys and shapes."""
    jshapes = jax.eval_shape(lambda k: jinit_gpt(k, JGPTConfig()),
                             jax.random.PRNGKey(0))

    def port(tree):
        if isinstance(tree, dict):
            return {k: port(v) for k, v in tree.items()}
        return torch.empty(tuple(tree.shape), dtype=torch.bfloat16,
                           device="meta")

    return jshapes, port(jshapes)


def _metas():
    jshapes, pshapes = _gpt2_trees()
    return {"tree": (jshapes, pshapes),
            "meta": (JFSDP().meta(jshapes), FSDP().meta(pshapes))}


def test_gpt2_tree_and_meta_equal_jax():
    jshapes, pshapes = _gpt2_trees()
    jm, pm = JFSDP().meta(jshapes), FSDP().meta(pshapes)
    jl = jax.tree_util.tree_leaves(jm, is_leaf=lambda x: hasattr(x, "dtype")
                                   and hasattr(x, "shape"))
    from apex_tpu_torch.optimizers._common import tree_leaves

    pl = tree_leaves(pm)
    assert [(m.shape, m.dtype) for m in pl] == [(m.shape, m.dtype)
                                                for m in jl]
    assert sum(m.size for m in pl) == 124_475_904
    assert pacc.STRATEGIES == jacc.STRATEGIES
    assert pacc.SERVE_STRATEGIES == jacc.SERVE_STRATEGIES


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("form", ["tree", "meta"])
def test_hbm_models_equal_jax(form, world):
    j, p = _metas()[form]
    for strategy, mult in itertools.product(pacc.STRATEGIES, (1, 128, 256,
                                                              768)):
        assert pacc.hbm_params_bytes(p, strategy=strategy, world=world,
                                     shard_multiple=mult) == \
            jacc.hbm_params_bytes(j, strategy=strategy, world=world,
                                  shard_multiple=mult), (strategy, mult)
    for baseline in ("ddp", "zero1"):
        assert pacc.hbm_reduction(p, world=world, baseline=baseline) == \
            jacc.hbm_reduction(j, world=world, baseline=baseline)
    assert pacc.hbm_model_bytes(p) == jacc.hbm_model_bytes(j)
    for strategy, layers, kv in itertools.product(
            pacc.SERVE_STRATEGIES, (None, 12), (0.0, 3.5e8)):
        assert pacc.hbm_serve_bytes(
            p, strategy=strategy, world=world, kv_bytes=kv,
            num_layers=layers, shard_multiple=256) == jacc.hbm_serve_bytes(
            j, strategy=strategy, world=world, kv_bytes=kv,
            num_layers=layers, shard_multiple=256), (strategy, layers, kv)
    for fn in (pacc.hbm_params_bytes, pacc.hbm_serve_bytes):
        with pytest.raises(ValueError, match="strategy"):
            fn(p, strategy="zero3", world=world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("grad", list(CODECS))
def test_wire_models_equal_jax(grad, world):
    """``param_gather_wire_bytes``, ``fsdp_step_wire_bytes`` (remat 1, 2)
    and FSDP's ``gather_wire_bytes`` / ``reduce_wire_bytes`` under every
    pair of gradient and weight-gather codecs."""
    j, p = _metas()["meta"]
    pc, jc = _cfgs(grad)
    for wgname in CODECS:
        pw, jw = _cfgs(wgname)
        if (pc is not None and pc.error_feedback) or (
                pw is not None and pw.error_feedback):
            continue
        mult = FSDP(compression=pc, weight_gather=pw).shard_multiple
        assert mult == JFSDP(compression=jc, weight_gather=jw).shard_multiple
        assert pacc.param_gather_wire_bytes(p, world, pw, mult) == \
            jacc.param_gather_wire_bytes(j, world, jw, mult)
        for remat in (1, 2):
            assert pacc.fsdp_step_wire_bytes(
                p, world, pc, pw, mult, remat) == jacc.fsdp_step_wire_bytes(
                j, world, jc, jw, mult, remat)
        f, jf = (FSDP(compression=pc, weight_gather=pw),
                 JFSDP(compression=jc, weight_gather=jw))
        assert f.gather_wire_bytes(p, world) == jf.gather_wire_bytes(j, world)
        assert f.reduce_wire_bytes(p, world) == jf.reduce_wire_bytes(j, world)


@pytest.mark.parametrize("world", WORLDS)
def test_plan_accounting_equals_jax(world):
    """The plan's ``hbm_params_bytes`` / ``hbm_serve_bytes`` (its codecs'
    shard multiple, its serving strategy) on GPT-2's tree."""
    j, p = _metas()["tree"]
    for kw in PLANS:
        pk, jk = _pair(**kw)
        plan, jplan = ParallelismPlan(**pk), JPlan(**jk)
        assert plan.hbm_params_bytes(p, world) == jplan.hbm_params_bytes(
            j, world)
        try:
            want = jplan.hbm_serve_bytes(j, world, kv_bytes=1e8,
                                         num_layers=12)
        except (ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)):
                plan.hbm_serve_bytes(p, world, kv_bytes=1e8, num_layers=12)
            continue
        assert plan.hbm_serve_bytes(p, world, kv_bytes=1e8,
                                    num_layers=12) == want


def test_hbm_acceptance_numbers_equal_jax():
    """JAX's acceptance figures on its GPT fixture's shapes: 2.0x against
    DDP at dp = 2, ZeRO-1's leg 1.75x, growing with dp."""
    from apex_tpu_torch.fsdp import LeafMeta

    h, f, L, v, s = 64, 256, 2, 128, 32

    def leaf(*shape):
        return LeafMeta(shape, "float32")

    meta = {"embed": {"tok": leaf(v, h), "pos": leaf(s, h)},
            "layers": {"ln1_w": leaf(L, h), "ln1_b": leaf(L, h),
                       "qkv_kernel": leaf(L, h, 3 * h),
                       "qkv_bias": leaf(L, 3 * h),
                       "out_kernel": leaf(L, h, h), "out_bias": leaf(L, h),
                       "ln2_w": leaf(L, h), "ln2_b": leaf(L, h),
                       "fc1_kernel": leaf(L, h, f), "fc1_bias": leaf(L, f),
                       "fc2_kernel": leaf(L, f, h), "fc2_bias": leaf(L, h)},
             "head": {"ln_w": leaf(h), "ln_b": leaf(h)}}
    assert abs(pacc.hbm_reduction(meta, world=2) - 2.0) < 1e-6
    assert 1.7 <= pacc.hbm_reduction(meta, world=2, baseline="zero1") < 1.8
    assert pacc.hbm_reduction(meta, world=32, baseline="zero1") >= 5.0
    from apex_tpu.fsdp import LeafMeta as JLeafMeta

    jmeta = tree_map(lambda m: JLeafMeta(m.shape, m.dtype), meta)
    for world, base in itertools.product((2, 4, 8, 32), ("ddp", "zero1")):
        assert pacc.hbm_reduction(meta, world=world, baseline=base) == \
            jacc.hbm_reduction(jmeta, world=world, baseline=base)
