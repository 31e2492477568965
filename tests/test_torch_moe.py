"""The port's mixture of experts (``transformer/moe.py``) and its wiring in
GPT, BERT and the 1F1B schedule against the JAX package's.

The same numpy inputs go through JAX's functions (inside ``jax.shard_map``
on the conftest's CPU devices, jitted) and the port's, fp32 at tiny
widths (hidden 16 / 32). In this process, at one rank: ``moe_mlp`` (the
output, each aux entry, the gradients of x and of every parameter within
1e-5), a tight capacity (the same rows dropped, zero where JAX's are), a
zero router (the top-k ties go to the lower expert index), GPT's
single-expert identity, the router's fp32 through ``params_from_numpy``,
``MoEConfig``'s checks and the serve refusal. On 4 ``gloo`` ranks (one
spawn for the file, rank functions in ``tests/torch_moe_workers.py``):
``moe_mlp`` at ep = 4 against JAX's dp-4 program and the port's ep = 1
on the global batch; GPT with 4 experts at dp 4 (loss and every gathered
gradient leaf within rtol 1e-5 / atol 1e-6, then three ``FusedAdam``
steps, the losses falling), at dp 2 × tp 2 (tp-split experts, under
``megatron_sp``, and with ``moe_seq_dispatch``), BERT with 4 experts at
dp 4, and 1F1B at pp 2 × dp 2 against the port's sequential
``gpt_loss`` at 1e-4 (JAX's tolerance), the router's gradient nonzero.
The dispatch and combine are the one-hot contractions JAX runs, their
one-hot tensors built by comparing each token's slot with an arange:
bitwise those of the plain ``(E, k) @ (k, C)`` products, forward and
backward.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.serve.decode import ensure_dense_ffn as jensure_dense_ffn
from apex_tpu.transformer import moe as jmoe
from apex_tpu.transformer.pipeline_parallel.schedules.common import (
    replicate_loss,
)
from apex_tpu.transformer.testing import (
    BertConfig as JBertConfig,
    GPTConfig as JGPTConfig,
    bert_mlm_loss as jbert_mlm_loss,
    gpt_loss as jgpt_loss,
    gpt_param_specs as jgpt_param_specs,
    init_bert_params as jinit_bert,
    init_gpt_params as jinit_gpt,
)
from apex_tpu_torch.convert import named_leaves, params_from_numpy
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer import moe
from apex_tpu_torch.transformer.testing import (
    GPTConfig,
    gpt_loss,
    gpt_params_from_numpy,
    gpt_pipeline_params,
    gpt_pipeline_params_numpy,
    init_gpt_params,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    init_gpt_params_numpy,
)

import torch_moe_workers as workers

WORLD = 4
HID, FFN = 16, 32
LAYER = dict(num_experts=4, hidden=HID, ffn_hidden=FFN, top_k=2)
GPT_SIZES = dict(vocab_size=96, max_seq=16, hidden=32, num_layers=2,
                 num_heads=4)
BERT_SIZES = dict(vocab_size=64, max_seq=16, hidden=32, num_layers=2,
                  num_heads=4, remat=False)
MOE = dict(num_experts=4, moe_capacity_factor=4.0)
B = 8
# name -> (model, cfg fields, tp, steps)
CASES = {
    "gpt_dp4": ("gpt", MOE, 1, 3),
    "gpt_dp2_tp2": ("gpt", MOE, 2, 0),
    "gpt_dp2_tp2_megatron_sp": ("gpt", dict(MOE, megatron_sp=True), 2, 0),
    "gpt_dp2_tp2_seq_dispatch": ("gpt", dict(MOE, megatron_sp=True,
                                             moe_seq_dispatch=True), 2, 0),
    "bert_dp4": ("bert", MOE, 1, 0),
}
PIPE = dict(GPT_SIZES, tie_embeddings=False, num_experts=4,
            moe_capacity_factor=8.0)


def _jmoe_cfg(**kw):
    return jmoe.MoEConfig(**{**LAYER, "capacity_factor": 8.0,
                             "dtype": jnp.float32, **kw})


def _pmoe_cfg(**kw):
    return moe.MoEConfig(**{**LAYER, "capacity_factor": 8.0,
                            "dtype": torch.float32, **kw})


def _layer_params(seed=0, biases=True):
    p = moe.init_moe_params_numpy(_pmoe_cfg(), seed=seed)
    if biases:  # nonzero biases, so their gradients are checked too
        rng = np.random.default_rng(seed + 1)
        for k in ("fc1_bias", "fc2_bias"):
            p[k] = rng.standard_normal(p[k].shape).astype(np.float32) * 0.1
    return p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_layer(cfg, params, x, ep_axis=None, world=1):
    """JAX's ``moe_mlp`` on a ``world``-device mesh (rows of x over dp):
    the output, the aux dict (rank 0's), and the gradients of params and
    x of ``mean_dp(sum(out ** 2) + aux["loss"])``."""
    mesh = build_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:world])
    specs = jmoe.moe_param_specs(ep_axis)

    def body(p, xb):
        out, aux = jmoe.moe_mlp(p, xb, cfg, ep_axis=ep_axis)
        return out, jax.tree.map(lambda a: a[None], aux)

    prog = jax.shard_map(body, mesh=mesh, in_specs=(specs, P("dp")),
                         out_specs=(P("dp"), P("dp")))

    def obj(p, xx):
        out, aux = prog(p, xx)
        return (jnp.sum(out * out) + jnp.sum(aux["loss"])) / world

    jp = jax.tree.map(jnp.asarray, params)
    out, aux = jax.jit(prog)(jp, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(obj, argnums=(0, 1)))(jp, jnp.asarray(x))
    return (np.asarray(out), {k: np.asarray(v) for k, v in aux.items()},
            jax.tree.map(np.asarray, gp), np.asarray(gx))


# ---------------------------------------------------------------------------
# the layer at one rank


def test_moe_mlp_matches_jax():
    """``moe_mlp`` at ep = None: the output, every aux entry and the
    gradients of x and of every parameter within 1e-5 of JAX's."""
    params, x = _layer_params(), _x((2, 12, HID))
    cfg = dict(capacity_factor=1.25)
    out_j, aux_j, gp_j, gx_j = _jax_layer(_jmoe_cfg(**cfg), params, x)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_mlp(pt, xt, _pmoe_cfg(**cfg), ep_axis=None)
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-5,
                               atol=1e-6)
    assert set(aux) == set(aux_j)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), aux_j[k][0], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ((out * out).sum() + aux["loss"]).backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(pt[k].grad.numpy(), gp_j[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert pt["router"].dtype == torch.float32


def test_tight_capacity_drops_the_rows_jax_drops():
    """Capacity 1 with a router that sends every token to expert 0: the
    port's output is zero exactly where JAX's is, the kept rows equal."""
    params = _layer_params()
    params["router"] = np.zeros_like(params["router"])
    params["router"][0, 0] = 100.0
    x = np.ones((1, 6, HID), np.float32)
    cfg = dict(top_k=1, capacity_factor=1e-9)
    out_j, aux_j, _, _ = _jax_layer(_jmoe_cfg(**cfg), params, x)
    out, aux = moe.moe_mlp({k: torch.tensor(v) for k, v in params.items()},
                           torch.tensor(x), _pmoe_cfg(**cfg), ep_axis=None)
    out = out.numpy()
    assert moe.MoEConfig(**{**LAYER, **cfg}).capacity(6) == 1
    np.testing.assert_array_equal(out == 0.0, out_j == 0.0)
    assert np.all(out[0, 1:] == 0.0) and np.any(out[0, 0] != 0.0)
    np.testing.assert_allclose(out, out_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["fraction_kept"]),
                               aux_j["fraction_kept"][0], rtol=1e-6)


def test_zero_router_ties_take_the_lower_expert():
    """A zero router makes every probability equal: JAX's ``lax.top_k``
    takes experts 0 and 1, and so does the port (a stable sort), so the
    outputs agree."""
    probs = torch.full((5, 4), 0.25)
    _, idx = moe.top_k_lower_index(probs, 2)
    assert idx.tolist() == [[0, 1]] * 5
    params = _layer_params()
    params["router"] = np.zeros_like(params["router"])
    x = _x((1, 8, HID), seed=3)
    out_j, aux_j, _, _ = _jax_layer(_jmoe_cfg(), params, x)
    out, aux = moe.moe_mlp({k: torch.tensor(v) for k, v in params.items()},
                           torch.tensor(x), _pmoe_cfg(), ep_axis=None)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["lb_loss"]), aux_j["lb_loss"][0],
                               rtol=1e-6)


def test_route_builds_the_one_hot_products_bitwise():
    """``_route`` builds dispatch and combine by comparing each token's
    slot an expert with an arange, after a last-dim scan of the
    selection: bitwise the one-hot products of the plain form (a scan
    over the (k·T, E) rows, then ``(E, k) @ (k, C)`` for every token), in
    the forward and in the gradient of the logits, at a capacity that
    drops rows."""
    t, e, k, cap = 48, 4, 2, 13
    logits = torch.tensor(_x((t, e), seed=5) * 2.0, requires_grad=True)
    dispatch, combine, _ = moe._route(logits, k, cap)
    assert 0.0 < float(dispatch.sum()) < t * k
    w = torch.tensor(_x((t, e, cap), seed=6))
    (g,) = torch.autograd.grad((combine * w).sum(), logits)

    ref_logits = logits.detach().clone().requires_grad_()
    probs = torch.softmax(ref_logits, dim=-1)
    gate, idx = moe.top_k_lower_index(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(idx, e).float()
    sel = onehot.transpose(0, 1).reshape(k * t, e)
    pos = (torch.cumsum(sel, dim=0) - sel).reshape(k, t, e).transpose(0, 1)
    keep = onehot * (pos < cap)
    slot_oh = torch.nn.functional.one_hot(
        (pos * keep).sum(-1).long(), cap).float()
    ref_dispatch = torch.bmm(keep.transpose(1, 2), slot_oh)
    ref_combine = torch.bmm(keep.transpose(1, 2), slot_oh * gate[..., None])
    (ref_g,) = torch.autograd.grad((ref_combine * w).sum(), ref_logits)
    assert torch.equal(dispatch, ref_dispatch)
    assert torch.equal(combine.detach(), ref_combine.detach())
    assert torch.equal(g, ref_g)


def test_moe_config_checks_match_jax():
    for kw in (dict(top_k=5), dict(top_k=3, num_experts=2)):
        full = {**LAYER, **kw}
        with pytest.raises(ValueError) as je:
            jmoe.MoEConfig(**full)
        with pytest.raises(ValueError) as pe:
            moe.MoEConfig(**full)
        assert str(pe.value) == str(je.value)
    for tokens in (1, 6, 13, 64, 100, 8192):
        for factor in (1e-9, 0.5, 1.0, 1.25, 8.0):
            for k, e in ((1, 1), (2, 8), (2, 4)):
                kw = dict(num_experts=e, hidden=8, ffn_hidden=8, top_k=k,
                          capacity_factor=factor)
                assert (moe.MoEConfig(**kw).capacity(tokens)
                        == jmoe.MoEConfig(**kw).capacity(tokens))
    with pytest.raises(ValueError) as pe:
        GPTConfig(num_experts=2, moe_top_k=3).validate()
    with pytest.raises(ValueError) as je:
        JGPTConfig(num_experts=2, moe_top_k=3).validate()
    assert str(pe.value) == str(je.value)


def test_param_tree_and_specs_match_jax():
    cfg = GPTConfig(dtype=torch.float32, **GPT_SIZES, num_experts=4)
    jcfg = JGPTConfig(dtype=jnp.float32, **GPT_SIZES, num_experts=4)
    got = dict(named_leaves(init_gpt_params_numpy(cfg)))
    want = dict(named_leaves(jax.eval_shape(
        lambda: jinit_gpt(jax.random.PRNGKey(0), jcfg))))
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    from apex_tpu_torch.transformer.testing import gpt_param_specs

    pspecs = dict(named_leaves(gpt_param_specs(cfg)))
    jspecs = dict(named_leaves(jax.tree.map(
        tuple, jgpt_param_specs(jcfg),
        is_leaf=lambda s: isinstance(s, P))))
    assert {k: tuple(v) for k, v in pspecs.items()} == {
        k: tuple(v) for k, v in jspecs.items()}


def test_router_stays_fp32_in_a_bf16_model():
    """The model's conversions (``init_gpt_params``,
    ``gpt_params_from_numpy`` of JAX's tree, ``gpt_pipeline_params``,
    ``init_moe_params``) cast every floating leaf to bfloat16 but the
    router, which they convert from the fp32 arrays (JAX initialises it
    fp32 whatever the model dtype); ``params_from_numpy`` casts every
    floating leaf alike."""
    cfg = GPTConfig(**GPT_SIZES, num_experts=4)
    params = init_gpt_params(cfg, device="cpu")
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["fc1_kernel"].dtype == torch.bfloat16
    jp = jinit_gpt(jax.random.PRNGKey(0), JGPTConfig(**GPT_SIZES,
                                                     num_experts=4))
    assert jp["layers"]["router"].dtype == jnp.float32
    np_tree = jax.tree.map(np.asarray, jp)
    tree = gpt_params_from_numpy(np_tree, cfg, "cpu")
    assert tree["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tree["layers"]["router"].numpy(),
                                  np_tree["layers"]["router"])
    assert tree["layers"]["qkv_kernel"].dtype == torch.bfloat16
    assert params_from_numpy(np_tree, "cpu", dtype=torch.bfloat16)[
        "layers"]["router"].dtype == torch.bfloat16
    pcfg = GPTConfig(**PIPE)
    stages = gpt_pipeline_params(pcfg, 2, device="cpu")["stages"]
    assert stages["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        stages["router"].numpy(),
        gpt_pipeline_params_numpy(pcfg, 2)["stages"]["router"][0])
    assert stages["fc2_kernel"].dtype == torch.bfloat16
    layer = moe.init_moe_params(moe.MoEConfig(**LAYER), device="cpu")
    assert layer["router"].dtype == torch.float32
    assert layer["fc2_kernel"].dtype == torch.bfloat16
    tok = torch.randint(0, 96, (2, 16))
    loss = gpt_loss(params, tok, tok, cfg)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))


def test_single_expert_gpt_is_the_dense_gpt_plus_the_router_loss():
    """JAX's identity: one expert, top-1, a zero router and ample capacity
    is the dense GPT plus ``lb_loss_weight`` (lb = 1 at E = 1, z = 0),
    loss and gradients of the shared leaves."""
    dense_cfg = GPTConfig(dtype=torch.float32, **GPT_SIZES)
    moe_cfg = dataclasses.replace(dense_cfg, num_experts=1, moe_top_k=1,
                                  moe_capacity_factor=64.0)
    dense = init_gpt_params_numpy(dense_cfg, seed=0)
    tree = init_gpt_params_numpy(moe_cfg, seed=0)
    for k, v in dense["layers"].items():
        tree["layers"][k] = v[:, None] if k.startswith("fc") else v
    tree["layers"]["router"] = np.zeros_like(tree["layers"]["router"])
    tree["embed"], tree["head"] = dense["embed"], dense["head"]
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (2, 16)))
    tgt = torch.roll(tok, -1, 1)
    runs = []
    for cfg, p in ((dense_cfg, dense), (moe_cfg, tree)):
        pt = params_from_numpy(p, "cpu")
        leaves = [t.requires_grad_() for _, t in named_leaves(pt)]
        loss = gpt_loss(pt, tok, tgt, cfg)
        runs.append((loss.item(), dict(zip(
            [n for n, _ in named_leaves(pt)],
            torch.autograd.grad(loss, leaves)))))
    (l_dense, g_dense), (l_moe, g_moe) = runs
    weight = moe.MoEConfig(num_experts=1, hidden=32, ffn_hidden=128,
                           top_k=1).lb_loss_weight
    np.testing.assert_allclose(l_moe - weight, l_dense, rtol=1e-5, atol=1e-6)
    for k, g in g_dense.items():
        gm = g_moe[k][:, 0] if k.startswith("layers.fc") else g_moe[k]
        np.testing.assert_allclose(gm.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_serve_refuses_experts_with_jax_text():
    """Serving stays dense: every serve entry point refuses experts with
    JAX's ``ensure_dense_ffn`` text."""
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig
    from apex_tpu_torch.serve.decode import ensure_dense_ffn

    with pytest.raises(NotImplementedError) as je:
        jensure_dense_ffn(4)
    with pytest.raises(NotImplementedError) as pe:
        ensure_dense_ffn(4)
    assert str(pe.value) == str(je.value)
    ensure_dense_ffn(0)
    cfg = GPTConfig(dtype=torch.float32, **GPT_SIZES, num_experts=2)
    params = init_gpt_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        InferenceEngine(params, cfg, ServeConfig(num_slots=1, block_size=8),
                        device="cpu")


# ---------------------------------------------------------------------------
# ranks (one spawn for the file)


@functools.lru_cache(maxsize=None)
def _layer_inputs():
    return _layer_params(seed=5), _x((8, 6, HID), seed=6)


@functools.lru_cache(maxsize=None)
def _inputs(model):
    if model == "bert":
        cfg = JBertConfig(dtype=jnp.float32, **BERT_SIZES, **MOE)
        params = jinit_bert(jax.random.PRNGKey(6), cfg)
        batch = (jax.random.randint(jax.random.PRNGKey(7), (B, 16), 0, 64),
                 jax.random.randint(jax.random.PRNGKey(8), (B, 16), 0, 64),
                 (jax.random.uniform(jax.random.PRNGKey(9), (B, 16))
                  < 0.5).astype(jnp.float32))
    else:
        cfg = JGPTConfig(dtype=jnp.float32, **GPT_SIZES, **MOE)
        params = jinit_gpt(jax.random.PRNGKey(0), cfg)
        tok = jax.random.randint(jax.random.PRNGKey(1), (B, 16), 0, 96)
        batch = (tok, jnp.roll(tok, -1, 1))
    return (jax.tree.map(np.asarray, params),
            tuple(np.asarray(a) for a in batch))


def _port_cases():
    out = {}
    for name, (model, fields, tp, steps) in CASES.items():
        sizes = BERT_SIZES if model == "bert" else GPT_SIZES
        params, batch = _inputs(model)
        out[name] = (model, dict(dtype=torch.float32, **sizes, **fields), tp,
                     params, batch, steps)
    return out


@functools.lru_cache(maxsize=None)
def _pipe_inputs():
    cfg = GPTConfig(dtype=torch.float32, **PIPE)
    params = gpt_pipeline_params_numpy(cfg, pp=2, seed=3)
    tok = np.random.default_rng(4).integers(0, 96, (B, 16))
    return params, (tok, np.roll(tok, -1, 1))


@functools.lru_cache(maxsize=None)
def _spawned():
    lp, lx = _layer_inputs()
    pp, pb = _pipe_inputs()
    return spawn(workers.several, WORLD, {
        "layer": ("moe_layer", (dict(LAYER, capacity_factor=8.0), lp, lx)),
        "models": ("gpt", (_port_cases(),)),
        "pipeline": ("pipeline", (dict(dtype=torch.float32, **PIPE), pp,
                                  pb, 2))})


def _bert_specs(cfg):
    specs = jgpt_param_specs(cfg)
    specs["embed"].update(type=P(), ln_w=P(), ln_b=P())
    specs["head"] = {k: P() for k in ("dense_kernel", "dense_bias", "ln_w",
                                      "ln_b")}
    return specs


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's loss and global gradients (``shard_map`` on a dp × tp mesh of
    4 devices, the batch rows over dp, the loss averaged over every
    axis)."""
    model, fields, tp, _ = CASES[name]
    params, batch = _inputs(model)
    mesh = build_mesh(tp=tp, pp=1, sp=1, devices=jax.devices()[:WORLD])
    if model == "bert":
        cfg = JBertConfig(dtype=jnp.float32, **BERT_SIZES, **fields)
        specs = _bert_specs(cfg)

        def body(p, *b):
            return replicate_loss(jbert_mlm_loss(p, *b, cfg), mesh,
                                  masked_axis=None)
    else:
        cfg = JGPTConfig(dtype=jnp.float32, **GPT_SIZES, **fields)
        specs = jgpt_param_specs(cfg)

        def body(p, *b):
            return replicate_loss(jgpt_loss(p, *b, cfg), mesh,
                                  masked_axis=None)

    def loss_fn(p):
        return jax.shard_map(body, mesh=mesh,
                             in_specs=(specs,) + (P("dp"),) * len(batch),
                             out_specs=P())(p, *batch)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), dict(named_leaves(jax.tree.map(np.asarray, grads)))


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _spawned())


def test_ep4_matches_jax_and_ep1():
    """``moe_mlp`` with its 4 experts over 4 dp ranks (one all-to-all each
    way): the output, the router loss and the gradients against JAX's dp-4
    program; the output against the port's ep = 1 on the global batch
    (ample capacity: nothing is dropped either way)."""
    params, x = _layer_inputs()
    cfg = _jmoe_cfg()
    out_j, aux_j, gp_j, _ = _jax_layer(cfg, params, x, ep_axis="dp",
                                       world=WORLD)
    ref, _ = moe.moe_mlp({k: torch.tensor(v) for k, v in params.items()},
                         torch.tensor(x), _pmoe_cfg(), ep_axis=None)
    for rank, r in enumerate(_spawned()):
        out, loss, grads = r["layer"]
        np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(loss), aux_j["loss"].mean(),
                                   rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), gp_j[k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} rank {rank}")


@pytest.mark.parametrize("name", list(CASES))
def test_models_match_jax(name):
    """Loss and every gathered gradient leaf within rtol 1e-5 / atol 1e-6
    of JAX's (the experts gathered along E over dp, not summed); with
    steps, three ``FusedAdam`` steps on each rank's slice of the global
    gradient: the first loss JAX's, the losses finite and falling."""
    loss, grads = _jax(name)
    for rank, r in enumerate(_spawned()):
        pl, pg, plosses = r["models"][name]
        np.testing.assert_allclose(float(pl), loss, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} loss rank {rank}")
        got = dict(named_leaves(pg))
        assert set(got) == set(grads)
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), grads[k], rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"{name} d{k} rank {rank}")
        if CASES[name][3]:
            assert len(plosses) == CASES[name][3] + 1
            np.testing.assert_allclose(plosses[0], loss, rtol=1e-5)
            assert np.all(np.isfinite(plosses))
            assert plosses[-1] < plosses[0]
    assert np.any(grads["layers.router"] != 0.0)


def test_1f1b_matches_the_sequential_loss():
    """MoE through 1F1B at pp 2 × dp 2 (each stage's router loss averaged
    in through ``stage_aux``, the experts' gradients not summed over dp):
    the loss and every gradient leaf (the experts' dp shards and the
    router of each rank's stage, embed and head) within 1e-4 of the
    port's sequential ``gpt_loss`` on the same weights and rows, its
    gradient gathered at dp 4; the router gradient nonzero on every
    stage."""
    for rank, r in enumerate(_spawned()):
        loss, ref, got, want = r["pipeline"]
        np.testing.assert_allclose(loss, ref, rtol=1e-4)
        assert set(got) == set(want)
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"d{k} rank {rank}")
        assert torch.any(got["stages.router"] != 0.0)
        assert torch.isfinite(got["stages.router"]).all()
