"""The port's GPT (and BERT) under tensor and sequence parallelism against
the JAX package's.

JAX runs ``gpt_loss`` inside ``jax.shard_map`` on 4 of the conftest's CPU
devices (the port's dp then JAX's) with ``gpt_param_specs`` (the pattern of
``tests/test_megatron_sp.py::_loss_and_grads``: the loss ``pmean``-ed
over every axis, ``jax.value_and_grad`` of the whole program, so the
gradients are the global tree); the port on 4 ``gloo`` ranks (one spawn
for every case): ``shard_params`` cuts the JAX-initialized global tree by
the port's ``gpt_param_specs``, each rank takes its sequence shard (sp;
BERT also its rows, dp, as JAX's BERT test feeds them), and
``gather_grads`` assembles the
global gradients. JAX's config: vocab 96, seq 32, hidden 64, 2 layers, 4
heads, fp32. Cases: tp = 2 and 4 (untied), ``megatron_sp`` (fused and
unfused loss), ``overlap_comm`` with and without it, tp 2 × sp 2 (ring
attention) plain and under ``megatron_sp``, dropout at tp = 2 under
``megatron_sp`` (threefry keys bitwise, the flash counter hash, the
hidden-dropout keys folding the tp rank), and BERT's ``megatron_sp`` at tp
= 2 with token types and padding (JAX's
``tests/test_models.py::test_bert_megatron_sp_matches_plain``). The loss
within rtol 1e-5 / atol 1e-6 and every gradient leaf within rtol 1e-4 /
atol 1e-5 of JAX's.

Tensor parallelism alone is exact in the loss; the ``shard_map``
programs here use ``check_vma=True`` (JAX's default). The JAX rows that
fail under jax 0.9 in this sandbox (ROADMAP §C: JAX's GPT trained inside
a mesh program with ``check_vma=False``, ``tests/test_overlap.py`` and
the EF training rows) are not used.
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
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.parallel.multiproc import spawn

import torch_tp_workers as workers

WORLD = 4
SIZES = dict(vocab_size=96, max_seq=32, hidden=64, num_layers=2,
             num_heads=4)
BERT_SIZES = dict(vocab_size=64, max_seq=16, hidden=32, num_layers=2,
                  num_heads=4, remat=False)
DROP = dict(megatron_sp=True, hidden_dropout=0.2, attention_dropout=0.1)
# name -> (model, fields, tp, sp, dropout seed)
CASES = {
    "tp2": ("gpt", {}, 2, 1, None),
    "tp4_untied": ("gpt", dict(tie_embeddings=False), 4, 1, None),
    "megatron_sp_tp2": ("gpt", dict(megatron_sp=True), 2, 1, None),
    "megatron_sp_tp2_unfused": ("gpt", dict(megatron_sp=True,
                                            fused_loss=False), 2, 1, None),
    "megatron_sp_tp4_untied": ("gpt", dict(megatron_sp=True,
                                           tie_embeddings=False), 4, 1,
                               None),
    "overlap_sp_tp2": ("gpt", dict(megatron_sp=True, overlap_comm=True), 2,
                       1, None),
    "overlap_tp4": ("gpt", dict(overlap_comm=True), 4, 1, None),
    "tp2_sp2": ("gpt", {}, 2, 2, None),
    "megatron_sp_tp2_sp2": ("gpt", dict(megatron_sp=True), 2, 2, None),
    "dropout_megatron_sp_tp2": ("gpt", DROP, 2, 1, 7),
    "bert_megatron_sp_tp2": ("bert", dict(megatron_sp=True), 2, 1, None),
}
B_GPT, B_BERT, S_BERT = 4, 8, 16


def _jcfg(model, fields):
    if model == "bert":
        return JBertConfig(dtype=jnp.float32, **BERT_SIZES, **fields)
    return JGPTConfig(dtype=jnp.float32, **SIZES, **fields)


def _bert_specs(cfg):
    specs = jgpt_param_specs(cfg)
    specs["embed"].update(type=P(), ln_w=P(), ln_b=P())
    specs["head"] = {k: P() for k in ("dense_kernel", "dense_bias", "ln_w",
                                      "ln_b")}
    return specs


@functools.lru_cache(maxsize=None)
def _inputs(model, untied):
    """JAX's initialization and batch (the JAX tests' keys)."""
    if model == "bert":
        cfg = _jcfg("bert", {})
        params = jinit_bert(jax.random.PRNGKey(6), cfg)
        batch = (jax.random.randint(jax.random.PRNGKey(7), (B_BERT, S_BERT),
                                    0, cfg.vocab_size),
                 jax.random.randint(jax.random.PRNGKey(8), (B_BERT, S_BERT),
                                    0, cfg.vocab_size),
                 (jax.random.uniform(jax.random.PRNGKey(9), (B_BERT, S_BERT))
                  < 0.3).astype(jnp.float32),
                 jax.random.randint(jax.random.PRNGKey(10),
                                    (B_BERT, S_BERT), 0, 2),
                 jnp.broadcast_to(jnp.arange(S_BERT)[None, :] >= 14,
                                  (B_BERT, S_BERT)))
    else:
        cfg = _jcfg("gpt", dict(tie_embeddings=not untied))
        params = jinit_gpt(jax.random.PRNGKey(0), cfg)
        tok = jax.random.randint(jax.random.PRNGKey(1), (B_GPT, 32), 0,
                                 cfg.vocab_size)
        batch = (tok, jnp.roll(tok, -1, axis=1))
    return (jax.tree.map(np.asarray, params),
            tuple(np.asarray(a) for a in batch))


def _port_cases():
    out = {}
    for name, (model, fields, tp, sp, seed) in CASES.items():
        params, batch = _inputs(model, not fields.get("tie_embeddings",
                                                      True))
        sizes = BERT_SIZES if model == "bert" else SIZES
        key = None if seed is None else np.asarray(jax.random.PRNGKey(seed))
        out[name] = (model, dict(dtype=torch.float32, **sizes, **fields),
                     tp, sp, key, params, batch)
    return out


PLAN_STEPS = 3


@functools.lru_cache(maxsize=None)
def _spawned():
    return spawn(workers.several, WORLD,
                 {"models": ("models", (_port_cases(),)),
                  "plan": ("plan_tp", (PLAN_STEPS,))})


@functools.lru_cache(maxsize=None)
def _jax(name):
    model, fields, tp, sp, seed = CASES[name]
    cfg = _jcfg(model, fields)
    params, batch = _inputs(model, not fields.get("tie_embeddings", True))
    mesh = build_mesh(tp=tp, pp=1, sp=sp, devices=jax.devices()[:WORLD])
    dkey = None if seed is None else jax.random.PRNGKey(seed)
    if model == "bert":
        specs = _bert_specs(cfg)
        data = (P("dp"),) * 5

        def body(p, tok, tgt, lm, tt, pm):
            return replicate_loss(jbert_mlm_loss(
                p, tok, tgt, lm, cfg, token_types=tt, padding_mask=pm),
                mesh, masked_axis=None)
    else:
        specs = jgpt_param_specs(cfg)
        data = (P(None, "sp"),) * 2

        def body(p, tok, tgt):
            return replicate_loss(jgpt_loss(p, tok, tgt, cfg,
                                            dropout_key=dkey),
                                  mesh, masked_axis=None)

    def loss_fn(p):
        return jax.shard_map(body, mesh=mesh, in_specs=(specs,) + data,
                             out_specs=P())(p, *batch)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), dict(named_leaves(jax.tree.map(np.asarray, grads)))


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _spawned())


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gathered_grads_match_jax(name):
    loss, grads = _jax(name)
    for rank, r in enumerate(_spawned()):
        pl, pg = r["models"][name]
        np.testing.assert_allclose(float(pl), loss, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} loss rank {rank}")
        got = dict(named_leaves(pg))
        assert set(got) == set(grads)
        for k, g in got.items():
            np.testing.assert_allclose(
                g.numpy(), grads[k], rtol=1e-4, atol=1e-5,
                err_msg=f"{name} d{k} rank {rank}")


def test_dropout_changes_the_loss_and_replays():
    """Dropout is on (the loss moves off the eval loss) and the port's
    masks are JAX's: the same key gives JAX's loss (above)."""
    base, _ = _jax("megatron_sp_tp2")
    drop, _ = _jax("dropout_megatron_sp_tp2")
    assert drop != base
    pl = float(_spawned()[0]["models"]["dropout_megatron_sp_tp2"][0])
    assert pl != base


def test_validate_matches_jax():
    """``GPTConfig.validate(tp, sp)``: JAX's errors, the MoE fields'
    (checked through ``MoEConfig``) included."""
    from apex_tpu_torch.transformer.testing import GPTConfig

    for fields, tp, sp in ((dict(max_seq=30, megatron_sp=True), 4, 1),
                           (dict(num_heads=6), 4, 1),
                           (dict(max_seq=36, overlap_comm=True), 4, 2)):
        with pytest.raises(ValueError) as je:
            dataclasses.replace(_jcfg("gpt", {}), **fields).validate(
                tp=tp, sp=sp)
        with pytest.raises(ValueError) as pe:
            GPTConfig(dtype=torch.float32, **{**SIZES, **fields}).validate(
                tp=tp, sp=sp)
        assert str(pe.value) == str(je.value)
    GPTConfig(num_experts=4).validate()
    with pytest.raises(ValueError) as je:
        dataclasses.replace(_jcfg("gpt", {}), num_experts=2,
                            moe_top_k=3).validate()
    with pytest.raises(ValueError) as pe:
        GPTConfig(num_experts=2, moe_top_k=3).validate()
    assert str(pe.value) == str(je.value)


def test_fsdp_tp_preset_trains_as_fsdp():
    """``ParallelismPlan.preset("fsdp+tp")`` through ``build_train_step``
    at dp 2 × tp 2 (``megatron_sp`` and ``overlap_comm`` on, each rank's
    qkv kernel its tp column shard, FSDP over dp of the shards): its
    losses are the ``fsdp`` preset's at dp 4 on the same batch within
    1e-5, falling."""
    for r in _spawned():
        fsdp, both = r["plan"]["fsdp"], r["plan"]["fsdp+tp"]
        assert both["mesh"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
        assert fsdp["mesh"]["dp"] == 4
        assert both["qkv_shape"] == (2, 64, 96)
        np.testing.assert_allclose(both["losses"], fsdp["losses"],
                                   rtol=1e-5, atol=1e-5)
        assert both["losses"][-1] < both["losses"][0]


def _jax_fsdp_tp(tok, tgt):
    """JAX's GPT with the ``fsdp+tp`` preset's overrides (JAX's
    ``ParallelismPlan.gpt_overrides``) on a dp 2 × tp 2 mesh, from the
    port's initial global tree and batch (every dp rank's rows are the
    same batch, as ``build_train_step`` gives each rank): the loss and
    global gradients of the ``_loss_and_grads`` pattern (``shard_map``
    with ``check_vma=True``), then ``FusedAdam(lr=1e-4)`` on the global
    tree, PLAN_STEPS times -> (losses, first gradients). The FSDP step's
    arithmetic is that update: ``FSDPAdam`` averages the dp-summed shard
    gradients and its AdamW tail is elementwise on the fp32 masters.
    JAX's own in-program FSDP step (``benchmarks/bench_fsdp.py``) runs
    with ``check_vma=False``, where JAX 0.9 trains GPT differently in
    this suite (ROADMAP §C), so it is not the reference."""
    from apex_tpu.optimizers import FusedAdam as JFusedAdam
    from apex_tpu.parallel import ParallelismPlan as JPlan
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    over = JPlan.preset("fsdp+tp").gpt_overrides()
    sizes = dict(vocab_size=128, max_seq=32, hidden=64, num_layers=2,
                 num_heads=4)
    jcfg = JGPTConfig(dtype=jnp.float32, **sizes, **over)
    p0 = init_gpt_params(GPTConfig(dtype=torch.float32, **sizes, **over),
                         seed=0, device="cpu")
    params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), p0)
    mesh = build_mesh(tp=2, pp=1, sp=1, devices=jax.devices()[:WORLD])
    batch = tuple(jnp.asarray(np.concatenate([a, a])) for a in (tok, tgt))

    def body(p, t, y):
        return replicate_loss(jgpt_loss(p, t, y, jcfg), mesh,
                              masked_axis=None)

    def loss_fn(p):
        return jax.shard_map(body, mesh=mesh,
                             in_specs=(jgpt_param_specs(jcfg), P("dp"),
                                       P("dp")),
                             out_specs=P())(p, *batch)

    tx = JFusedAdam(lr=1e-4, fused_tail="off")

    @jax.jit
    def step(p, st):
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, st = tx.update(g, st, p)
        return jax.tree.map(lambda a, u: a + u, p, upd), st, loss, g

    st, losses, first = tx.init(params), [], None
    for _ in range(PLAN_STEPS):
        params, st, loss, g = step(params, st)
        losses.append(float(loss))
        first = first or dict(named_leaves(jax.tree.map(np.asarray, g)))
    return losses, first


def test_fsdp_tp_preset_matches_jax():
    """The ``fsdp+tp`` preset's first loss and its first step's gathered
    gradients (the FSDP gather's, averaged over dp) against JAX's GPT
    with the preset's overrides on a dp 2 × tp 2 mesh (loss rtol 1e-5 /
    atol 1e-6, gradients rtol 1e-4 / atol 1e-5), and its PLAN_STEPS
    losses against JAX's under the same AdamW within 1e-5."""
    r0 = _spawned()[0]["plan"]["fsdp+tp"]
    losses, grads = _jax_fsdp_tp(r0["tok"].numpy(), r0["tgt"].numpy())
    for rank, r in enumerate(_spawned()):
        both = r["plan"]["fsdp+tp"]
        np.testing.assert_allclose(both["first_loss"], losses[0], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {rank}")
        np.testing.assert_allclose(both["losses"], losses, rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {rank}")
        got = dict(named_leaves(both["grads"]))
        assert set(got) == set(grads)
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), grads[k], rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"d{k} rank {rank}")
