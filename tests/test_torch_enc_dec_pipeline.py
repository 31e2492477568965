"""The port's encoder-decoder pipeline schedule against the JAX
package's, held to ``tests/test_enc_dec_pipeline.py``.

JAX's drivers run under ``jax.jit`` on 2 of the conftest's CPU devices
(pp 2); the port's on 2 ``gloo`` ranks (``tests/torch_pp_workers.py``,
one spawn), each rank on its local tree of JAX's parameters (one encoder
and one decoder chunk). JAX's toy enc-dec spec (HID 8, encoder 6 and
decoder 4 tokens, a one-head cross-attention in the decoder stage) at M
4, through ``forward_backward_pipelining_enc_dec`` and through the
uniform 1F1B driver (the spec type dispatches), and T5 (hidden 32, 2 + 2
layers, 4 heads, vocab 64) through ``t5_enc_dec_spec`` at M 2 with
absolute positions and with the relative bias and encoder-final LN (the
per-stage copies), and on 4 ranks at pp 2 × tp 2 with and without
Megatron-SP: the loss within rtol 1e-5 and every rank's gradients within
JAX's test tolerance (toy: rtol 2e-4, atol 1e-6; T5: rtol 1e-4, atol
1e-5). The interleaved driver's refusal and the split-rank
bookkeeping at pp 2.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.pipeline_parallel.schedules import (
    EncDecPipelineSpec as JEncDecSpec,
    build_model as jbuild_model,
    forward_backward_pipelining_enc_dec as jenc_dec,
    forward_backward_pipelining_with_interleaving as jinterleaved,
)
from apex_tpu.transformer.testing import (
    T5Config as JT5Config,
    t5_enc_dec_spec as jt5_enc_dec_spec,
    t5_pipeline_params as jt5_pipeline_params,
    t5_pipeline_specs_tree as jt5_pipeline_specs_tree,
)
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.parallel.multiproc import spawn

import torch_pp_workers as workers

WORLD = 2
HID, B, SEQ_ENC, SEQ_DEC = workers.HID, 16, 6, 4
T5_SIZES = dict(vocab_size=64, hidden=32, num_heads=4, enc_layers=2,
                dec_layers=2, max_seq_enc=16, max_seq_dec=8,
                fused_loss=False)
T5_CASES = {"t5_abs": {},
            "t5_rel_ln": dict(relative_position_bias=True,
                              encoder_final_ln=True)}
# pp 2 × tp 2 on 4 ranks: name -> T5Config fields
T5_TP_CASES = {"t5_tp2": dict(relative_position_bias=True,
                              encoder_final_ln=True),
               "t5_tp2_megatron_sp": dict(relative_position_bias=True,
                                          encoder_final_ln=True,
                                          megatron_sp=True)}


def jtoy_spec():
    """JAX's toy enc-dec spec (``tests/test_enc_dec_pipeline.py:_spec``)."""
    def enc_embed_fn(ep, x):
        return x @ ep["we"]

    def enc_stage_fn(sp, h):
        return jnp.tanh(h @ sp["w"] + sp["b"])

    def dec_embed_fn(ep, x):
        return x @ ep["wd"]

    def dec_stage_fn(sp, h, mem):
        att = jax.nn.softmax(
            (h @ sp["wq"]) @ (mem @ sp["wk"]).transpose(0, 2, 1)
            / jnp.sqrt(jnp.float32(HID)), axis=-1)
        return jnp.tanh(h @ sp["w"] + att @ (mem @ sp["wv"]) + sp["b"])

    def loss_fn(hp, h, tgt):
        return jnp.mean((h @ hp["w"] - tgt) ** 2)

    return JEncDecSpec(enc_embed_fn, enc_stage_fn, dec_embed_fn,
                       dec_stage_fn, loss_fn)


@functools.lru_cache(maxsize=None)
def _toy_inputs():
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)

    def enc_init(key, c):
        kw, kb = jax.random.split(key)
        return {"w": jax.random.normal(kw, (HID, HID)) * 0.3,
                "b": jax.random.normal(kb, (HID,)) * 0.1}

    def dec_init(key, c):
        ks = jax.random.split(key, 5)
        return {"w": jax.random.normal(ks[0], (HID, HID)) * 0.3,
                "b": jax.random.normal(ks[1], (HID,)) * 0.1,
                "wq": jax.random.normal(ks[2], (HID, HID)) * 0.3,
                "wk": jax.random.normal(ks[3], (HID, HID)) * 0.3,
                "wv": jax.random.normal(ks[4], (HID, HID)) * 0.3}

    params = {"embed": {"we": jax.random.normal(k1, (HID, HID)) * 0.3,
                        "wd": jax.random.normal(k2, (HID, HID)) * 0.3},
              "enc_stages": jbuild_model(enc_init, k3, WORLD),
              "dec_stages": jbuild_model(dec_init, k4, WORLD),
              "head": {"w": jax.random.normal(k3, (HID, HID)) * 0.3}}
    ke, kd, kt = jax.random.split(jax.random.PRNGKey(1), 3)
    batch = (jax.random.normal(ke, (B, SEQ_ENC, HID)),
             jax.random.normal(kd, (B, SEQ_DEC, HID)),
             jax.random.normal(kt, (B, SEQ_DEC, HID)))
    return (jax.tree.map(np.asarray, params),
            tuple(np.array(a) for a in batch))


def _t5_fields(name):
    return {**T5_CASES, **T5_TP_CASES}[name]


@functools.lru_cache(maxsize=None)
def _t5_inputs(name):
    cfg = JT5Config(dtype=jnp.float32, **T5_SIZES, **_t5_fields(name))
    params = jt5_pipeline_params(jax.random.PRNGKey(4), cfg, pp=WORLD)
    k = jax.random.PRNGKey(5)
    enc = jax.random.randint(k, (4, cfg.max_seq_enc), 0, cfg.vocab_size)
    dec = jax.random.randint(jax.random.fold_in(k, 1), (4, cfg.max_seq_dec),
                             0, cfg.vocab_size)
    return (jax.tree.map(np.asarray, params),
            tuple(np.asarray(a) for a in (enc, dec, jnp.roll(dec, -1, 1))))


@functools.lru_cache(maxsize=None)
def _spawned():
    params, batch = _toy_inputs()
    cases = {"toy": dict(spec="toy_enc_dec", kind="enc_dec", pp=WORLD, M=4,
                         params=params, batch=batch),
             "toy_uniform": dict(spec="toy_enc_dec", kind="1f1b", pp=WORLD,
                                 M=4, params=params, batch=batch)}
    for name, fields in T5_CASES.items():
        p, b = _t5_inputs(name)
        cases[name] = dict(spec=("t5", {**T5_SIZES, **fields}),
                           kind="enc_dec", pp=WORLD, M=2, params=p, batch=b)
    toys = {k: cases[k] for k in ("toy", "toy_uniform")}
    return spawn(workers.several, WORLD, {
        "schedules": ("schedules", (cases,)),
        "head_calls": ("head_calls", (toys,)),
        "refusal": ("interleaved_refusal", (params, batch)),
        "split": ("split_ranks", ())})


@functools.lru_cache(maxsize=None)
def _spawned_tp():
    cases = {}
    for name, fields in T5_TP_CASES.items():
        p, b = _t5_inputs(name)
        cases[name] = dict(spec=("t5", {**T5_SIZES, **fields}),
                           kind="enc_dec", pp=WORLD, tp=2, M=2, params=p,
                           batch=b)
    return spawn(workers.several, 2 * WORLD,
                 {"schedules": ("schedules", (cases,))})


def _mesh(tp=1):
    jps.destroy_model_parallel()
    return jps.initialize_model_parallel(
        tensor_model_parallel_size_=tp,
        pipeline_model_parallel_size_=WORLD,
        pipeline_model_parallel_split_rank_=1,
        devices=jax.devices()[:WORLD * tp])


@functools.lru_cache(maxsize=None)
def _jax(name):
    mesh = _mesh(2 if name in T5_TP_CASES else 1)
    if name == "toy":
        params, batch = _toy_inputs()
        fn = jax.jit(lambda p: jenc_dec(jtoy_spec(), p, batch,
                                        num_microbatches=4, mesh=mesh))
    else:
        params, batch = _t5_inputs(name)
        cfg = JT5Config(dtype=jnp.float32, **T5_SIZES, **_t5_fields(name))
        fn = jax.jit(lambda p: jenc_dec(
            jt5_enc_dec_spec(cfg), p, batch, num_microbatches=2, mesh=mesh,
            params_specs=jt5_pipeline_specs_tree(cfg)))
    loss, grads = fn(jax.tree.map(jnp.asarray, params))
    jps.destroy_model_parallel()
    return float(loss), dict(named_leaves(jax.tree.map(np.asarray, grads)))


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _spawned())


@pytest.mark.parametrize("name", ["toy", "toy_uniform", *T5_CASES])
def test_enc_dec_pipeline_matches_jax(name):
    loss, grads = _jax("toy" if name == "toy_uniform" else name)
    rtol, atol = (2e-4, 1e-6) if name.startswith("toy") else (1e-4, 1e-5)
    for r in _spawned():
        pl, pg, coords = r["schedules"][name]
        np.testing.assert_allclose(float(pl), loss, rtol=1e-5,
                                   err_msg=f"{name} loss")
        got = dict(named_leaves(pg))
        assert set(got) == set(grads)
        for k, g in got.items():
            want = grads[k]
            if k.split(".")[0].endswith("stages"):
                want = want[coords["pp"]]
            np.testing.assert_allclose(g.numpy(), want, rtol=rtol, atol=atol,
                                       err_msg=f"{name} d{k} at {coords}")


@pytest.mark.parametrize("name", list(T5_TP_CASES))
def test_t5_enc_dec_pipeline_under_tp_matches_jax(name):
    """T5 at pp 2 × tp 2 (tp and Megatron-SP): every rank's tp shard of
    its stage's gradients (and of the embed / head) within rtol 1e-4 /
    atol 1e-5 of JAX's; the loss within rtol 1e-5."""
    from apex_tpu_torch.transformer.testing import (T5Config,
                                                    t5_pipeline_specs_tree)

    loss, grads = _jax(name)
    specs = dict(named_leaves(t5_pipeline_specs_tree(
        T5Config(**T5_SIZES, **T5_TP_CASES[name]))))
    for r in _spawned_tp():
        pl, pg, coords = r["schedules"][name]
        assert r["jax_loaded"] is False
        np.testing.assert_allclose(float(pl), loss, rtol=1e-5,
                                   err_msg=f"{name} loss")
        got = dict(named_leaves(pg))
        assert set(got) == set(grads)
        for k, g in got.items():
            want = grads[k]
            for dim in reversed(range(len(specs[k]))):
                axis = specs[k][dim]
                if axis == "pp":
                    want = np.take(want, coords["pp"], axis=dim)
                elif axis == "tp":
                    n = want.shape[dim] // 2
                    want = np.take(want, range(coords["tp"] * n,
                                               (coords["tp"] + 1) * n),
                                   axis=dim)
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} d{k} at {coords}")


def test_only_the_last_stage_runs_the_loss_head():
    """Through the enc-dec driver (and the uniform one's dispatch to it)
    the last stage calls ``loss_fn`` once a microbatch, the others
    never."""
    for r in _spawned():
        for name, (calls, p, pp) in r["head_calls"].items():
            assert calls == (4 if p == pp - 1 else 0), (name, p, calls)


def test_interleaved_rejects_enc_dec():
    params, batch = _toy_inputs()
    with pytest.raises(ValueError, match="encoder-decoder") as je:
        jinterleaved(jtoy_spec(), params, batch, num_microbatches=4,
                     virtual_pipeline_size=2, mesh=_mesh())
    jps.destroy_model_parallel()
    for r in _spawned():
        assert r["refusal"] == str(je.value)


def test_split_rank_bookkeeping():
    """pp 2 with split rank 1: rank 0 before the split and at it, rank 1
    after; the setter (3); no split: before and after on every rank, never at;
    split ranks 2 (= pp) and 5 refused (JAX's rules)."""
    for rank, r in enumerate(_spawned()):
        s = r["split"]
        assert s["split"] == 1 and s["set"] == 3
        assert s["predicates"] == ((True, False, True) if rank == 0
                                   else (False, True, False))
        assert s["default"] == (True, True, False)
        assert s["refused"] == [True, True]
