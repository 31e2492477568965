"""Dropout through the port's pipeline schedules against the JAX
package's, held to ``tests/test_pipeline_dropout.py``.

The schedules route one threefry key a microbatch (``fold_in(key, m)``;
interleaved: folded again by the chunk) to the spec's functions. JAX's
toy dropout spec draws ``jax.random.bernoulli`` masks from the routed
key; the port's draws the same bits (``tensor_parallel.random.
bernoulli``). In this process: the no-pipelining loop (M 4), the
spec / key pairing refused both ways and the step function's arity
check. On 4 ``gloo`` ranks (one spawn) against JAX's drivers on 4 of the
conftest's CPU devices: 1F1B at pp 2 × dp 2 (M 2) and the interleaved
schedule at pp 2 × vp 2 (M 4) on the toy spec; GPT (hidden 32, 4
layers, seq 32, hidden dropout 0.2, attention dropout 0.1) at pp 2 × sp
2 and T5 (hidden 32, 2 + 2 layers, hidden dropout 0.2) at pp 2 × dp 2,
each under one key: the loss within rtol 1e-5 / atol 1e-6 and every
rank's gradients within rtol 1e-4 / atol 1e-5 of JAX's (the model's pp,
sp and side folds included); a second key changes the loss.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.pipeline_parallel.schedules import (
    PipelineSpec as JPipelineSpec,
    build_model as jbuild_model,
    forward_backward_no_pipelining as jno_pipelining,
    forward_backward_pipelining_enc_dec as jenc_dec,
    forward_backward_pipelining_with_interleaving as jinterleaved,
    forward_backward_pipelining_without_interleaving as j1f1b,
)
from apex_tpu.transformer.testing import (
    GPTConfig as JGPTConfig,
    T5Config as JT5Config,
    gpt_pipeline_params as jgpt_pipeline_params,
    gpt_pipeline_spec as jgpt_pipeline_spec,
    gpt_pipeline_specs_tree as jgpt_pipeline_specs_tree,
    t5_enc_dec_spec as jt5_enc_dec_spec,
    t5_pipeline_params as jt5_pipeline_params,
    t5_pipeline_specs_tree as jt5_pipeline_specs_tree,
)
from apex_tpu_torch.convert import named_leaves, params_from_numpy
from apex_tpu_torch.parallel.multiproc import spawn

import torch_pp_workers as workers

WORLD = 4
HID, B, SEQ, KEEP = workers.HID, 8, 4, workers.KEEP
GPT = dict(vocab_size=64, max_seq=32, hidden=32, num_layers=4, num_heads=4,
           tie_embeddings=False, attention_dropout=0.1, hidden_dropout=0.2)
T5 = dict(vocab_size=64, hidden=32, num_heads=4, enc_layers=2, dec_layers=2,
          max_seq_enc=16, max_seq_dec=8, fused_loss=False,
          hidden_dropout=0.2)
KEYS = (3, 4)
# name -> (model, kind, pp, vp, sp, M, key seed)
CASES = {
    "toy_1f1b": ("toy", "1f1b", 2, None, 1, 2, 7),
    "toy_interleaved": ("toy", "interleaved", 2, 2, 1, 4, 9),
    "gpt_pp2_sp2": ("gpt", "1f1b", 2, None, 2, 2, KEYS[0]),
    "gpt_pp2_sp2_key2": ("gpt", "1f1b", 2, None, 2, 2, KEYS[1]),
    "t5_pp2": ("t5", "enc_dec", 2, None, 1, 2, KEYS[0]),
}


def jtoy_spec():
    """JAX's toy dropout spec (``_dropout_spec``)."""
    def embed_fn(ep, x, key):
        keep = jax.random.bernoulli(jax.random.fold_in(key, 1), KEEP,
                                    x.shape)
        return (x * keep) @ ep["w"]

    def stage_fn(sp, h, key):
        keep = jax.random.bernoulli(jax.random.fold_in(key, 2), KEEP,
                                    h.shape)
        return jnp.tanh((h * keep) @ sp["w"] + sp["b"])

    def loss_fn(hp, h, tgt):
        return jnp.mean((h @ hp["w"] - tgt) ** 2)

    return JPipelineSpec(embed_fn, stage_fn, loss_fn, takes_dropout_key=True)


@functools.lru_cache(maxsize=None)
def _inputs(model, vp=None):
    if model == "toy":
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)

        def stage_init(key, c):
            kw, kb = jax.random.split(key)
            return {"w": jax.random.normal(kw, (HID, HID)) * 0.3,
                    "b": jax.random.normal(kb, (HID,)) * 0.1}

        params = {"embed": {"w": jax.random.normal(k2, (HID, HID)) * 0.3},
                  "stages": jbuild_model(stage_init, k1, 2,
                                         virtual_pipeline_size=vp),
                  "head": {"w": jax.random.normal(k3, (HID, HID)) * 0.3}}
        ki, kt = jax.random.split(jax.random.PRNGKey(1))
        batch = (jax.random.normal(ki, (B, SEQ, HID)),
                 jax.random.normal(kt, (B, SEQ, HID)))
    elif model == "gpt":
        cfg = JGPTConfig(dtype=jnp.float32, **GPT)
        params = jgpt_pipeline_params(jax.random.PRNGKey(0), cfg, pp=2)
        tok = jax.random.randint(jax.random.PRNGKey(1), (4, GPT["max_seq"]),
                                 0, GPT["vocab_size"])
        batch = (tok, jnp.roll(tok, -1, 1))
    else:
        cfg = JT5Config(dtype=jnp.float32, **T5)
        params = jt5_pipeline_params(jax.random.PRNGKey(4), cfg, pp=2)
        k = jax.random.PRNGKey(5)
        enc = jax.random.randint(k, (4, 16), 0, 64)
        dec = jax.random.randint(jax.random.fold_in(k, 1), (4, 8), 0, 64)
        batch = (enc, dec, jnp.roll(dec, -1, 1))
    return (jax.tree.map(np.asarray, params),
            tuple(np.array(a) for a in batch))


def _data_spec(sp):
    return (None, "dp", "sp") if sp > 1 else (None, "dp")


@functools.lru_cache(maxsize=None)
def _spawned():
    cases = {}
    for name, (model, kind, pp, vp, sp, M, seed) in CASES.items():
        params, batch = _inputs(model, vp)
        spec = {"toy": "toy_dropout", "gpt": ("gpt", GPT),
                "t5": ("t5", T5)}[model]
        cases[name] = dict(spec=spec, kind=kind, pp=pp, vp=vp, sp=sp, M=M,
                           params=params, batch=batch,
                           key=np.asarray(jax.random.PRNGKey(seed)),
                           data_spec=_data_spec(sp))
    return spawn(workers.several, WORLD,
                 {"schedules": ("schedules", (cases,))})


@functools.lru_cache(maxsize=None)
def _jax(name):
    model, kind, pp, vp, sp, M, seed = CASES[name]
    params, batch = _inputs(model, vp)
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(
        pipeline_model_parallel_size_=pp, sequence_parallel_size_=sp,
        virtual_pipeline_model_parallel_size_=vp,
        devices=jax.devices()[:WORLD])
    kw = dict(num_microbatches=M, mesh=mesh, data_spec=P(*_data_spec(sp)),
              dropout_key=jax.random.PRNGKey(seed))
    if model == "toy":
        spec = jtoy_spec()
    elif model == "gpt":
        cfg = JGPTConfig(dtype=jnp.float32, **GPT)
        spec = jgpt_pipeline_spec(cfg, dropout=True)
        kw["params_specs"] = jgpt_pipeline_specs_tree(cfg)
    else:
        cfg = JT5Config(dtype=jnp.float32, **T5)
        spec = jt5_enc_dec_spec(cfg, dropout=True)
        kw["params_specs"] = jt5_pipeline_specs_tree(cfg)
    drive = {"1f1b": j1f1b, "enc_dec": jenc_dec}.get(kind)
    if kind == "interleaved":
        fn = jax.jit(lambda p: jinterleaved(spec, p, batch,
                                            virtual_pipeline_size=vp, **kw))
    else:
        fn = jax.jit(lambda p: drive(spec, p, batch, **kw))
    loss, grads = fn(jax.tree.map(jnp.asarray, params))
    jps.destroy_model_parallel()
    return float(loss), dict(named_leaves(jax.tree.map(np.asarray, grads)))


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _spawned())


@pytest.mark.parametrize("name", list(CASES))
def test_dropout_through_the_schedules_matches_jax(name):
    vp = CASES[name][3]
    loss, grads = _jax(name)
    for r in _spawned():
        pl, pg, coords = r["schedules"][name]
        np.testing.assert_allclose(float(pl), loss, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} loss at {coords}")
        got = dict(named_leaves(pg))
        assert set(got) == set(grads)
        for k, g in got.items():
            want = grads[k]
            if k.split(".")[0].endswith("stages"):
                want = want[:, coords["pp"]] if vp else want[coords["pp"]]
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"{name} d{k} at {coords}")


def test_another_key_changes_the_loss():
    a = float(_spawned()[0]["schedules"]["gpt_pp2_sp2"][0])
    b = float(_spawned()[0]["schedules"]["gpt_pp2_sp2_key2"][0])
    assert np.isfinite(a) and a != b


def test_no_pipelining_dropout_key_per_microbatch():
    """M 4: each microbatch's step gets ``fold_in(key, m)``; loss and
    gradients within JAX's test tolerance (rtol 1e-5 loss; atol 1e-5 /
    rtol 1e-4)."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining,
    )

    params, batch = _inputs("toy")
    jspec, spec = jtoy_spec(), workers.toy_spec(dropout=True)

    def make(s, index):
        def fwd(p, m, k):
            h = s.embed_fn(p["embed"], m[0], k)
            for i in range(2):
                h = s.stage_fn(index(p["stages"], i), h, k)
            return s.loss_fn(p["head"], h, m[1])
        return fwd

    jl, jg = jno_pipelining(
        make(jspec, lambda t, i: jax.tree.map(lambda a: a[i], t)), batch,
        jax.tree.map(jnp.asarray, params), num_microbatches=4,
        dropout_key=jax.random.PRNGKey(5))
    loss, grads = forward_backward_no_pipelining(
        make(spec, lambda t, i: {k: v[i] for k, v in t.items()}),
        tuple(torch.from_numpy(a) for a in batch),
        params_from_numpy(params, "cpu"), num_microbatches=4,
        dropout_key=np.asarray(jax.random.PRNGKey(5)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for (k, g), (_, w) in zip(named_leaves(grads),
                              named_leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_dropout_key_spec_pairing_validated_both_ways():
    from apex_tpu_torch.convert import pipeline_params_from_numpy
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving as drive,
    )

    params, batch = _inputs("toy")
    p = pipeline_params_from_numpy(params, "cpu")
    b = tuple(torch.from_numpy(a) for a in batch)
    plain = dataclasses.replace(workers.toy_spec(dropout=True),
                                takes_dropout_key=False)
    with pytest.raises(ValueError, match="takes_dropout_key"):
        drive(plain, p, b, num_microbatches=2,
              dropout_key=np.asarray(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="no dropout_key"):
        drive(workers.toy_spec(dropout=True), p, b, num_microbatches=2)


def test_no_pipelining_dropout_arity_checked():
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining,
    )

    params, batch = _inputs("toy")
    with pytest.raises(ValueError, match="third per-microbatch key"):
        forward_backward_no_pipelining(
            lambda p, m: torch.zeros(()),
            tuple(torch.from_numpy(a) for a in batch),
            params_from_numpy(params, "cpu"), num_microbatches=2,
            dropout_key=np.asarray(jax.random.PRNGKey(0)))

    def wrapped(*args, **kwargs):
        return (lambda p, m: torch.zeros(()))(*args, **kwargs)

    with pytest.raises(ValueError, match="third per-microbatch key"):
        forward_backward_no_pipelining(
            wrapped, tuple(torch.from_numpy(a) for a in batch),
            params_from_numpy(params, "cpu"), num_microbatches=2,
            dropout_key=np.asarray(jax.random.PRNGKey(0)))
