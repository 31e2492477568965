"""The port's T5 under tensor and sequence parallelism against the JAX
package's.

JAX runs ``t5_loss`` inside ``jax.shard_map`` with ``t5_param_specs`` on
4 of the conftest's CPU devices, the batch's rows over dp and, under
ring sp, its sequences over sp (``tests/test_t5.py``'s pattern: the loss
``pmean``-ed over every axis, ``jax.value_and_grad`` of the whole
program); the port on 4 ``gloo`` ranks (one spawn for every case),
``shard_params`` by the port's ``t5_param_specs`` and ``gather_grads``.
JAX's tiny config (vocab 96, hidden 32, 4 heads, 2 + 2 layers, encoder
12 and decoder 8 tokens, fp32): tp = 2, ``megatron_sp`` at tp = 2 (also
with the relative bias and the encoder-final LayerNorm, whose parameters
meet the sequence shards), and sp = 2 with the relative bias, where the
self-attentions ride the ring with the bias strip (``_rel_or_strip``,
``t5_relative_bias(qpos=, kpos=)``: the strip's gradient through the
d(bias) of each chunk at its offsets) and the cross-attention the
rectangular ring, at tp 1 and at tp 2. The loss within rtol 1e-5 / atol
1e-6 and every gradient leaf within rtol 1e-4 / atol 1e-5 of JAX's.
"""

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
from apex_tpu.transformer.testing import T5Config as JT5Config
from apex_tpu.transformer.testing import init_t5_params as jinit_t5
from apex_tpu.transformer.testing import t5_loss as jt5_loss
from apex_tpu.transformer.testing import t5_param_specs as jt5_specs
from apex_tpu.transformer.testing.standalone_t5 import (
    t5_relative_bias as jt5_bias,
)
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer.testing import T5Config, t5_relative_bias

import torch_tp_workers as workers

WORLD = 4
SIZES = dict(vocab_size=96, hidden=32, num_heads=4, enc_layers=2,
             dec_layers=2, max_seq_enc=12, max_seq_dec=8, fused_loss=False)
REL = dict(relative_position_bias=True)
CASES = {   # name -> (fields, tp, sp)
    "tp2": ({}, 2, 1),
    "megatron_sp_tp2": (dict(megatron_sp=True), 2, 1),
    "megatron_sp_tp2_rel_final_ln": (dict(megatron_sp=True,
                                          encoder_final_ln=True,
                                          fused_loss=True, **REL), 2, 1),
    "sp2_rel": (REL, 1, 2),
    "tp2_sp2_rel": (REL, 2, 2),
}
BATCH = 8


@functools.lru_cache(maxsize=None)
def _inputs(fields_key):
    fields = dict(fields_key)
    cfg = JT5Config(dtype=jnp.float32, **{**SIZES, **fields})
    params = jinit_t5(jax.random.PRNGKey(0), cfg)
    ke, kd = jax.random.split(jax.random.PRNGKey(1))
    enc = jax.random.randint(ke, (BATCH, 12), 0, cfg.vocab_size)
    dec = jax.random.randint(kd, (BATCH, 8), 0, cfg.vocab_size)
    batch = (enc, dec, jnp.roll(dec, -1, 1))
    return (jax.tree.map(np.asarray, params),
            tuple(np.asarray(a) for a in batch))


def _key(fields):
    return tuple(sorted(fields.items()))


@functools.lru_cache(maxsize=None)
def _spawned():
    cases = {}
    for name, (fields, tp, sp) in CASES.items():
        params, batch = _inputs(_key(fields))
        cases[name] = ("t5", dict(dtype=torch.float32, **{**SIZES, **fields}),
                       tp, sp, None, params, batch)
    return spawn(workers.several, WORLD, {"models": ("models", (cases,))})


@functools.lru_cache(maxsize=None)
def _jax(name):
    fields, tp, sp = CASES[name]
    cfg = JT5Config(dtype=jnp.float32, **{**SIZES, **fields})
    params, batch = _inputs(_key(fields))
    mesh = build_mesh(tp=tp, pp=1, sp=sp, devices=jax.devices()[:WORLD])
    data = P("dp", "sp") if sp > 1 else P("dp")

    def loss_fn(p):
        def body(p, e, d, t):
            return replicate_loss(jt5_loss(p, e, d, t, cfg), mesh,
                                  masked_axis=None)

        return jax.shard_map(body, mesh=mesh,
                             in_specs=(jt5_specs(cfg), data, data, data),
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
    if "rel" in name:
        g = dict(named_leaves(_spawned()[0]["models"][name][1]))
        for k in ("embed.rel_enc", "embed.rel_dec"):
            assert float(g[k].abs().sum()) > 0


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bias_strip_matches_jax(bidirectional):
    """``t5_relative_bias(qpos=, kpos=)``: shard 1 of 3 of a 24-token
    sequence against every column, and its table gradient, as JAX's."""
    cfg_fields = dict(SIZES, **REL)
    rng = np.random.default_rng(3)
    table = rng.standard_normal((32, 4)).astype(np.float32)
    g = rng.standard_normal((4, 8, 24)).astype(np.float32)
    qpos, kpos = np.arange(8, 16), np.arange(24)
    jcfg = JT5Config(dtype=jnp.float32, **cfg_fields)
    want, vjp = jax.vjp(lambda t: jt5_bias(
        t, bidirectional=bidirectional, cfg=jcfg, qpos=jnp.asarray(qpos),
        kpos=jnp.asarray(kpos)), jnp.asarray(table))
    (dt_want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    got = t5_relative_bias(t, bidirectional=bidirectional,
                           cfg=T5Config(dtype=torch.float32, **cfg_fields),
                           qpos=qpos, kpos=kpos)
    (dt,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dt_want), rtol=1e-6,
                               atol=1e-6)


def test_validate_matches_jax():
    for fields, tp in ((dict(megatron_sp=True, max_seq_dec=9), 2),
                       (dict(num_heads=6, hidden=36), 4)):
        with pytest.raises(ValueError) as je:
            JT5Config(dtype=jnp.float32, **{**SIZES, **fields}).validate(
                tp=tp)
        with pytest.raises(ValueError) as pe:
            T5Config(dtype=torch.float32, **{**SIZES, **fields}).validate(
                tp=tp)
        assert str(pe.value) == str(je.value)
