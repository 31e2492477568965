"""The port's GPT through the pipeline schedules against the JAX
package's.

JAX's ``gpt_pipeline_params`` (jax.random, fp32, untied head) is the one
set of weights: JAX's drivers run it under ``jax.jit`` with
``gpt_pipeline_specs_tree`` on 4 of the conftest's CPU devices; the port
converts it to each rank's local tree
(``convert.pipeline_params_from_numpy`` with the port's
``gpt_pipeline_specs_tree``: the stage at the rank's pp index, the tp
shards) and runs ``gpt_pipeline_spec`` on 4 ``gloo`` ranks (one spawn).
GPT at hidden 64, 4 layers, 4 heads, vocab 128, seq 16, batch 8, M 4:
1F1B at pp 2 (dp 2), interleaved at pp 2 × vp 2 (dp 2), 1F1B at pp 2 ×
tp 2 and pp 2 × sp 2 (ring attention; the sequence split by
``data_spec``). The loss within rtol 1e-5 / atol 1e-6 and every rank's
gradient leaves (its stage, its tp shard of the embed / head) within
rtol 1e-4 / atol 1e-5 of JAX's. The embedding's and head's gradients
are the pp sums (only stage 0 uses the embedding, only the last stage's
loss reaches the head), so a missing pp sum fails here.
``pipeline_stage_key`` against JAX's inside a pp 4 mesh.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.pipeline_parallel.schedules import (
    forward_backward_pipelining_with_interleaving as jinterleaved,
    forward_backward_pipelining_without_interleaving as j1f1b,
)
from apex_tpu.transformer.tensor_parallel.random import (
    pipeline_stage_key as jstage_key,
)
from apex_tpu.transformer.testing import (
    GPTConfig as JGPTConfig,
    gpt_pipeline_params as jgpt_pipeline_params,
    gpt_pipeline_spec as jgpt_pipeline_spec,
    gpt_pipeline_specs_tree as jgpt_pipeline_specs_tree,
)
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.parallel.multiproc import spawn

import torch_pp_workers as workers

WORLD = 4
SIZES = dict(vocab_size=128, max_seq=16, hidden=64, num_layers=4,
             num_heads=4, tie_embeddings=False)
B, M = 8, 4
# name -> (kind, pp, vp, tp, sp)
CASES = {
    "pp2": ("1f1b", 2, None, 1, 1),
    "pp2_vp2": ("interleaved", 2, 2, 1, 1),
    "pp2_tp2": ("1f1b", 2, None, 2, 1),
    "pp2_sp2": ("1f1b", 2, None, 1, 2),
}
STAGE_KEY_SEEDS = (0, 7, 123)


@functools.lru_cache(maxsize=None)
def _inputs(vp):
    cfg = JGPTConfig(dtype=jnp.float32, **SIZES)
    params = jgpt_pipeline_params(jax.random.PRNGKey(0), cfg, pp=2, vp=vp)
    tok = jax.random.randint(jax.random.PRNGKey(1), (B, SIZES["max_seq"]),
                             0, SIZES["vocab_size"])
    return (jax.tree.map(np.asarray, params),
            (np.asarray(tok), np.asarray(jnp.roll(tok, -1, axis=1))))


def _data_spec(sp):
    return (None, "dp", "sp") if sp > 1 else (None, "dp")


@functools.lru_cache(maxsize=None)
def _spawned():
    cases = {}
    for name, (kind, pp, vp, tp, sp) in CASES.items():
        params, batch = _inputs(vp)
        cases[name] = dict(spec=("gpt", SIZES), kind=kind, pp=pp, vp=vp,
                           tp=tp, sp=sp, M=M, params=params, batch=batch,
                           data_spec=_data_spec(sp))
    return spawn(workers.several, WORLD, {
        "schedules": ("schedules", (cases,)),
        "keys": ("stage_keys", (WORLD, STAGE_KEY_SEEDS))})


@functools.lru_cache(maxsize=None)
def _jax(name):
    kind, pp, vp, tp, sp = CASES[name]
    cfg = JGPTConfig(dtype=jnp.float32, **SIZES)
    params, batch = _inputs(vp)
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size_=tp, pipeline_model_parallel_size_=pp,
        virtual_pipeline_model_parallel_size_=vp,
        sequence_parallel_size_=sp, devices=jax.devices()[:WORLD])
    kw = dict(num_microbatches=M, mesh=mesh,
              params_specs=jgpt_pipeline_specs_tree(cfg, interleaved=bool(vp)),
              data_spec=P(*_data_spec(sp)))
    spec = jgpt_pipeline_spec(cfg)
    if vp:
        fn = jax.jit(lambda p: jinterleaved(spec, p, batch,
                                            virtual_pipeline_size=vp, **kw))
    else:
        fn = jax.jit(lambda p: j1f1b(spec, p, batch, **kw))
    loss, grads = fn(jax.tree.map(jnp.asarray, params))
    jps.destroy_model_parallel()
    return float(loss), jax.tree.map(np.asarray, grads)


def _local(a, spec, coords, sizes):
    """This rank's block of a global array by its spec (pp indexed)."""
    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        if axis is None:
            continue
        if axis == "pp":
            a = np.take(a, coords["pp"], axis=dim)
            continue
        n = a.shape[dim] // sizes[axis]
        i = coords[axis]
        a = np.take(a, range(i * n, (i + 1) * n), axis=dim)
    return a


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _spawned())


@pytest.mark.parametrize("name", list(CASES))
def test_gpt_pipeline_matches_jax(name):
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_pipeline_specs_tree,
    )

    kind, pp, vp, tp, sp = CASES[name]
    loss, grads = _jax(name)
    specs = dict(named_leaves(gpt_pipeline_specs_tree(
        GPTConfig(**SIZES), interleaved=bool(vp))))
    sizes = {"pp": pp, "tp": tp, "sp": sp, "dp": WORLD // (pp * tp * sp)}
    want = dict(named_leaves(grads))
    for r in _spawned():
        pl, pg, coords = r["schedules"][name]
        np.testing.assert_allclose(float(pl), loss, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} loss at {coords}")
        got = dict(named_leaves(pg))
        assert set(got) == set(want)
        for k, g in got.items():
            np.testing.assert_allclose(
                g.numpy(), _local(want[k], specs[k], coords, sizes),
                rtol=1e-4, atol=1e-5, err_msg=f"{name} d{k} at {coords}")


def test_pipeline_stage_key_matches_jax():
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(
        pipeline_model_parallel_size_=WORLD, devices=jax.devices()[:WORLD])
    for i, seed in enumerate(STAGE_KEY_SEEDS):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.shard_map(
            lambda x: jstage_key(key)[None] + 0 * x[:, :1],
            mesh=mesh, in_specs=P("pp"), out_specs=P("pp"))(
            jnp.zeros((WORLD, 2), jnp.uint32)))
        for rank, r in enumerate(_spawned()):
            np.testing.assert_array_equal(r["keys"][i].numpy(), want[rank])
    jps.destroy_model_parallel()
