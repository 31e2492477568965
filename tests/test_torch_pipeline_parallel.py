"""The port's pipeline parallelism (``transformer.pipeline_parallel``)
against the JAX package's, held to ``tests/test_pipeline_parallel.py``'s
programs.

JAX's drivers run under ``jax.jit`` on meshes of the conftest's CPU
devices (as many as the port's ranks, the same layout); the port's on
``gloo`` ranks (``tests/torch_pp_workers.py``, one spawn a world size),
each rank taking its local tree of JAX's global parameters
(``convert.pipeline_params_from_numpy``). JAX's toy spec (HID 8: a linear
embedding, ``tanh`` stages, a squared-error head) under 1F1B at pp 2 and
4 (M 4), dp 2 × pp 2 (M 2), the interleaved schedule at pp 2 with vp 2
and 3, a stage aux (``stage_aux``), and a loss scale: the loss and every
rank's gradients (its stage's, and the whole embed / head) within JAX's
tolerance, atol 1e-5 / rtol 1e-4 in fp32. The eight p2p names and
``scatter_gather=True`` against JAX's shifts at pp 4 and pp 2 × tp 2 (a
shift's gradient is the reverse shift); ``get_forward_backward_func``;
no-pipelining, the microbatch calculators, the left-to-right masks and
both batch samplers in this process against JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer._data import (
    MegatronPretrainingRandomSampler as JRandomSampler,
    MegatronPretrainingSampler as JSampler,
)
from apex_tpu.transformer.pipeline_parallel import (
    get_ltor_masks_and_position_ids as jltor,
    p2p_communication as jp2p,
)
from apex_tpu.transformer.pipeline_parallel.microbatches import (
    ConstantNumMicroBatches as JConstant,
    RampupBatchsizeNumMicroBatches as JRampup,
)
from apex_tpu.transformer.pipeline_parallel.schedules import (
    PipelineSpec as JPipelineSpec,
    build_model as jbuild_model,
    forward_backward_no_pipelining as jno_pipelining,
    forward_backward_pipelining_with_interleaving as jinterleaved,
    forward_backward_pipelining_without_interleaving as j1f1b,
)
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.parallel.multiproc import spawn

import torch_pp_workers as workers

HID, SEQ = workers.HID, 4
ATOL, RTOL = 1e-5, 1e-4


def jtoy_spec(aux=False):
    """JAX's toy spec (``tests/test_pipeline_parallel.py:_spec``);
    ``aux``: the stage also returns ``mean(out**2)``."""
    def embed_fn(ep, x):
        return x @ ep["w"]

    def stage_fn(sp, h):
        out = jnp.tanh(h @ sp["w"] + sp["b"])
        return (out, jnp.mean(out ** 2)) if aux else out

    def loss_fn(hp, h, tgt):
        return jnp.mean((h @ hp["w"] - tgt) ** 2)

    return JPipelineSpec(embed_fn, stage_fn, loss_fn, stage_aux=aux)


def jtoy_params(seed, num_chunks, vp=None):
    """JAX's toy params (``_params``) as numpy."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)

    def stage_init(key, c):
        kw, kb = jax.random.split(key)
        return {"w": jax.random.normal(kw, (HID, HID)) * 0.3,
                "b": jax.random.normal(kb, (HID,)) * 0.1}

    params = {"embed": {"w": jax.random.normal(k2, (HID, HID)) * 0.3},
              "stages": jbuild_model(stage_init, k1, num_chunks,
                                     virtual_pipeline_size=vp),
              "head": {"w": jax.random.normal(k3, (HID, HID)) * 0.3}}
    return jax.tree.map(np.asarray, params)


def jtoy_batch(seed, b):
    ki, kt = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jax.random.normal(ki, (b, SEQ, HID))),
            np.array(jax.random.normal(kt, (b, SEQ, HID))))


# name -> (world, kind, pp, vp, M, params seed, batch seed, batch, scale, aux)
CASES = {
    "pp2": (2, "1f1b", 2, None, 4, 2, 3, 16, None, False),
    "vp2": (2, "interleaved", 2, 2, 4, 6, 7, 16, None, False),
    "vp3": (2, "interleaved", 2, 3, 4, 6, 7, 16, None, False),
    "aux_pp2": (2, "1f1b", 2, None, 4, 10, 11, 16, None, True),
    "pp4": (4, "1f1b", 4, None, 4, 2, 3, 16, None, False),
    "dp2_pp2": (4, "1f1b", 2, None, 2, 4, 5, 8, None, False),
    "scale_pp4": (4, "1f1b", 4, None, 4, 8, 9, 8, 8.0, False),
    "noscale_pp4": (4, "1f1b", 4, None, 4, 8, 9, 8, None, False),
}
P2P_SHAPES = ((4, 1), (2, 2))      # (pp, tp) at world 4


def _case_inputs(name):
    world, kind, pp, vp, M, ps, bs, b, scale, aux = CASES[name]
    return jtoy_params(ps, pp, vp), jtoy_batch(bs, b)


def _port_cases(world):
    out = {}
    for name, (w, kind, pp, vp, M, _, _, _, scale, aux) in CASES.items():
        if w != world:
            continue
        params, batch = _case_inputs(name)
        out[name] = dict(spec="toy_aux" if aux else "toy", kind=kind, pp=pp,
                         vp=vp, M=M, params=params, batch=batch,
                         loss_scale=scale)
    return out


def _p2p_inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((8, 4)).astype(np.float32),
            rng.standard_normal((4, 8)).astype(np.float32),
            rng.standard_normal((8, 8)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _spawned(world):
    calls = {"schedules": ("schedules", (_port_cases(world),)),
             "head_calls": ("head_calls", (_port_cases(world),))}
    if world == 4:
        x, xs, cot = _p2p_inputs()
        for pp, tp in P2P_SHAPES:
            calls[f"p2p_{pp}x{tp}"] = ("p2p", (pp, tp, x, xs[:pp], cot))
        calls["dispatch"] = ("dispatch", ())
    return spawn(workers.several, world, calls)


@functools.lru_cache(maxsize=None)
def _jax(name):
    world, kind, pp, vp, M, _, _, _, scale, aux = CASES[name]
    params, batch = _case_inputs(name)
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(
        pipeline_model_parallel_size_=pp,
        virtual_pipeline_model_parallel_size_=vp,
        devices=jax.devices()[:world])
    spec = jtoy_spec(aux)
    kw = dict(num_microbatches=M, mesh=mesh)
    if vp:
        kw["virtual_pipeline_size"] = vp
    drive = jinterleaved if vp else j1f1b
    if scale is None:
        fn = jax.jit(lambda p: drive(spec, p, batch, **kw))
    else:
        fn = jax.jit(lambda p: drive(spec, p, batch, loss_scale=jnp.float32(
            scale), **kw))
    loss, grads = fn(jax.tree.map(jnp.asarray, params))
    jps.destroy_model_parallel()
    return float(loss), jax.tree.map(np.asarray, grads)


def _check_rank(name, got, want, vp=None):
    """One rank's ``(loss, grads, coords)`` against JAX's loss and global
    gradients: its stage (``[pp]`` or ``[:, pp]``) and the whole embed /
    head."""
    loss, grads, coords = got
    jl, jg = want
    np.testing.assert_allclose(float(loss), jl, atol=ATOL, rtol=RTOL,
                               err_msg=f"{name} loss")
    p = coords["pp"]
    for group in jg:
        for k, w in named_leaves(jg[group]):
            if group.endswith("stages"):
                w = w[:, p] if vp else w[p]
            g = dict(named_leaves(grads[group]))[k]
            np.testing.assert_allclose(
                g.numpy(), w, atol=ATOL, rtol=RTOL,
                err_msg=f"{name} d{group}.{k} rank coords {coords}")


@pytest.mark.parametrize("world", (2, 4))
def test_ranks_import_no_jax(world):
    assert not any(r["jax_loaded"] for r in _spawned(world))


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_matches_jax(name):
    world, kind, pp, vp = CASES[name][:4]
    want = _jax(name)
    for r in _spawned(world):
        _check_rank(name, r["schedules"][name], want, vp)


@pytest.mark.parametrize("world", (2, 4))
def test_only_the_last_stage_runs_the_loss_head(world):
    """The last stage calls ``loss_fn`` once a microbatch; every other
    stage never (its backward starts from its ring outputs)."""
    for r in _spawned(world):
        for name, (calls, p, pp) in r["head_calls"].items():
            want = CASES[name][4] if p == pp - 1 else 0
            assert calls == want, (name, p, calls)


def test_loss_scale_scales_grads():
    """The loss unscaled, every gradient 8x (ref's loss-scale test), on
    the port's own runs."""
    for r in _spawned(4):
        l1, g1, _ = r["schedules"]["noscale_pp4"]
        l8, g8, _ = r["schedules"]["scale_pp4"]
        np.testing.assert_allclose(float(l1), float(l8), atol=1e-6)
        for (k, a), (_, b) in zip(named_leaves(g1), named_leaves(g8)):
            np.testing.assert_allclose(b.numpy(), 8.0 * a.numpy(),
                                       atol=ATOL, rtol=RTOL, err_msg=k)


def test_no_pipelining_matches_jax():
    """The gradient-accumulation loop (no mesh) against JAX's on the same
    step function, M 4."""
    from apex_tpu_torch.convert import params_from_numpy
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining,
    )

    params, batch = jtoy_params(0, 2), jtoy_batch(1, 8)
    jspec, spec = jtoy_spec(), workers.toy_spec()

    def jfwd(p, mb):
        h = jspec.embed_fn(p["embed"], mb[0])
        for s in range(2):
            h = jspec.stage_fn(jax.tree.map(lambda a: a[s], p["stages"]), h)
        return jspec.loss_fn(p["head"], h, mb[1])

    def fwd(p, mb):
        h = spec.embed_fn(p["embed"], mb[0])
        for s in range(2):
            h = spec.stage_fn({k: v[s] for k, v in p["stages"].items()}, h)
        return spec.loss_fn(p["head"], h, mb[1])

    jl, jg = jno_pipelining(jfwd, batch, jax.tree.map(jnp.asarray, params),
                            num_microbatches=4)
    loss, grads = forward_backward_no_pipelining(
        fwd, tuple(torch.from_numpy(a) for a in batch),
        params_from_numpy(params, "cpu"), num_microbatches=4)
    np.testing.assert_allclose(float(loss), float(jl), atol=ATOL, rtol=RTOL)
    for (k, g), (_, w) in zip(named_leaves(grads),
                              named_leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_get_forward_backward_func_dispatch():
    """pp 4 → 1F1B, pp 4 with vp 2 → interleaved, pp 1 → no pipelining;
    an explicit pp keeps the installed vp (JAX's regression)."""
    for r in _spawned(4):
        assert r["dispatch"] == [
            "forward_backward_pipelining_without_interleaving",
            "forward_backward_pipelining_with_interleaving",
            "forward_backward_no_pipelining",
            "forward_backward_pipelining_with_interleaving"]


@functools.lru_cache(maxsize=None)
def _jax_p2p(pp, tp):
    """JAX's eight names and scatter-gather shift on the same grid."""
    x, xs, _ = _p2p_inputs()
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(
        pipeline_model_parallel_size_=pp, tensor_model_parallel_size_=tp,
        devices=jax.devices()[:4])

    def body(x):
        out = []
        for name in workers.P2P_NAMES:
            fn = getattr(jp2p, name)
            res = fn(x, x) if name in ("send_forward_recv_backward",
                                       "send_backward_recv_forward") \
                else fn(x)
            out.extend(res if isinstance(res, tuple) else (res,))
        return tuple(out)

    n_out = len(workers.P2P_NAMES) + 2
    blocks = jax.shard_map(body, mesh=mesh, in_specs=P("pp", "tp"),
                           out_specs=(P("pp", "tp"),) * n_out)(x)
    sg = jax.shard_map(
        lambda a: jp2p.send_forward_recv_forward(a, scatter_gather=True),
        mesh=mesh, in_specs=P("pp"), out_specs=P("pp"),
        check_vma=False)(xs[:pp])
    jps.destroy_model_parallel()
    return [np.asarray(b) for b in blocks], np.asarray(sg)


@pytest.mark.parametrize("pp,tp", P2P_SHAPES)
def test_p2p_names_match_jax_shifts(pp, tp):
    blocks, sg = _jax_p2p(pp, tp)
    x, xs, cot = _p2p_inputs()
    r_, c_ = x.shape[0] // pp, x.shape[1] // tp
    for r in _spawned(4):
        res = r[f"p2p_{pp}x{tp}"]
        p, t = res["coords"]
        i = 0

        def block(a):
            return a[p * r_:(p + 1) * r_, t * c_:(t + 1) * c_]

        for name in workers.P2P_NAMES:
            got = res[name]
            for g in (got if isinstance(got, tuple) else (got,)):
                np.testing.assert_array_equal(g.numpy(), block(blocks[i]),
                                              err_msg=f"{name} at {(p, t)}")
                i += 1
        # a forward shift's gradient is the cotangent shifted back
        np.testing.assert_array_equal(
            res["grad_forward"].numpy(),
            block(np.roll(cot[:pp * r_, :tp * c_], -r_, axis=0)))
        np.testing.assert_allclose(res["scatter_gather"].numpy(),
                                   sg[p:p + 1], atol=1e-6)
        np.testing.assert_allclose(
            res["grad_scatter_gather"].numpy(),
            np.roll(cot[:pp, :xs.shape[1]], -1, axis=0)[p:p + 1], atol=1e-6)


def test_microbatch_calculators_match_jax():
    """Both calculators through a ramp (and the no-ramp edge), step by
    step, and their errors."""
    from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (
        ConstantNumMicroBatches,
        RampupBatchsizeNumMicroBatches,
        build_num_microbatches_calculator,
    )

    c, jc = ConstantNumMicroBatches(64, 4, 2), JConstant(64, 4, 2)
    assert (c.get(), c.get_current_global_batch_size()) == (
        jc.get(), jc.get_current_global_batch_size()) == (8, 64)
    for bad in ((63, 4, 2),):
        with pytest.raises(ValueError) as e:
            ConstantNumMicroBatches(*bad)
        with pytest.raises(ValueError) as je:
            JConstant(*bad)
        assert str(e.value) == str(je.value)
    for start in (8, 32):
        kw = dict(start_batch_size=start, batch_size_increment=8,
                  ramup_samples=400, global_batch_size=32,
                  micro_batch_size=4, data_parallel_size=2)
        r, jr = RampupBatchsizeNumMicroBatches(**kw), JRampup(**kw)
        for consumed in (0, 100, 133, 200, 300, 399, 400, 1000):
            r.update(consumed, True)
            jr.update(consumed, True)
            assert (r.get(), r.get_current_global_batch_size()) == (
                jr.get(), jr.get_current_global_batch_size()), consumed
    built = build_num_microbatches_calculator(0, [8, 8, 400], 32, 4, 2)
    assert isinstance(built, RampupBatchsizeNumMicroBatches)
    with pytest.raises(ValueError, match="three ints"):
        build_num_microbatches_calculator(0, [8, 8], 32, 4, 2)


def test_microbatch_setters():
    from apex_tpu_torch.transformer.pipeline_parallel import utils

    utils.destroy_microbatch_calculator()
    with pytest.raises(RuntimeError, match="not initialized"):
        utils.get_num_microbatches()
    utils.setup_microbatch_calculator(0, None, 64, 4, 2)
    try:
        assert utils.get_num_microbatches() == 8
        assert utils.get_micro_batch_size() == 4
        assert utils.get_current_global_batch_size() == 64
        with pytest.raises(RuntimeError, match="already initialized"):
            utils.setup_microbatch_calculator(0, None, 64, 4, 2)
    finally:
        utils.destroy_microbatch_calculator()


@pytest.mark.parametrize("reset", [(False, False, False),
                                   (True, True, True), (True, False, True),
                                   (False, True, False)])
def test_ltor_masks_and_position_ids_match_jax(reset):
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_ltor_masks_and_position_ids,
    )

    data = np.random.default_rng(5).integers(0, 6, (3, 12))
    pos, att, eod = reset
    want = jltor(jnp.asarray(data), eod_token=5, reset_position_ids=pos,
                 reset_attention_mask=att, eod_mask_loss=eod)
    got = get_ltor_masks_and_position_ids(
        torch.from_numpy(data), eod_token=5, reset_position_ids=pos,
        reset_attention_mask=att, eod_mask_loss=eod)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_utils_norm_and_clip_on_one_device():
    """``calc_params_l2_norm`` / ``clip_grad_norm`` with no mesh (every
    axis one rank) against the plain norm; ``average_losses_across_
    data_parallel_group`` the stacked losses; ``report_memory`` names no
    device here."""
    from apex_tpu_torch.transformer.pipeline_parallel import utils

    g = {"a": torch.full((3,), 2.0), "b": {"c": torch.full((4,), 1.0)}}
    norm = utils.calc_params_l2_norm(g, ("tp", "pp"))
    np.testing.assert_allclose(float(norm), np.sqrt(16.0), rtol=1e-6)
    clipped, n2 = utils.clip_grad_norm(g, 1.0, ("tp",))
    np.testing.assert_allclose(float(utils.calc_params_l2_norm(clipped)),
                               1.0, rtol=1e-5)
    avg = utils.average_losses_across_data_parallel_group(
        [torch.tensor(1.0), torch.tensor(3.0)])
    np.testing.assert_array_equal(avg.numpy(), [1.0, 3.0])
    assert "no CUDA device" in utils.report_memory("x")


@pytest.mark.parametrize("consumed,rank,world,drop_last", [
    (0, 0, 2, True), (5, 1, 2, False), (12, 2, 3, True)])
def test_batch_samplers_match_jax(consumed, rank, world, drop_last):
    from apex_tpu_torch.transformer._data import (
        MegatronPretrainingRandomSampler,
        MegatronPretrainingSampler,
    )

    seq = list(MegatronPretrainingSampler(50, consumed, 3, rank, world,
                                          drop_last))
    assert seq == list(JSampler(50, consumed, 3, rank, world, drop_last))
    rnd = MegatronPretrainingRandomSampler(50, consumed - consumed % (3 *
                                                                     world),
                                           3, rank, world)
    jrnd = JRandomSampler(50, consumed - consumed % (3 * world), 3, rank,
                          world)
    assert list(rnd) == list(jrnd)
    assert rnd.consumed_samples == jrnd.consumed_samples
    for bad in ((0, 0, 3, 0, 2), (10, 10, 3, 0, 2), (10, 0, 3, 2, 2)):
        with pytest.raises(RuntimeError):
            MegatronPretrainingSampler(*bad)
