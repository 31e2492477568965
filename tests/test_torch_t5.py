"""apex_tpu_torch's T5 encoder-decoder and flash attention's bias path on the
CPU, against apex_tpu.

The same numpy inputs go through the JAX function and its port. The JAX
side runs as its own tests run it on the CPU: the flash kernels with a
bias (B #5-8) in Pallas interpret mode at 32-row blocks
(``tests/test_attention.py``), and ``t5_loss`` inside ``shard_map`` on a
tp = 1 mesh (``tests/test_t5.py``), where at these sizes its attention
takes ``attention_reference``. The port's wrappers take their plain
PyTorch versions for CPU tensors; the CUDA kernels are held against those
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.ops.attention import _fa_bwd, _fa_fwd
from apex_tpu.ops.attention import flash_attention as jax_flash
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.transformer.testing import standalone_t5 as jt5

from apex_tpu_torch.convert import named_leaves, params_from_numpy
from apex_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_bwd_dbias_reference,
                                          flash_attention_bwd_reference,
                                          flash_attention_fwd_reference)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.testing import (T5Config, build_t5_train_step,
                                                init_t5_params, t5_loss,
                                                t5_relative_bias)
from apex_tpu_torch.transformer.testing.standalone_t5 import _rel_pos_bucket
from apex_tpu_torch.transformer.testing.train import param_leaves


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# flash attention with a bias (B #5-8), op level


def _qkv_bias(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    bias = (2.0 * rng.standard_normal((h, sq, sk))).astype(np.float32)
    return q, k, v, do, bias


@pytest.mark.parametrize("causal,sq,sk", [(False, 64, 64), (True, 64, 64),
                                          (False, 32, 96)])
def test_flash_bias_forward_and_lse_match_jax_kernel(causal, sq, sk):
    """o and lse of the port's plain forward with a (heads, sq, sk) bias vs
    the JAX Pallas forward in interpret mode at 32-row blocks (b 2, h 3,
    so row bh takes head bh % 3); atol 2e-5 (o) and 1e-5 (lse)."""
    q, k, v, _, bias = _qkv_bias(1, 2, 3, sq, sk, 32)
    scale = 1 / np.sqrt(32)
    q3, k3, v3 = (a.reshape(6, -1, 32) for a in (q, k, v))
    o_j, lse_j = _fa_fwd(jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3),
                         scale, causal, 32, 32, interpret=True,
                         bias=jnp.asarray(bias))
    o, lse = flash_attention_fwd_reference(_t(q3), _t(k3), _t(v3), scale,
                                           causal, bias=_t(bias))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5)


@pytest.mark.parametrize("causal,sq,sk,rate", [
    (False, 64, 64, 0.0), (True, 64, 64, 0.0), (False, 32, 96, 0.0),
    (False, 64, 64, 0.25), (True, 64, 64, 0.3), (False, 32, 96, 0.2)])
def test_flash_bias_backward_kernels_match_jax(causal, sq, sk, rate):
    """dq, dk, dv and d(bias) of the port's plain backward versions vs the
    JAX Pallas backward kernels (``_fa_bwd``, interpret mode, 32-row
    blocks) from the same o and lse, causal, rectangular and with the
    counter-hash dropout; atol 1e-4 (dq, dk, dv, as the JAX package's own
    flash backward test) and 2e-4 (d(bias): a sum over the batch of the
    unscaled ds, as ``tests/test_attention.py`` holds it)."""
    q, k, v, do, bias = _qkv_bias(2, 2, 2, sq, sk, 32)
    scale, seed = 1 / np.sqrt(32), 77
    q3, k3, v3 = (a.reshape(4, -1, 32) for a in (q, k, v))
    do3 = do.reshape(4, -1, 32)
    jseed = jnp.asarray([seed], jnp.int32)
    jq, jk, jv, jdo, jb = (jnp.asarray(a) for a in (q3, k3, v3, do3, bias))
    o_j, lse_j = _fa_fwd(jq, jk, jv, scale, causal, 32, 32, True, rate,
                         jseed, bias=jb)
    want = _fa_bwd(jq, jk, jv, o_j, lse_j, jdo, scale, causal, 32, 32, True,
                   rate, jseed, bias=jb)
    args = (_t(q3), _t(k3), _t(v3), _t(np.asarray(o_j)),
            _t(np.asarray(lse_j)), _t(do3), scale, causal, rate, seed)
    got = flash_attention_bwd_reference(*args, bias=_t(bias))
    db = flash_attention_bwd_dbias_reference(*args, bias=_t(bias))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)
    assert db.dtype == torch.float32 and db.shape == (2, sq, sk)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[3]), atol=2e-4)
    if causal:  # above the diagonal no score is live
        above = np.triu(np.ones((sq, sk), bool), 1)
        assert not db.numpy()[:, above].any()


@pytest.mark.parametrize("causal,sq,sk,rate", [
    (False, 64, 64, 0.0), (True, 64, 64, 0.3), (False, 32, 96, 0.0)])
def test_flash_bias_grads_through_autograd_match_jax(causal, sq, sk, rate):
    """o and the gradients of q, k, v and the bias through the port's
    ``flash_attention(bias=)`` (``FlashAttention``, plain versions) vs
    ``jax.vjp`` of the JAX front door on its Pallas kernels (interpret
    mode, 32-row blocks); atol 2e-5 (o), 1e-4 (q, k, v), 2e-4 (bias)."""
    q, k, v, do, bias = _qkv_bias(3, 2, 2, sq, sk, 32)
    seed = 5
    kw = dict(causal=causal, dropout_rate=rate)
    o_j, vjp = jax.vjp(lambda q, k, v, b: jax_flash(
        q, k, v, use_pallas=True, interpret=True, block_q=32, block_k=32,
        bias=b, dropout_seed=jnp.int32(seed) if rate else None, **kw),
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    o = flash_attention(*leaves[:3], bias=leaves[3],
                        dropout_seed=seed if rate else None, **kw)
    o.backward(_t(do))
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=2e-5)
    for t, w, name, atol in zip(leaves, want, ("q", "k", "v", "bias"),
                                (1e-4, 1e-4, 1e-4, 2e-4)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=atol,
                                   err_msg=f"d{name}")


def test_flash_bias_bf16_matches_jax_and_keeps_the_bias_dtype():
    """bf16 q, k, v with a bf16 bias: the output vs JAX's interpret-mode
    kernels within atol 3e-2 (the JAX package's own bf16 flash bound: p
    rounded to bf16 at other running maxima), and the bias gradient comes
    back in the bias's dtype (``_flash3_bias_bwd`` casts it)."""
    q, k, v, do, bias = _qkv_bias(4, 2, 2, 64, 64, 32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, bias)]
    want = jax_flash(*jb[:3], bias=jb[3], causal=True, use_pallas=True,
                     interpret=True, block_q=32, block_k=32)
    leaves = [_t(a).bfloat16().requires_grad_() for a in (q, k, v, bias)]
    got = flash_attention(*leaves[:3], bias=leaves[3], causal=True)
    got.backward(_t(do).bfloat16())
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(
        jnp.float32)), atol=3e-2)
    assert got.dtype == torch.bfloat16
    assert leaves[3].grad.dtype == torch.bfloat16
    assert leaves[3].grad.shape == (2, 64, 64)


def test_masked_attention_with_bias_takes_the_reference_path_like_jax():
    """``mask=`` with a bias goes to ``attention_reference`` on both
    sides; atol 2e-5."""
    q, k, v, _, bias = _qkv_bias(5, 1, 2, 16, 16, 8)
    mask = np.arange(16)[None, None, None, :] >= 11
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                     mask=jnp.asarray(mask), bias=jnp.asarray(bias))
    got = flash_attention(_t(q), _t(k), _t(v), mask=_t(mask), bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# relative position buckets and bias


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (24, 100)])
def test_rel_pos_bucket_equals_jax_exactly(bidirectional, num_buckets,
                                           max_distance):
    """Every distance in ±1024 lands in JAX's bucket, both schemes, at
    T5's (32, 128) and at a scheme whose divisors are not powers of two."""
    rel = np.arange(-1024, 1025, dtype=np.int32)
    kw = dict(bidirectional=bidirectional, num_buckets=num_buckets,
              max_distance=max_distance)
    want = np.asarray(jt5._rel_pos_bucket(jnp.asarray(rel), **kw))
    got = _rel_pos_bucket(_t(rel), **kw).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == num_buckets - 1


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("sq,sk", [(24, 24), (8, 20)])
def test_t5_relative_bias_and_table_grad_match_jax(bidirectional, sq, sk):
    """The (heads, sq, sk) bias equals JAX's exactly (a gather), and the
    table's gradient (the port's fixed-order sum over diagonals, then
    buckets) matches ``jax.vjp`` of JAX's gather within rtol 1e-5, atol
    1e-6; a bf16 table gets a bf16 gradient; two backwards repeat
    bitwise."""
    jcfg = jt5.T5Config(num_heads=4, relative_position_bias=True)
    cfg = T5Config(num_heads=4, relative_position_bias=True)
    rng = np.random.default_rng(7)
    table = rng.standard_normal((32, 4)).astype(np.float32)
    g = rng.standard_normal((4, sq, sk)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jt5.t5_relative_bias(
        t, sq, sk, bidirectional=bidirectional, cfg=jcfg), jnp.asarray(table))
    grads = []
    for _ in range(2):
        tt = _t(table).requires_grad_()
        got = t5_relative_bias(tt, sq, sk, bidirectional=bidirectional,
                               cfg=cfg)
        got.backward(_t(g))
        grads.append(tt.grad)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_allclose(grads[0].numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(grads[0], grads[1])
    t16 = _t(table).bfloat16().requires_grad_()
    t5_relative_bias(t16, sq, sk, bidirectional=bidirectional,
                     cfg=cfg).backward(_t(g))
    assert t16.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the model and its train step vs JAX

SMALL = dict(vocab_size=96, hidden=64, num_heads=4, enc_layers=2,
             dec_layers=2, max_seq_enc=16, max_seq_dec=8)
B, S_ENC, S_DEC = 2, 16, 8
LR = 1e-3
_JAX_RUNS = {}


def _configs(rel, final_ln, fused):
    flags = dict(relative_position_bias=rel, encoder_final_ln=final_ln,
                 fused_loss=fused)
    return (jt5.T5Config(dtype=jnp.float32, **SMALL, **flags),
            T5Config(dtype=torch.float32, **SMALL, **flags))


def _jax_loss_fn(jcfg):
    mesh = build_mesh(tp=1, pp=1, sp=1)
    specs = jt5.t5_param_specs(jcfg)

    def loss_fn(p, e, d, t):
        def body(p, e, d, t):
            return jt5.t5_loss(p, e, d, t, jcfg)

        return jax.shard_map(body, mesh=mesh,
                             in_specs=(specs, P(), P(), P()),
                             out_specs=P())(p, e, d, t)

    return loss_fn


def _jax_run(rel, final_ln, fused, steps=0):
    """JAX's loss and grads at init (and, with ``steps``, the losses and
    params of that many FusedAdam steps), all as numpy; cached."""
    key = (rel, final_ln, fused, steps)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    jcfg, _ = _configs(rel, final_ln, fused)
    params = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    enc = rng.integers(0, jcfg.vocab_size, (B, S_ENC)).astype(np.int32)
    dec = rng.integers(0, jcfg.vocab_size, (B, S_DEC)).astype(np.int32)
    tgt = np.roll(dec, -1, axis=1)
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss_fn(jcfg)))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    loss, g = grad_fn(params, enc, dec, tgt)
    out = {"params0": host(params), "enc": enc, "dec": dec, "tgt": tgt,
           "loss0": float(loss), "grads0": host(g)}
    if steps:
        opt = JFusedAdam(lr=LR)
        state = opt.init(params)
        losses = []
        for _ in range(steps):
            loss, g = grad_fn(params, enc, dec, tgt)
            u, state = opt.update(g, state, params)
            params = jax.tree.map(lambda a, b: a + b, params, u)
            losses.append(float(loss))
        out.update(losses=losses, params_end=host(params))
    _JAX_RUNS[key] = out
    return out


def _trainable(tree):
    params = params_from_numpy(tree, "cpu")
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def _batch(run):
    return (_t(run["enc"]).long(), _t(run["dec"]).long(),
            _t(run["tgt"]).long())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("final_ln", [True, False])
@pytest.mark.parametrize("rel", [True, False])
def test_t5_loss_and_grads_match_jax(rel, final_ln, fused):
    """Loss and every gradient leaf of the port's ``t5_loss`` (fp32, full
    remat) vs JAX ``value_and_grad`` of its ``t5_loss`` from the same
    params and tokens, with the relative bias on and off, the
    encoder-final LN on and off, fused and unfused loss; loss rtol 1e-5,
    grads rtol 5e-4, atol 1e-5 (as ``tests/test_t5.py`` holds tp = 2
    against tp = 1). With the bias the tables ``rel_enc`` / ``rel_dec``
    get nonzero gradients, which at init are far below 1e-5, so they are
    also held to 1e-4 of their own largest entry."""
    run = _jax_run(rel, final_ln, fused)
    _, cfg = _configs(rel, final_ln, fused)
    params = _trainable(run["params0"])
    loss = t5_loss(params, *_batch(run), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), run["loss0"], rtol=1e-5)
    got = dict(named_leaves(jax.tree.map(lambda t: t.grad.numpy(), params)))
    want = dict(named_leaves(run["grads0"]))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=5e-4,
                                   atol=1e-5, err_msg=name)
    if rel:  # small at init: also held to their own scale
        for name in ("embed.rel_enc", "embed.rel_dec"):
            scale = np.abs(want[name]).max()
            assert scale > 0 and np.abs(got[name]).max() > 0, name
            np.testing.assert_allclose(got[name], want[name], rtol=5e-4,
                                       atol=1e-4 * scale, err_msg=name)


def test_three_fused_adam_steps_track_jax():
    """Three steps of the port's ``t5_loss`` + ``FusedAdam`` (default
    ``fused_tail="auto"``: the tail's plain version on the CPU) vs three
    JAX steps (``FusedAdam`` default, the op chain off the TPU) from the
    same params, T5 proper (bias and final LN on, fused loss): losses
    rtol 1e-5; final params atol lr/100 + rtol 1e-5. Adam moves an
    element by about lr a step whatever its gradient's size, so where the
    gradient at init lies below the fp32 resolution of its sum (|g| <
    1e-5 of its leaf's largest: the key biases, whose exact gradient is 0
    as they shift a query's scores by one constant, and a few sums that
    cancel to ~1e-8, near Adam's eps) the two runs take different steps;
    those elements (under 1 % of all) are held to the 3·lr that three
    steps can move them."""
    run = _jax_run(True, True, True, steps=3)
    _, cfg = _configs(True, True, True)
    params = _trainable(run["params0"])
    opt = FusedAdam(param_leaves(params), lr=LR)
    batch = _batch(run)
    losses = []
    for _ in range(3):
        opt.zero_grad(set_to_none=True)
        loss = t5_loss(params, *batch, cfg)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    got = dict(named_leaves(jax.tree.map(_np, params)))
    g0 = dict(named_leaves(run["grads0"]))
    n_noisy = n_all = 0
    for name, want in named_leaves(run["params_end"]):
        noisy = np.abs(g0[name]) < 1e-5 * np.abs(g0[name]).max()
        n_noisy, n_all = n_noisy + int(noisy.sum()), n_all + noisy.size
        np.testing.assert_allclose(got[name][~noisy], want[~noisy],
                                   atol=LR / 100, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(got[name][noisy], want[noisy],
                                   atol=3 * LR, err_msg=name)
    # the key biases, the bias-table rows no distance reaches at s 16 / 8
    # (exact zeros), and a few cancelling sums: a small share
    assert n_noisy < 0.01 * n_all, (n_noisy, n_all)


def test_params_from_numpy_carries_the_t5_tree():
    """JAX's bf16 T5 tree, taken out as numpy, comes across with the same
    keys, shapes and bits (the bf16 tables included)."""
    jcfg = jt5.T5Config(**SMALL, relative_position_bias=True,
                        encoder_final_ln=True)
    tree = jax.tree.map(np.asarray,
                        jt5.init_t5_params(jax.random.PRNGKey(3), jcfg))
    params = params_from_numpy(tree, "cpu")
    want, got = dict(named_leaves(tree)), dict(named_leaves(params))
    assert sorted(got) == sorted(want)
    assert len(got) == 39
    for name, a in want.items():
        t = got[name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), a.view(np.int16), err_msg=name)


def test_init_t5_params_has_the_jax_tree():
    """The port's own init (numpy seed) gives JAX's keys, shapes and
    dtype, for T5 proper and for absolute positions."""
    for rel in (True, False):
        jcfg, cfg = _configs(rel, rel, True)
        want = jax.eval_shape(lambda: jt5.init_t5_params(
            jax.random.PRNGKey(0), jcfg))
        got = init_t5_params(cfg, seed=0, device="cpu")
        want, got = dict(named_leaves(want)), dict(named_leaves(got))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape, name
            assert got[name].dtype == torch.float32


def test_build_t5_train_step_on_cpu_falls_and_repeats():
    """T5 proper at a tiny size on the CPU: the targets are the decoder
    tokens rolled by one, the loss falls over 5 steps, and two builds
    from one seed give bitwise equal losses."""
    _, cfg = _configs(True, True, True)
    runs = []
    for _ in range(2):
        step, params, opt, (enc, dec, tgt) = build_t5_train_step(
            cfg, 2, S_ENC, S_DEC, device="cpu")
        assert enc.shape == (2, S_ENC) and dec.shape == (2, S_DEC)
        assert torch.equal(tgt, torch.roll(dec, -1, dims=1))
        runs.append([float(step()) for _ in range(5)])
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]
    assert all(np.isfinite(runs[0]))


@pytest.mark.parametrize("field,value", [
    ("attention_dropout", 0.1), ("hidden_dropout", 0.1),
    ("megatron_sp", True)])
def test_refused_t5_fields_raise(field, value):
    """Each refused field raises from ``validate()``, ``init_t5_params``,
    ``t5_loss`` and ``build_t5_train_step``. The dropout rates and
    ``megatron_sp``, ported since, are accepted: ``validate()`` passes and
    ``t5_loss`` and a ``build_t5_train_step`` step run on the CPU with a
    dropout key (``megatron_sp`` on one device: no mesh, tp = 1)."""
    cfg = dataclasses.replace(_configs(True, True, True)[1], **{field: value})
    if field in ("attention_dropout", "hidden_dropout", "megatron_sp"):
        cfg.validate()
        key = np.asarray(jax.random.PRNGKey(1))
        params = init_t5_params(cfg, device="cpu")
        for p in param_leaves(params):
            p.requires_grad_(True)
        z = torch.zeros(1, 8, dtype=torch.long)
        loss = t5_loss(params, z, z, z, cfg, dropout_key=key)
        loss.backward()
        assert np.isfinite(loss.item())
        step = build_t5_train_step(cfg, 1, 8, 8, device="cpu")[0]
        assert np.isfinite(float(step(key)))
        return
    with pytest.raises(NotImplementedError, match=field):
        cfg.validate()
    with pytest.raises(NotImplementedError, match=field):
        init_t5_params(cfg, device="cpu")
    z = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match=field):
        t5_loss({}, z, z, z, cfg)
    with pytest.raises(NotImplementedError, match=field):
        build_t5_train_step(cfg, 1, 8, 8, device="cpu")
