"""``contrib.multihead_attn`` of the port against JAX's flax modules
(``apex_tpu/contrib/multihead_attn``), on the CPU: every option
combination of ``tests/test_contrib_attn.py``, the flax params copied in
with ``convert.module_from_numpy``, outputs and gradients, and dropout's
keep masks bitwise JAX's under the same key on the flash path (the
counter hash seeded by ``jax.random.bits``) and on the masked path
(``jax.random.bernoulli`` over the probabilities).

Tolerances: fp32 outputs atol 2e-5 (the JAX tests' own), gradients atol
1e-4 of each leaf's largest magnitude plus 2e-5 (sums in other orders);
keep masks bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib.multihead_attn import (
    EncdecMultiheadAttn as JEncdec)
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JSelf
from apex_tpu.ops.attention import attention_dropout_mask as jax_drop_mask

from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                   SelfMultiheadAttn)
from apex_tpu_torch.contrib.multihead_attn.modules import (
    bernoulli_keep, flash_dropout_seed)
from apex_tpu_torch.convert import module_from_numpy
from apex_tpu_torch.ops.attention import attention_dropout_mask

B, S, E, H = 2, 16, 32, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _key_data(key):
    return np.asarray(key, np.uint32)


def _masks(kind):
    kpm = am = None
    if kind in ("padding", "both"):
        kpm = np.arange(S)[None, :] >= np.array([[12], [9]])
    if kind in ("causal", "both"):
        am = np.triu(np.ones((S, S), bool), k=1)
    return kpm, am


def _pair(cls_j, cls_t, seed, **kw):
    return cls_j(embed_dim=E, num_heads=H, **kw), cls_t(E, H, device="cpu",
                                                       **kw)


def _check_grads(params_t, params_j_grads):
    for name, p in params_t.named_parameters():
        want = np.asarray(params_j_grads[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("norm_add", [False, True])
@pytest.mark.parametrize("masks", ["none", "padding", "causal", "both"])
def test_self_mha_matches_jax(bias, norm_add, masks):
    """Output and every parameter's gradient (eval mode) against JAX's
    ``SelfMultiheadAttn`` with its params, under each boolean mask
    combination (the flash path without a mask, the reference with one)."""
    mj, mt = _pair(JSelf, SelfMultiheadAttn, 0, bias=bias,
                   include_norm_add=norm_add)
    rng = np.random.default_rng(len(masks) + 2 * bias + 4 * norm_add)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    dy = rng.standard_normal((B, S, E)).astype(np.float32)
    params = mj.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    if bias:  # flax starts biases at zero: make them count
        params = dict(params)
        params["in_proj_bias"] = jnp.asarray(
            rng.standard_normal(3 * E).astype(np.float32) * 0.1)
        params["out_proj_bias"] = jnp.asarray(
            rng.standard_normal(E).astype(np.float32) * 0.1)
    module_from_numpy(jax.tree.map(np.asarray, params), mt)
    kpm, am = _masks(masks)
    kw_j = dict(key_padding_mask=None if kpm is None else jnp.asarray(kpm),
                attn_mask=None if am is None else jnp.asarray(am),
                is_training=False)
    y_j, vjp = jax.vjp(lambda p, x: mj.apply({"params": p}, x, **kw_j),
                       params, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(dy))
    xt = _t(x).requires_grad_()
    y = mt(xt, key_padding_mask=None if kpm is None else _t(kpm),
           attn_mask=None if am is None else _t(am), is_training=False)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-4)
    _check_grads(mt, gp_j)


def test_self_mha_additive_mask_matches_jax():
    mj, mt = _pair(JSelf, SelfMultiheadAttn, 0, mask_additive=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    am = (rng.standard_normal((S, S)) * 0.5).astype(np.float32)
    kpm, _ = _masks("padding")
    params = mj.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    module_from_numpy(jax.tree.map(np.asarray, params), mt)
    for pad in (None, kpm):
        want = mj.apply({"params": params}, jnp.asarray(x),
                        attn_mask=jnp.asarray(am), is_training=False,
                        key_padding_mask=None if pad is None
                        else jnp.asarray(pad))
        got = mt(_t(x), attn_mask=_t(am), is_training=False,
                 key_padding_mask=None if pad is None else _t(pad))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("norm_add", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_encdec_mha_matches_jax(bias, norm_add, padded):
    """Q from an 8-token decoder stream, K/V from a 16-token memory (with
    a padded tail): output and gradients against JAX's
    ``EncdecMultiheadAttn``."""
    mj, mt = _pair(JEncdec, EncdecMultiheadAttn, 0, bias=bias,
                   include_norm_add=norm_add)
    rng = np.random.default_rng(9 + bias + 2 * norm_add)
    q = rng.standard_normal((B, 8, E)).astype(np.float32)
    kv = rng.standard_normal((B, S, E)).astype(np.float32)
    dy = rng.standard_normal((B, 8, E)).astype(np.float32)
    params = mj.init(jax.random.PRNGKey(11), jnp.asarray(q),
                     jnp.asarray(kv))["params"]
    module_from_numpy(jax.tree.map(np.asarray, params), mt)
    kpm = _masks("padding")[0] if padded else None
    kw_j = dict(key_padding_mask=None if kpm is None else jnp.asarray(kpm),
                is_training=False)
    y_j, vjp = jax.vjp(lambda p, q, kv: mj.apply({"params": p}, q, kv,
                                                 **kw_j),
                       params, jnp.asarray(q), jnp.asarray(kv))
    gp_j, gq_j, gkv_j = vjp(jnp.asarray(dy))
    qt, kvt = _t(q).requires_grad_(), _t(kv).requires_grad_()
    y = mt(qt, kvt, key_padding_mask=None if kpm is None else _t(kpm),
           is_training=False)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=2e-5)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq_j), atol=1e-4)
    np.testing.assert_allclose(kvt.grad.numpy(), np.asarray(gkv_j),
                               atol=1e-4)
    _check_grads(mt, gp_j)


@pytest.mark.parametrize("module", ["self", "encdec"])
@pytest.mark.parametrize("masked", [False, True])
def test_mha_dropout_matches_jax_bitwise_masks(module, masked):
    """Training with dropout 0.5 under one key: the keep mask is JAX's bit
    for bit (the flash path's counter hash from ``jax.random.bits``
    without a mask; ``jax.random.bernoulli`` over the probabilities with
    one), so the outputs agree to fp32 sums; eval differs from training
    and repeats."""
    cls_j, cls_t = ((JSelf, SelfMultiheadAttn) if module == "self"
                    else (JEncdec, EncdecMultiheadAttn))
    mj, mt = _pair(cls_j, cls_t, 0, dropout=0.5)
    rng = np.random.default_rng(12 + masked)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    args_j = (jnp.asarray(x),) if module == "self" else (
        jnp.asarray(x), jnp.asarray(x))
    args_t = (_t(x),) if module == "self" else (_t(x), _t(x))
    params = mj.init({"params": jax.random.PRNGKey(13),
                      "dropout": jax.random.PRNGKey(14)}, *args_j)["params"]
    module_from_numpy(jax.tree.map(np.asarray, params), mt)
    kpm = _masks("padding")[0] if masked else None
    key = jax.random.PRNGKey(15)
    want = mj.apply({"params": params}, *args_j, is_training=True,
                    dropout_rng=key,
                    key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    got = mt(*args_t, is_training=True, dropout_rng=_key_data(key),
             key_padding_mask=None if kpm is None else _t(kpm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    if masked:
        shape = (B, H, S, S)
        keep = bernoulli_keep(_key_data(key), 0.5, shape, "cpu")
        np.testing.assert_array_equal(
            keep.numpy(), np.asarray(jax.random.bernoulli(key, 0.5, shape)))
    else:
        seed = flash_dropout_seed(_key_data(key))
        assert seed == int(jax.random.bits(key, dtype=jnp.uint32).astype(
            jnp.int32))
        np.testing.assert_array_equal(
            attention_dropout_mask(seed, 0.5, B * H, S, S).numpy(),
            np.asarray(jax_drop_mask(jnp.int32(seed), 0.5, B * H, S, S)))
    ev = mt(*args_t, is_training=False,
            key_padding_mask=None if kpm is None else _t(kpm))
    assert not torch.allclose(ev, got)
    assert torch.equal(ev, mt(*args_t, is_training=False,
                              key_padding_mask=None if kpm is None
                              else _t(kpm)))


def test_mha_bf16_params_match_jax():
    """bf16 params and input (the chip's setting): the output in bf16
    within one bf16 step (rtol 2**-7, atol 1e-2) of JAX's."""
    kw = dict(bias=True, include_norm_add=True)
    mj = JSelf(embed_dim=E, num_heads=H, param_dtype=jnp.bfloat16, **kw)
    mt = SelfMultiheadAttn(E, H, param_dtype=torch.bfloat16, device="cpu",
                           **kw)
    x = np.random.default_rng(3).standard_normal((B, S, E)).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    params = mj.init(jax.random.PRNGKey(2), xj)["params"]
    module_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   params), mt)
    want = mj.apply({"params": params}, xj, is_training=False)
    got = mt(_t(x).bfloat16(), is_training=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=2 ** -7)


def test_mha_refusals():
    with pytest.raises(ValueError, match="divisible"):
        SelfMultiheadAttn(30, 4, device="cpu")
    m = SelfMultiheadAttn(E, H, dropout=0.1, device="cpu")
    with pytest.raises(ValueError, match="dropout_rng"):
        m(torch.zeros(B, S, E))
