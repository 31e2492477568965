"""``RNN`` on the CPU, the port against apex_tpu: every cell (LSTM, GRU,
tanh and ReLU RNNs, mLSTM), one layer and stacked, one-way and
bidirectional, forward and every gradient, on flax's parameters carried
across by ``convert.module_from_numpy`` and numpy-seeded inputs; fp32
within 1e-5 (gradients within 1e-5 + 1e-5 of the largest |gradient| of
a leaf: both sides sum the time steps' products in their own orders).
Dropout between layers: the port's mask bitwise
``jax.random.bernoulli(fold_in(key, layer), 1 - rate)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import RNN as jrnn

from apex_tpu_torch import RNN as prnn
from apex_tpu_torch.convert import module_from_numpy, module_to_flax
from apex_tpu_torch.transformer.tensor_parallel import random as tp_random

CELLS = ["LSTM", "GRU", "RNNTanh", "RNNReLU"]


def _close(got, want, atol=1e-5, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _pair(jm, pm, x):
    var = jm.init(jax.random.PRNGKey(0), x)
    # biases nonzero so every term shows
    var = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(
        np.random.default_rng(a.size).standard_normal(a.shape),
        a.dtype), var)
    module_from_numpy(jax.tree.map(np.asarray, var), pm)
    return var


def _check(jm, pm, x, out_of=lambda y: y):
    var = _pair(jm, pm, x)
    ct = np.random.default_rng(9).standard_normal(
        np.shape(out_of(jm.apply(var, x)))).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(out_of(jm.apply({"params": params}, xx)) * ct)

    jy = out_of(jm.apply(var, x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(var["params"], x)
    xt = torch.from_numpy(x).requires_grad_()
    y = out_of(pm(xt))
    _close(y.detach(), jy, what="output")
    (y * torch.from_numpy(ct)).sum().backward()
    _close(xt.grad, jgx, what="d x")
    got = module_to_flax({n: p.grad for n, p in pm.named_parameters()}, pm)
    want = jax.tree.map(np.asarray, jgp)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    gflat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat) == len(gflat)
    for path, w in flat:
        tol = 1e-5 * max(float(np.abs(w).max()), 1e-12)
        _close(gflat[path], w, atol=tol, rtol=1e-5,
               what=jax.tree_util.keystr(path))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("layers,bidirectional", [(1, False), (2, False),
                                                  (2, True)])
def test_cells_stacked_and_bidirectional_match_jax(cell, layers,
                                                   bidirectional):
    x = np.random.default_rng(1).standard_normal((3, 7, 5)).astype(
        np.float32)
    jm = getattr(jrnn, cell)(5, 6, layers, bidirectional)
    pm = getattr(prnn, cell)(5, 6, layers, bidirectional, device="cpu")
    assert set(dict(pm.named_parameters())) == {
        f"layer_{i}{sfx}.{w}" for i in range(layers)
        for sfx in ("", "_rev")[:1 + bidirectional]
        for w in ("w_ih", "w_hh", "bias")}
    _check(jm, pm, x)


def test_mlstm_matches_jax():
    """The multiplicative LSTM: the outputs and the final (h, c), every
    gradient."""
    x = np.random.default_rng(2).standard_normal((2, 6, 4)).astype(
        np.float32)
    jm, pm = jrnn.mLSTM(4, 8), prnn.mLSTM(4, 8, device="cpu")
    _check(jm, pm, x, out_of=lambda r: r[0])
    var = _pair(jm, pm, x)
    jy, (jh, jc) = jm.apply(var, x)
    y, (h, c) = pm(torch.from_numpy(x))
    _close(h.detach(), jh)
    _close(c.detach(), jc)


def test_dropout_between_layers():
    """Training with dropout: the mask after layer 0 is JAX's threefry
    bernoulli of fold_in(key, 0) (keep 1 - rate), kept values scaled by
    1 / (1 - rate); eval (deterministic) is the plain stack; a training
    call without a key raises."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 5, 3)).astype(np.float32))
    pm = prnn.LSTM(3, 16, 2, dropout=0.25, device="cpu")
    key = tp_random.prng_key(7)
    captured = {}
    second = pm.layer_1
    orig = second.forward

    def spy(h, init_carry=None):
        captured["h"] = h
        return orig(h, init_carry)

    second.forward = spy
    pm(x, deterministic=False, dropout_key=key)
    h0, _ = pm.layer_0(x)
    keep = np.asarray(jax.random.bernoulli(
        jnp.asarray(tp_random.fold_in(key, 0)), 0.75, tuple(h0.shape)))
    want = np.where(keep, h0.detach().numpy() / np.float32(0.75), 0)
    _close(captured["h"].detach(), want, atol=0, rtol=0)
    second.forward = orig
    torch.testing.assert_close(pm(x), pm.layer_1(pm.layer_0(x)[0])[0])
    with pytest.raises(ValueError, match="dropout_key"):
        pm(x, deterministic=False)
