"""``contrib.transducer`` of the port against JAX's
(``apex_tpu/contrib/transducer``), on the CPU: the joint (dense, masked,
ReLU, dropout, packed), the packed-input unpacking, the RNN-T loss and
its gradients for dense and packed inputs, the anti-diagonal recursion
against a cell-by-cell numpy lattice, and the modules.

Tolerances: the joint bitwise (one add, one ReLU, one product by the same
keep mask); losses rtol 1e-5 and gradients atol 1e-6 + rtol 1e-5 (fp32
log-space sums, each cell's arithmetic JAX's, the gathers and log-softmax
in other kernels); fp64 against numpy rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib.transducer import TransducerJoint as JJoint
from apex_tpu.contrib.transducer import TransducerLoss as JLoss
from apex_tpu.contrib.transducer import transducer_joint as jax_joint
from apex_tpu.contrib.transducer import transducer_loss as jax_loss
from apex_tpu.contrib.transducer.transducer import (
    unpack_transducer_input as jax_unpack)

from apex_tpu_torch.contrib.transducer import (TransducerJoint,
                                               TransducerLoss,
                                               transducer_joint,
                                               transducer_loss,
                                               unpack_transducer_input)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lattice(seed, B=3, T=5, U=4, V=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, U + 1, V).astype(np.float32)
    label = rng.randint(1, V, (B, U)).astype(np.int32)
    f_len = np.asarray([T, T - 1, T - 2][:B], np.int32)
    y_len = np.asarray([U, U - 2, U - 1][:B], np.int32)
    return x, label, f_len, y_len


def _numpy_nll(logp, label, T, U, blank=0):
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U + 1):
            c = []
            if t > 0:
                c.append(alpha[t - 1, u] + logp[t - 1, u, blank])
            if u > 0:
                c.append(alpha[t, u - 1] + logp[t, u - 1, label[u - 1]])
            if c:
                alpha[t, u] = np.logaddexp.reduce(c)
    return -(alpha[T - 1, U] + logp[T - 1, U, blank])


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("lens", [False, True])
def test_joint_dense_matches_jax(relu, lens):
    rng = np.random.RandomState(1)
    f = rng.randn(3, 5, 8).astype(np.float32)
    g = rng.randn(3, 4, 8).astype(np.float32)
    f_len, g_len = (np.asarray([5, 3, 4]), np.asarray([4, 2, 3])) \
        if lens else (None, None)
    want = jax_joint(jnp.asarray(f), jnp.asarray(g),
                     None if f_len is None else jnp.asarray(f_len),
                     None if g_len is None else jnp.asarray(g_len),
                     relu=relu)
    got = transducer_joint(_t(f), _t(g),
                           None if f_len is None else _t(f_len),
                           None if g_len is None else _t(g_len), relu=relu)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pack", [False, True])
def test_joint_dropout_keeps_jax_bits(pack):
    """Dropout under one key: JAX's bernoulli keep mask, bit for bit."""
    rng = np.random.RandomState(2)
    f = rng.randn(3, 5, 8).astype(np.float32)
    g = rng.randn(3, 4, 8).astype(np.float32)
    f_len, g_len = np.asarray([5, 3, 4]), np.asarray([4, 2, 3])
    offset = np.cumsum(f_len * g_len)
    key = jax.random.PRNGKey(7)
    kw = dict(relu=True, dropout_rate=0.3)
    if pack:
        kw.update(pack_output=True, packed_batch=int(offset[-1]) + 2)
    want = jax_joint(jnp.asarray(f), jnp.asarray(g), jnp.asarray(f_len),
                     jnp.asarray(g_len), dropout_rng=key,
                     batch_offset=jnp.asarray(offset) if pack else None,
                     **kw)
    got = transducer_joint(_t(f), _t(g), _t(f_len), _t(g_len),
                           dropout_rng=np.asarray(key, np.uint32),
                           batch_offset=_t(offset) if pack else None, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert JJoint(relu=True, dropout=0.3)(jnp.asarray(f),
                                          jnp.asarray(g)).shape \
        == TransducerJoint(relu=True, dropout=0.3)(_t(f), _t(g)).shape


def test_joint_packed_matches_jax_and_dense():
    """pack_output: batch b's cell (t, u) at row offset[b-1] + t * g_len[b]
    + u, surplus rows zero, bitwise JAX's and the dense joint's cells."""
    rng = np.random.RandomState(5)
    B, T, U, Hd = 3, 5, 4, 8
    f = rng.randn(B, T, Hd).astype(np.float32)
    g = rng.randn(B, U, Hd).astype(np.float32)
    f_len, g_len = np.asarray([5, 3, 4]), np.asarray([4, 2, 3])
    offset = np.cumsum(f_len * g_len)
    pb = int(offset[-1]) + 3
    want = jax_joint(jnp.asarray(f), jnp.asarray(g), jnp.asarray(f_len),
                     jnp.asarray(g_len), relu=True, pack_output=True,
                     batch_offset=jnp.asarray(offset), packed_batch=pb)
    got = TransducerJoint(pack_output=True, relu=True)(
        _t(f), _t(g), _t(f_len), _t(g_len), batch_offset=_t(offset),
        packed_batch=pb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dense = np.maximum(f[:, :, None, :] + g[:, None, :, :], 0.0)
    cells = np.concatenate([dense[b, :f_len[b], :g_len[b]].reshape(-1, Hd)
                            for b in range(B)])
    np.testing.assert_array_equal(got[:offset[-1]].numpy(), cells)
    assert not got[offset[-1]:].any()
    with pytest.raises(ValueError, match="pack_output"):
        transducer_joint(_t(f), _t(g), pack_output=True)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_loss_and_grads_match_jax(seed):
    """The per-sequence NLL and d(sum NLL)/dx (through the fp32
    log-softmax) against JAX's ``TransducerLoss``; the loss against a
    cell-by-cell numpy lattice too."""
    x, label, f_len, y_len = _lattice(seed)
    args_j = (jnp.asarray(label), jnp.asarray(f_len), jnp.asarray(y_len))
    want, vjp = jax.vjp(lambda x: JLoss()(x, *args_j), jnp.asarray(x))
    (g_j,) = vjp(jnp.ones_like(want))
    xt = _t(x).requires_grad_()
    got = TransducerLoss()(xt, _t(label), _t(f_len), _t(y_len))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)
    logp = torch.log_softmax(_t(x).double(), -1).numpy()
    for b in range(x.shape[0]):
        np.testing.assert_allclose(
            float(got[b].detach()), _numpy_nll(logp[b], label[b], f_len[b],
                                      y_len[b]), rtol=1e-5)


def test_loss_fp64_matches_numpy_lattice_and_blank_idx():
    """In fp64 the recursion equals the numpy lattice to rtol 1e-12, at
    another blank index too (against JAX's fp32 loss at rtol 1e-5)."""
    x, label, f_len, y_len = _lattice(4, B=2, T=7, U=5, V=9)
    logp = torch.log_softmax(_t(x).double(), -1)
    for blank in (0, 3):
        got = transducer_loss(logp, _t(label), _t(f_len), _t(y_len),
                              blank_idx=blank)
        for b in range(2):
            np.testing.assert_allclose(
                float(got[b]), _numpy_nll(logp[b].numpy(), label[b],
                                          f_len[b], y_len[b], blank),
                rtol=1e-12)
        want = jax_loss(jnp.asarray(logp.float().numpy()),
                        jnp.asarray(label), jnp.asarray(f_len),
                        jnp.asarray(y_len), blank_idx=blank)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_one_frame_and_no_labels():
    """T = 1 (only vertical moves) and y_len = 0 (only blanks) against
    JAX's."""
    for B, T, U in ((2, 1, 3), (2, 4, 2)):
        x, label, _, _ = _lattice(6, B=B, T=T, U=U, V=5)
        f_len = np.full(B, T, np.int32)
        y_len = np.asarray([U, 0][:B], np.int32)
        logp = torch.log_softmax(_t(x), -1)
        got = transducer_loss(logp, _t(label), _t(f_len), _t(y_len))
        want = jax_loss(jnp.asarray(logp.numpy()), jnp.asarray(label),
                        jnp.asarray(f_len), jnp.asarray(y_len))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_packed_loss_matches_jax_and_dense():
    """packed_input: the loss and the packed cotangent against JAX's and
    the dense loss's valid cells; ``unpack_transducer_input`` bitwise."""
    x, label, f_len, y_len = _lattice(6)
    B, T, U1, V = x.shape
    offset = np.cumsum(f_len * (y_len + 1))
    x_packed = np.concatenate([x[b, :f_len[b], :y_len[b] + 1].reshape(-1, V)
                               for b in range(B)])
    args_t = (_t(label), _t(f_len), _t(y_len))
    args_j = (jnp.asarray(label), jnp.asarray(f_len), jnp.asarray(y_len))
    np.testing.assert_array_equal(
        unpack_transducer_input(_t(x_packed), _t(f_len), _t(y_len),
                                _t(offset), T, U1).numpy(),
        np.asarray(jax_unpack(jnp.asarray(x_packed), jnp.asarray(f_len),
                              jnp.asarray(y_len), jnp.asarray(offset), T,
                              U1)))
    want, g_j = jax.value_and_grad(lambda x: jnp.sum(JLoss(
        packed_input=True)(x, *args_j, batch_offset=jnp.asarray(offset),
                           max_f_len=T)))(jnp.asarray(x_packed))
    xp = _t(x_packed).requires_grad_()
    got = TransducerLoss(packed_input=True)(xp, *args_t,
                                            batch_offset=_t(offset),
                                            max_f_len=T).sum()
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(xp.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)
    xd = _t(x).requires_grad_()
    TransducerLoss()(xd, *args_t).sum().backward()
    dense = np.concatenate([xd.grad.numpy()[b, :f_len[b], :y_len[b] + 1]
                            .reshape(-1, V) for b in range(B)])
    np.testing.assert_allclose(xp.grad.numpy(), dense, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="packed_input"):
        TransducerLoss(packed_input=True)(xp, *args_t)
