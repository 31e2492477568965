"""apex_tpu_torch's Megatron functional ops on the CPU, against apex_tpu:
the scale-mask softmax functions and ``FusedScaleMaskSoftmax``, the
label-smoothing cross-entropy, ``MLP`` and the fused dense modules.

JAX computes each in XLA (no Pallas kernel), so the port's plain PyTorch
is its port; the same numpy inputs (and, for the modules, the flax
parameters carried by ``convert.module_from_numpy``) go through both, and
each test holds the forward and the gradient within the stated tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.fused_dense import FusedDense as JFusedDense
from apex_tpu.fused_dense import FusedDenseGeluDense as JFusedDenseGeluDense
from apex_tpu.mlp import MLP as JMLP
from apex_tpu.ops import softmax as jsoftmax
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as jax_xent
from apex_tpu.transformer.enums import AttnMaskType as JAttnMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JFusedScaleMaskSoftmax)

from apex_tpu_torch.contrib.xentropy import (SoftmaxCrossEntropyLoss,
                                             softmax_cross_entropy_loss)
from apex_tpu_torch.convert import module_from_numpy
from apex_tpu_torch.fused_dense import (FusedDense, FusedDenseGeluDense,
                                        fused_dense)
from apex_tpu_torch.mlp import MLP
from apex_tpu_torch.ops import softmax as tsoftmax
from apex_tpu_torch.transformer import AttnMaskType, AttnType, LayerType
from apex_tpu_torch.transformer import ModelType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

# fp32: one op chain each, sums in other orders; bf16: one rounding of
# the bf16 output (2**-8 relative) on values up to 1
TOL = {"float32": dict(atol=1e-6, rtol=1e-5),
       "bfloat16": dict(atol=2 ** -8, rtol=2 ** -7)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _vjp(fn, args, dy):
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(dy)


def _scores(seed, shape=(2, 3, 16, 16)):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) * 3).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["padding", "causal", "none"])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_softmax_functions_match_jax(kind, dtype, scale):
    """``scaled_masked_softmax`` (a padding mask), the causal
    ``scaled_upper_triang_masked_softmax`` and ``scaled_softmax``: output
    and the backward from the saved output vs JAX's ``custom_vjp``, in x's
    type; the causal gradient zero above the diagonal."""
    x, dy = _scores(1)
    mask = np.arange(16)[None, None, None, :] >= 11
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    tx = _t(x, tdt).requires_grad_()
    if kind == "padding":
        want, (dx,) = _vjp(lambda a: jsoftmax.scaled_masked_softmax(
            a, jnp.asarray(mask), scale), (jx,), jdy)
        got = tsoftmax.scaled_masked_softmax(tx, torch.from_numpy(mask),
                                             scale)
    elif kind == "causal":
        causal = jsoftmax.scaled_upper_triang_masked_softmax
        want, (dx,) = _vjp(lambda a: causal(a, scale), (jx,), jdy)
        got = tsoftmax.scaled_upper_triang_masked_softmax(tx, scale)
    else:
        want, (dx,) = _vjp(lambda a: jsoftmax.scaled_softmax(a, scale), (jx,),
                           jdy)
        got = tsoftmax.scaled_softmax(tx, scale)
    got.backward(_t(dy, tdt))
    assert got.dtype == tdt and tx.grad.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx.astype(
        jnp.float32)), **TOL[dtype])
    if kind == "causal":
        upper = np.triu(np.ones((16, 16), bool), 1)
        assert (_np(tx.grad)[..., upper] == 0).all()
    assert tsoftmax.MASK_FILL == jsoftmax.MASK_FILL


@pytest.mark.parametrize("fp16,bf16,fusion,mask_type", [
    (False, True, True, "causal"), (False, True, True, "padding"),
    (False, False, True, "padding"), (False, True, False, "padding"),
    (True, False, False, "causal")])
def test_fused_scale_mask_softmax_gate_and_paths_match_jax(fp16, bf16,
                                                           fusion, mask_type):
    """``FusedScaleMaskSoftmax``: the same gate as JAX's (fusion and a half-
    precision flag), the fused path through the softmax functions, the
    torch path (fp32 upcast, scale, mask, softmax, downcast): forward and
    gradient vs JAX's module, bf16 inputs where a half flag is set."""
    x, dy = _scores(2)
    dtype = "bfloat16" if (fp16 or bf16) else "float32"
    mask = np.zeros((2, 1, 16, 16), bool)
    mask[1, :, :, 12:] = True
    kw = dict(input_in_fp16=fp16, input_in_bf16=bf16,
              scaled_masked_softmax_fusion=fusion, scale=0.5)
    jmod = JFusedScaleMaskSoftmax(
        attn_mask_type=getattr(JAttnMaskType, mask_type), **kw)
    tmod = FusedScaleMaskSoftmax(
        attn_mask_type=getattr(AttnMaskType, mask_type), **kw)
    assert (tmod.is_kernel_available(None, 2, 3, 16, 16)
            == jmod.is_kernel_available(None, 2, 3, 16, 16))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = None if mask_type == "causal" and fusion else jnp.asarray(mask)
    tm = None if jm is None else torch.from_numpy(mask)
    want, (dx,) = _vjp(lambda a: jmod(a, jm), (jnp.asarray(x, jdt),),
                       jnp.asarray(dy, jdt))
    tx = _t(x, tdt).requires_grad_()
    got = tmod(tx, tm)
    got.backward(_t(dy, tdt))
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx.astype(
        jnp.float32)), **TOL[dtype])


def test_fused_scale_mask_softmax_checks_and_mask_func():
    """The constructor's checks, the causal path's square check and a
    caller's ``mask_func`` on the torch path, as in JAX; the enums keep
    JAX's members."""
    with pytest.raises(ValueError, match="both fp16 and bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(ValueError, match="fp32 when scaled"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=2.0)
    mod = FusedScaleMaskSoftmax(input_in_bf16=True,
                                attn_mask_type=AttnMaskType.causal)
    with pytest.raises(ValueError, match="self attention"):
        mod(torch.zeros(1, 1, 4, 8, dtype=torch.bfloat16))
    x, _ = _scores(3)
    mask = np.arange(16)[None, None, None, :] >= 9

    def fill(a, m):
        return a.masked_fill(m, -50.0) if isinstance(a, torch.Tensor) \
            else jnp.where(m, -50.0, a)

    got = FusedScaleMaskSoftmax(mask_func=fill)(_t(x), torch.from_numpy(mask))
    want = JFusedScaleMaskSoftmax(mask_func=fill)(jnp.asarray(x),
                                                  jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])
    from apex_tpu.transformer import enums as jenums
    for mine, theirs in ((AttnMaskType, jenums.AttnMaskType),
                         (AttnType, jenums.AttnType),
                         (LayerType, jenums.LayerType),
                         (ModelType, jenums.ModelType)):
        assert ({m.name: m.value for m in mine}
                == {m.name: m.value for m in theirs})


@pytest.mark.parametrize("dtype,half_to_float", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True)])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(smoothing, dtype, half_to_float):
    """Per-example loss and the gradient from the saved lse vs JAX's
    ``softmax_cross_entropy_loss``; the loss in the logits' type, fp32
    with ``half_to_float``; the contrib alias is the same function."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((24, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, 24)
    dloss = rng.standard_normal(24).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, vjp = jax.vjp(lambda a: jax_xent(a, jnp.asarray(labels), smoothing,
                                           half_to_float),
                        jnp.asarray(logits, jdt))
    out_dt = jnp.float32 if half_to_float else jdt
    (dx,) = vjp(jnp.asarray(dloss, out_dt))
    tx = _t(logits, tdt).requires_grad_()
    got = softmax_cross_entropy_loss(tx, torch.from_numpy(labels), smoothing,
                                     half_to_float)
    assert got.dtype == (torch.float32 if half_to_float else tdt)
    got.backward(_t(dloss, got.dtype))
    assert tx.grad.dtype == tdt
    # an fp32 loss (fp32 logits, or half_to_float) to fp32 rounding; a bf16
    # loss (values up to ~8) to one bf16 rounding
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32" or half_to_float
           else dict(atol=2e-2, rtol=2 ** -7))
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **tol)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx.astype(
        jnp.float32)), **TOL[dtype])
    assert SoftmaxCrossEntropyLoss is softmax_cross_entropy_loss


def _module_vjp(jmod, x, dy):
    """A flax module's params (numpy), output and gradients w.r.t. input
    and params."""
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out, vjp = jax.vjp(lambda p, a: jmod.apply(p, a), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    return host(params), np.asarray(out), host(gp)["params"], np.asarray(gx)


def _check_module(tmod, jparams, jout, jgp, jgx, x, dy, tol):
    module_from_numpy(jparams, tmod)
    tx = _t(x).requires_grad_()
    out = tmod(tx)
    out.backward(_t(dy))
    np.testing.assert_allclose(_np(out), jout, **tol)
    np.testing.assert_allclose(_np(tx.grad), jgx, **tol)
    grads = {n: p.grad for n, p in tmod.named_parameters()}
    assert sorted(grads) == sorted(jgp)
    for name, g in grads.items():
        np.testing.assert_allclose(_np(g), jgp[name], err_msg=name, **tol)


@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
@pytest.mark.parametrize("bias", [True, False])
def test_mlp_matches_jax(activation, bias):
    """``MLP([32, 64, 48, 16])`` with JAX's flax parameters carried by
    ``convert.module_from_numpy``: output and the gradients of the input
    and every kernel and bias vs JAX; fp32 atol 1e-5, rtol 1e-5 (three
    products, sums in other orders)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    dy = rng.standard_normal((8, 16)).astype(np.float32)
    sizes = [32, 64, 48, 16]
    jres = _module_vjp(JMLP(sizes, bias=bias, activation=activation), x, dy)
    tmod = MLP(sizes, bias=bias, activation=activation)
    _check_module(tmod, *jres, x, dy, dict(atol=1e-5, rtol=1e-5))
    with pytest.raises(ValueError, match="activation"):
        MLP(sizes, activation="tanh")
    with pytest.raises(ValueError, match="at least"):
        MLP([8])


@pytest.mark.parametrize("use_bias", [True, False])
def test_fused_dense_matches_jax(use_bias):
    """``FusedDense(40, 24)`` with JAX's params: output and gradients
    (fp32 atol 1e-5, rtol 1e-5); a bf16 input with fp32 weights promotes
    to fp32 as JAX's ``x @ kernel`` does."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, 40)).astype(np.float32)
    dy = rng.standard_normal((4, 6, 24)).astype(np.float32)
    jres = _module_vjp(JFusedDense(24, use_bias=use_bias), x, dy)
    tmod = FusedDense(40, 24, use_bias=use_bias)
    _check_module(tmod, *jres, x, dy, dict(atol=1e-5, rtol=1e-5))
    y = fused_dense(_t(x, torch.bfloat16), tmod.kernel, tmod.bias)
    assert y.dtype == torch.float32


def test_fused_dense_gelu_dense_matches_jax():
    """``FusedDenseGeluDense(32 -> 96 -> 32)``, the exact erf GELU: output
    and every gradient vs JAX (fp32 atol 1e-5, rtol 1e-5)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((10, 32)).astype(np.float32)
    dy = rng.standard_normal((10, 32)).astype(np.float32)
    jres = _module_vjp(JFusedDenseGeluDense(96, 32), x, dy)
    tmod = FusedDenseGeluDense(32, 96, 32)
    _check_module(tmod, *jres, x, dy, dict(atol=1e-5, rtol=1e-5))
    with pytest.raises(ValueError, match="do not match"):
        module_from_numpy({"kernel": np.zeros((32, 96))}, tmod)
