"""apex_tpu_torch.amp on the CPU, against apex_tpu.amp.

Every case of ``tests/test_amp.py`` is mirrored and held to JAX's values:
the same numpy inputs go through ``apex_tpu.amp`` and the port. JAX runs as
its own tests run it on the CPU; the port's kernel wrappers take their
plain versions for CPU tensors. Tolerances are stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.optimizers import FusedLAMB as JFusedLAMB
from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.transformer.amp import GradScaler as JGradScaler
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import gpt_param_specs
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch import amp
from apex_tpu_torch.amp import lists
from apex_tpu_torch.config import PrecisionConfig
from apex_tpu_torch.convert import (amp_state_from_numpy, named_leaves,
                                    params_from_numpy)
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.optimizers._common import tree_leaves
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.testing import GPTConfig, gpt_loss


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy().copy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16),
       "float16": (torch.float16, jnp.float16)}


def _same_dtype(t, j):
    return str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


# ---------------------------------------------------------------------------
# O1 autocast (test_amp.py:22-131)


def _rand(shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def test_whitelist_matmul_runs_bf16():
    """x @ w of fp32 inputs comes out bf16 on both sides, the same values
    (one bf16 product of the same bf16 operands: rtol 2**-7)."""
    x, w = _rand((4, 8)), _rand((8, 16), 1)
    got = amp.autocast(lambda x, w: x @ w)(_t(x), _t(w))
    want = jamp.autocast(lambda x, w: x @ w)(jnp.asarray(x), jnp.asarray(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2 ** -7, atol=1e-6)


def test_whitelist_conv_runs_bf16():
    """conv2d (NCHW) vs JAX's NHWC conv of the same data: bf16 out, values
    within one bf16 rounding."""
    x, k = _rand((1, 8, 8, 3)), _rand((3, 3, 3, 4), 1)
    fn = lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = jamp.autocast(fn)(jnp.asarray(x), jnp.asarray(k))
    got = amp.autocast(lambda x, k: F.conv2d(x, k, padding=1))(
        _t(x).permute(0, 3, 1, 2), _t(k).permute(3, 2, 0, 1))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), _jnp(want),
                               rtol=2 ** -7, atol=1e-5)


def test_blacklist_exp_stays_fp32():
    """exp of a bf16 product comes out fp32 on both sides, equal values
    (fp32 exp of the same bf16 product: rtol 1e-6)."""
    x, w = np.ones((4, 8), np.float32), np.full((8, 8), 0.1, np.float32)
    fn = lambda m: (lambda x, w: m.exp(x @ w))
    got = amp.autocast(fn(torch))(_t(x), _t(w))
    want = jamp.autocast(fn(jnp))(jnp.asarray(x), jnp.asarray(w))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=1e-6)


def test_blacklist_softmax_numerics():
    """softmax of a bf16 product: fp32 out on both sides. JAX subtracts the
    max in bf16 before its fp32 exp; the port's softmax runs on the fp32
    upcast: atol 2e-2 (JAX's own gate against fp32 softmax) and 1e-2
    between the two."""
    x = _rand((4, 128)) * 10
    w = np.eye(128, dtype=np.float32)
    want = jamp.autocast(lambda x, w: jax.nn.softmax(x @ w))(
        jnp.asarray(x), jnp.asarray(w))
    got = amp.autocast(lambda x, w: torch.softmax(x @ w, -1))(_t(x), _t(w))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    ref = np.asarray(jax.nn.softmax(jnp.asarray(x)))
    np.testing.assert_allclose(_np(got), ref, atol=2e-2)
    np.testing.assert_allclose(_np(got), _jnp(want), atol=1e-2)


@pytest.mark.parametrize("b_shape", [(4,), ()])
def test_promote_mixed_dtypes(b_shape):
    """bf16 + fp32 -> fp32, a 0-d fp32 tensor included (JAX promotes it;
    torch alone would keep bf16)."""
    a = jnp.ones((4,), jnp.bfloat16)
    b = jnp.ones(b_shape, jnp.float32)
    want = jamp.autocast(lambda a, b: a + b)(a, b)
    got = amp.autocast(lambda a, b: a + b)(
        torch.ones(4, dtype=torch.bfloat16), torch.ones(b_shape))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32


def test_fp16_compute_dtype():
    x, w = _rand((4, 8)), _rand((8, 16), 1)
    got = amp.autocast(lambda x, w: x @ w, compute_dtype=torch.float16)(
        _t(x), _t(w))
    want = jamp.autocast(lambda x, w: x @ w, compute_dtype=jnp.float16)(
        jnp.asarray(x), jnp.asarray(w))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2 ** -10,
                               atol=1e-6)


def test_autocast_disabled_is_identity():
    f = lambda x: x * 2
    assert amp.autocast(f, enabled=False) is f


def test_autocast_under_grad():
    """The gradient through an autocast region (the casts are autograd ops
    in both): dtype fp32, value vs JAX's jit(grad(autocast)) rtol 1e-5 and
    vs the fp32 gradient rtol 2e-2 (JAX's gate)."""
    x = np.ones((4, 8), np.float32)
    w = np.full((8, 8), 0.05, np.float32)
    jfn = jamp.autocast(lambda x, w: jnp.exp(x @ w).sum())
    want = jax.jit(jax.grad(jfn, argnums=1))(jnp.asarray(x), jnp.asarray(w))
    tw = _t(w).requires_grad_(True)
    amp.autocast(lambda x, w: torch.exp(x @ w).sum())(_t(x), tw).backward()
    assert tw.grad.dtype == torch.float32
    np.testing.assert_allclose(_np(tw.grad), np.asarray(want), rtol=1e-5)
    ref = jax.grad(lambda x, w: jnp.exp(x @ w).sum(), argnums=1)(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_np(tw.grad), np.asarray(ref), rtol=2e-2)


def _control_flow(m, where):
    w = (m.eye(8) * 1.01) if m is jnp else torch.eye(8) * 1.01

    def f_scan(x):  # JAX: lax.scan; the port: a Python loop
        if m is jnp:
            out, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                                  length=3)
            return out.sum()
        for _ in range(3):
            x = x @ w
        return x.sum()

    def f_cond(x):  # JAX: lax.cond; the port: torch.where
        if m is jnp:
            return jax.lax.cond(x.sum() > 0, lambda v: (v @ w).sum(),
                                lambda v: v.sum(), x)
        return where(x.sum() > 0, (x @ w).sum(), x.sum())

    def f_while(x):  # JAX: lax.while_loop; the port: a Python while
        if m is jnp:
            out, _ = jax.lax.while_loop(lambda c: c[1] < 3,
                                        lambda c: (c[0] @ w, c[1] + 1),
                                        (x, 0))
            return out.sum()
        i = 0
        while i < 3:
            x, i = x @ w, i + 1
        return x.sum()

    return f_scan, f_cond, f_while


@pytest.mark.parametrize("which", [0, 1, 2])
def test_autocast_loops_and_where(which):
    """JAX's scan / cond / while bodies under autocast vs the port's loops
    and torch.where: equal values within bf16 rounding (rtol 1e-2 on a sum
    of 32 bf16 products, JAX's gate 2e-2 against fp32)."""
    x = np.ones((4, 8), np.float32)
    jf = _control_flow(jnp, None)[which]
    tf = _control_flow(torch, torch.where)[which]
    want = float(jamp.autocast(jf)(jnp.asarray(x)))
    got = float(amp.autocast(tf)(_t(x)))
    ref = float(jf(jnp.asarray(x)))
    assert abs(got - want) / abs(want) < 1e-2
    assert abs(got - ref) / abs(ref) < 2e-2


def _registration(mod):
    captured = {}

    @mod.half_function
    def my_gemm(x):
        captured["dtype"] = str(x.dtype).split(".")[-1]
        return x

    @mod.float_function
    def my_loss(x):
        captured["loss_dtype"] = str(x.dtype).split(".")[-1]
        return x

    @mod.promote_function
    def my_add(a, b):
        captured["add"] = (str(a.dtype).split(".")[-1],
                           str(b.dtype).split(".")[-1])
        return a + b

    return captured, my_gemm, my_loss, my_add


def test_half_float_and_promote_function_registration():
    """The decorators: no cast outside autocast; inside, half_function
    casts to the compute dtype, float_function to fp32, promote_function to
    the widest: the same dtypes as JAX's."""
    seen = {}
    for name, mod, m, x in (("jax", jamp, jnp, jnp.ones((4,))),
                            ("torch", amp, torch, torch.ones(4))):
        captured, my_gemm, my_loss, my_add = _registration(mod)
        my_gemm(x)
        outside = captured["dtype"]

        def model(x):
            y = my_gemm(x)
            my_add(y, x)
            half = (y.astype(jnp.bfloat16) if m is jnp
                    else y.to(torch.bfloat16))
            return my_loss(half).sum()

        mod.autocast(model)(x)
        seen[name] = (outside, dict(captured))
    assert seen["jax"] == seen["torch"]
    assert seen["torch"][0] == "float32"
    assert seen["torch"][1]["dtype"] == "bfloat16"
    assert seen["torch"][1]["loss_dtype"] == "float32"
    assert seen["torch"][1]["add"] == ("float32", "float32")


# every entry of the port's lists (and the functions it leaves alone on
# purpose) -> (the port's call, JAX's jnp counterpart, inputs)
def _unary(tf, jf, lo=-2.0, hi=2.0):
    return (tf, jf, ((4, 8),), (lo, hi))


_X2 = ((4, 8), (8, 6))
_CASES = {
    "matmul": (torch.matmul, jnp.matmul, _X2, None),
    "__matmul__": (lambda a, b: a @ b, lambda a, b: a @ b, _X2, None),
    "__rmatmul__": (lambda a, b: torch.Tensor.__rmatmul__(b, a),
                    lambda a, b: a @ b, _X2, None),
    "mm": (torch.mm, jnp.matmul, _X2, None),
    "bmm": (torch.bmm, jnp.matmul, ((2, 4, 8), (2, 8, 6)), None),
    "mv": (torch.mv, jnp.matmul, ((4, 8), (8,)), None),
    "dot": (torch.dot, jnp.dot, ((8,), (8,)), None),
    "einsum": (lambda a, b: torch.einsum("ij,jk->ik", a, b),
               lambda a, b: jnp.einsum("ij,jk->ik", a, b), _X2, None),
    "tensordot": (lambda a, b: torch.tensordot(a, b, dims=1),
                  lambda a, b: jnp.tensordot(a, b, axes=1), _X2, None),
    "linear": (lambda x, w, b: F.linear(x, w, b),
               lambda x, w, b: x @ w.T + b, ((4, 8), (6, 8), (6,)), None),
    "addmm": (lambda c, a, b: torch.addmm(c, a, b),
              lambda c, a, b: c + a @ b, ((4, 6), (4, 8), (8, 6)), None),
    "baddbmm": (lambda c, a, b: torch.baddbmm(c, a, b),
                lambda c, a, b: c + a @ b,
                ((2, 4, 6), (2, 4, 8), (2, 8, 6)), None),
    "conv1d": (lambda x, k: F.conv1d(x, k),
               lambda x, k: jax.lax.conv_general_dilated(
                   x, k, (1,), "VALID",
                   dimension_numbers=("NCH", "OIH", "NCH")),
               ((1, 3, 10), (4, 3, 3)), None),
    "conv2d": (lambda x, k, b: F.conv2d(x, k, b),
               lambda x, k, b: jax.lax.conv_general_dilated(
                   x, k, (1, 1), "VALID",
                   dimension_numbers=("NCHW", "OIHW", "NCHW"))
               + b[None, :, None, None],
               ((1, 3, 6, 6), (4, 3, 3, 3), (4,)), None),
    "conv3d": (lambda x, k: F.conv3d(x, k),
               lambda x, k: jax.lax.conv_general_dilated(
                   x, k, (1, 1, 1), "VALID",
                   dimension_numbers=("NCDHW", "OIDHW", "NCDHW")),
               ((1, 2, 4, 4, 4), (3, 2, 2, 2, 2)), None),
    "exp": _unary(torch.exp, jnp.exp),
    "exp2": _unary(torch.exp2, jnp.exp2),
    "expm1": _unary(torch.expm1, jnp.expm1),
    "log": _unary(torch.log, jnp.log, 0.1, 3.0),
    "log1p": _unary(torch.log1p, jnp.log1p, 0.1, 3.0),
    "log2": _unary(torch.log2, jnp.log2, 0.1, 3.0),
    "log10": _unary(torch.log10, jnp.log10, 0.1, 3.0),
    "sigmoid": _unary(torch.sigmoid, jax.nn.sigmoid),
    "rsqrt": _unary(torch.rsqrt, jax.lax.rsqrt, 0.1, 3.0),
    "erf": _unary(torch.erf, jax.lax.erf),
    "erfc": _unary(torch.erfc, jax.lax.erfc),
    "erfinv": _unary(torch.erfinv, jax.lax.erf_inv, -0.9, 0.9),
    "acos": _unary(torch.acos, jnp.arccos, -0.9, 0.9),
    "acosh": _unary(torch.acosh, jnp.arccosh, 1.1, 3.0),
    "asin": _unary(torch.asin, jnp.arcsin, -0.9, 0.9),
    "asinh": _unary(torch.asinh, jnp.arcsinh),
    "atan": _unary(torch.atan, jnp.arctan),
    "atanh": _unary(torch.atanh, jnp.arctanh, -0.9, 0.9),
    "atan2": (torch.atan2, jnp.arctan2, ((4, 8), (4, 8)), None),
    "cosh": _unary(torch.cosh, jnp.cosh),
    "sinh": _unary(torch.sinh, jnp.sinh),
    "tan": _unary(torch.tan, jnp.tan, -1.0, 1.0),
    "digamma": _unary(torch.digamma, jax.scipy.special.digamma, 0.5, 3.0),
    "lgamma": _unary(torch.lgamma, jax.scipy.special.gammaln, 0.5, 3.0),
    "cumsum": _unary(lambda x: torch.cumsum(x, -1),
                     lambda x: jnp.cumsum(x, -1)),
    "cumprod": _unary(lambda x: torch.cumprod(x, -1),
                      lambda x: jnp.cumprod(x, -1), 0.5, 1.5),
    "logcumsumexp": _unary(lambda x: torch.logcumsumexp(x, -1),
                           lambda x: jax.lax.cumlogsumexp(x, axis=1)),
    "softmax": _unary(lambda x: torch.softmax(x, -1), jax.nn.softmax),
    "log_softmax": _unary(lambda x: F.log_softmax(x, -1),
                          jax.nn.log_softmax),
    "logsumexp": _unary(lambda x: torch.logsumexp(x, -1),
                        lambda x: jax.nn.logsumexp(x, -1)),
    "silu": _unary(F.silu, jax.nn.silu),
    "cross_entropy": _unary(
        lambda x: F.cross_entropy(x, torch.arange(4)),
        lambda x: -jnp.mean(jax.nn.log_softmax(x)[jnp.arange(4),
                                                  jnp.arange(4)])),
    "pow float exponent": _unary(lambda x: x ** 2.5, lambda x: x ** 2.5,
                                 0.1, 2.0),
    "pow int exponent": _unary(lambda x: x ** 2, lambda x: x ** 2),
    "__rpow__": _unary(lambda x: 2.0 ** x, lambda x: 2.0 ** x),
    "gelu exact": _unary(F.gelu, lambda x: jax.nn.gelu(x, False)),
    "gelu tanh": _unary(lambda x: F.gelu(x, approximate="tanh"),
                        lambda x: jax.nn.gelu(x, True)),
    "sum": _unary(torch.sum, jnp.sum),
    "mean": _unary(lambda x: torch.mean(x, -1), lambda x: jnp.mean(x, -1)),
    "var": _unary(lambda x: torch.var(x, -1, unbiased=False),
                  lambda x: jnp.var(x, -1)),
    "tanh": _unary(torch.tanh, jnp.tanh),
    "sqrt": _unary(torch.sqrt, jnp.sqrt, 0.1, 3.0),
    "relu": _unary(F.relu, jax.nn.relu),
    "softplus": _unary(F.softplus, jax.nn.softplus),
    "max": _unary(lambda x: torch.amax(x, -1), lambda x: jnp.max(x, -1)),
}


def test_every_list_entry_has_a_case():
    names = set(_CASES)
    assert lists.FP16_FUNCS <= names and lists.FP32_FUNCS <= names


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("in_dtype", ["bfloat16", "float32"])
def test_list_entry_matches_jax_autocast(name, in_dtype):
    """Each entry of the port's tables, on bf16 and fp32 inputs: its output
    dtype equals JAX's autocast of the jnp counterpart, and its value
    agrees — bf16 outputs within one bf16 rounding (rtol 2**-7; sums
    rounded once at the end: 2e-2), fp32 outputs of fp32 inputs rtol 2e-5
    (libm and sum order differ), fp32 outputs of bf16 inputs rtol and atol
    1e-2 (JAX keeps part of a composite in bf16: log10's constant,
    softmax's max shift, gelu's constants)."""
    tf, jf, shapes, dom = _CASES[name]
    arrays = [(_rand(s, i, *dom) if dom else _rand(s, i))
              for i, s in enumerate(shapes)]
    tdt, jdt = _DT[in_dtype]
    got = amp.autocast(tf)(*[_t(a).to(tdt) for a in arrays])
    want = jamp.autocast(jf)(*[jnp.asarray(a, jdt) for a in arrays])
    assert _same_dtype(got, want), (name, got.dtype, want.dtype)
    g, w = _np(got), _jnp(want)
    if got.dtype != torch.float32:
        rtol = 2e-2 if name in ("sum", "mean", "var", "cumsum",
                                "cross_entropy") else 2 ** -7
        np.testing.assert_allclose(g, w, rtol=rtol, atol=2e-2)
    elif in_dtype == "bfloat16":
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6)


def test_opaque_region_gets_its_untraced_dtype():
    """A custom-gradient region (the port's LayerNorm; JAX's custom-VJP
    Pallas LayerNorm in interpret mode) fed a bf16 product of fp32 inputs
    receives it back in fp32 (its un-autocast dtype) and returns fp32, on
    both sides; values within 1e-5 (the same bf16 product, then fp32)."""
    from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm

    x, w = _rand((32, 128)), _rand((128, 128), 1) * 0.1
    lw, lb = np.ones(128, np.float32), np.zeros(128, np.float32)
    seen = {}

    def port(x, w):
        y = layer_norm(x @ w, _t(lw), _t(lb))
        seen["in"] = (x @ w).dtype
        return y

    got = amp.autocast(port)(_t(x), _t(w))
    want = jamp.autocast(lambda x, w: jax_layer_norm(
        x @ w, jnp.asarray(lw), jnp.asarray(lb), use_pallas=True))(
            jnp.asarray(x), jnp.asarray(w))
    assert seen["in"] == torch.bfloat16
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _jnp(want), atol=1e-5, rtol=1e-5)


def test_opaque_region_runs_without_casts():
    """Inside an opaque region no op is rewritten (the mode is suspended)
    and the hook is gone once autocast exits."""
    seen = {}

    class Probe(ku.OpaqueFunction):
        @staticmethod
        def forward(ctx, a, b):
            out = a @ b
            seen["dtype"] = out.dtype
            return out

        @staticmethod
        def backward(ctx, g):
            return g, g

    amp.autocast(lambda a, b: Probe.apply(a, b))(torch.ones(2, 2),
                                                 torch.ones(2, 2))
    assert seen["dtype"] == torch.float32
    assert ku._OPAQUE_HOOK[0] is None


# ---------------------------------------------------------------------------
# the loss scaler (test_amp.py:134-195)


def _scaler_run(mod, flags, **kw):
    """(scale, unskipped, hysteresis_left, skipped) after each flag."""
    s = mod.LossScaler("dynamic", **kw)
    dev = {} if mod is jamp else {"device": "cpu"}
    st = s.init_state(**dev)
    out = []
    for f in flags:
        st, sk = s.update_scale(
            st, jnp.asarray(f) if mod is jamp else torch.tensor(f))
        out.append((float(st.loss_scale), int(st.unskipped),
                    int(st.hysteresis_left), bool(sk)))
    return out


@pytest.mark.parametrize("kw,flags", [
    (dict(init_scale=2.0 ** 8, scale_window=4), [0.0] * 4 + [1.0]),
    (dict(init_scale=2.0, min_loss_scale=1.0, max_loss_scale=4.0,
          scale_window=1), [1.0, 1.0] + [0.0] * 5),
    (dict(hysteresis=2, scale_window=3),
     [1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0]),
    (dict(backoff_factor=0.25, scale_window=2), [0.0, 0.0, 1.0, 0.0]),
])
def test_dynamic_scaler_matches_jax(kw, flags):
    """Growth and backoff, the bounds, Megatron's hysteresis and a
    separate backoff factor: every state after every flag equals JAX's."""
    assert _scaler_run(amp, flags, **kw) == _scaler_run(jamp, flags, **kw)


def test_dynamic_scaler_growth_and_backoff():
    states = _scaler_run(amp, [0.0] * 4 + [1.0], init_scale=2.0 ** 8,
                         scale_window=4)
    assert states[3][:2] == (2.0 ** 9, 0)
    assert states[4] == (2.0 ** 8, 0, 0, True)


def test_dynamic_scaler_bounds():
    states = _scaler_run(amp, [1.0, 1.0] + [0.0] * 5, init_scale=2.0,
                         min_loss_scale=1.0, max_loss_scale=4.0,
                         scale_window=1)
    assert states[0][0] == 1.0 and states[1][0] == 1.0
    assert states[-1][0] == 4.0


def test_static_scaler_never_updates():
    s = amp.LossScaler(128.0)
    st = s.init_state(device="cpu")
    st, skipped = s.update_scale(st, torch.tensor(1.0))
    assert float(st.loss_scale) == 128.0 and bool(skipped)


def test_unscale_detects_inf_and_nan():
    """found_inf is 1.0 for an inf or a NaN anywhere, 0.0 otherwise, as
    JAX's; the unscaled values equal JAX's (fp32 product by 1/scale)."""
    s, js = amp.LossScaler("dynamic"), jamp.LossScaler("dynamic")
    st, jst = s.init_state(device="cpu"), js.init_state()
    rng = np.random.default_rng(3)
    good = {"a": rng.standard_normal(4).astype(np.float32),
            "b": rng.standard_normal((2, 2)).astype(np.float32)}
    for poison in (np.inf, np.nan, None):
        tree = {k: v.copy() for k, v in good.items()}
        if poison is not None:
            tree["a"][1] = poison
        out, found = s.unscale({k: _t(v) for k, v in tree.items()}, st)
        jout, jfound = js.unscale(jax.tree.map(jnp.asarray, tree), jst)
        assert found.dtype == torch.float32
        assert float(found) == float(jfound) == (0.0 if poison is None
                                                 else 1.0)
        if poison is None:
            for k in tree:
                np.testing.assert_array_equal(_np(out[k]),
                                              np.asarray(jout[k]))


@pytest.mark.parametrize("out_dtype", ["float32", None])
def test_unscale_divides_by_scale(out_dtype):
    """bf16 grads of 32 at scale 16: fp32 2.0 (O2), or bf16 2.0 with
    ``out_dtype=None``, as JAX's."""
    s = amp.LossScaler(16.0)
    out, _ = s.unscale({"w": torch.full((3,), 32.0, dtype=torch.bfloat16)},
                       s.init_state(device="cpu"),
                       out_dtype=None if out_dtype is None
                       else torch.float32)
    js = jamp.LossScaler(16.0)
    jout, _ = js.unscale({"w": jnp.full((3,), 32.0, jnp.bfloat16)},
                         js.init_state(),
                         out_dtype=None if out_dtype is None
                         else jnp.float32)
    assert _same_dtype(out["w"], jout["w"])
    np.testing.assert_allclose(_np(out["w"]), 2.0)


def test_scale_loss_is_fp32():
    s = amp.LossScaler("dynamic")
    st = s.init_state(device="cpu")
    got = s.scale_loss(torch.tensor(1.0, dtype=torch.float16), st)
    assert got.dtype == torch.float32 and float(got) == 2.0 ** 16


def test_scaler_metrics_match_jax():
    """loss_scale, overflow and the cumulative overflow / skipped totals
    after three steps (flags 1, 0, 1) equal JAX's Metrics."""
    vals = {}
    for name, mod in (("jax", jamp), ("torch", amp)):
        s = mod.LossScaler("dynamic")
        st = s.init_state() if mod is jamp else s.init_state(device="cpu")
        m = None
        for f in (1.0, 0.0, 1.0):
            flag = jnp.asarray(f) if mod is jamp else torch.tensor(f)
            st, _ = s.update_scale(st, flag)
            m = mod.LossScaler.metrics(st, flag, m)
        vals[name] = {k: float(m[k]) for k in m.names()}
    assert vals["torch"] == vals["jax"]
    assert vals["torch"]["overflow_total"] == 2.0


def test_scaler_state_dict_refusal_and_clamping():
    """A corrupt scale is refused and a dynamic scaler clamps into its
    bounds, as JAX's; a static one keeps the stored value."""
    for mod in (amp, jamp):
        s = mod.LossScaler("dynamic", max_loss_scale=2.0 ** 10)
        for bad in (float("nan"), 0.0, -1.0, float("inf")):
            with pytest.raises(ValueError, match="corrupt"):
                s.load_state_dict({"loss_scale": bad, "unskipped": 0})
    d = {"loss_scale": 2.0 ** 20, "unskipped": 5}
    got = amp.LossScaler("dynamic", max_loss_scale=2.0 ** 10) \
        .load_state_dict(d, device="cpu")
    want = jamp.LossScaler("dynamic", max_loss_scale=2.0 ** 10) \
        .load_state_dict(d)
    assert float(got.loss_scale) == float(want.loss_scale) == 2.0 ** 10
    assert int(got.hysteresis_left) == int(want.hysteresis_left) == 1
    assert float(amp.LossScaler(2.0 ** 30).load_state_dict(
        d, device="cpu").loss_scale) == 2.0 ** 20


def test_found_inf_allreduce_needs_a_group():
    """JAX's mesh reduction (test_amp.py:301) takes the mesh's axis names
    since A7a (held across ranks in ``tests/test_torch_comm_dist.py``):
    with neither axis names nor a group the port refuses. The Megatron
    GradScaler's default over parallel_state's axes still refuses, naming
    A7c."""
    with pytest.raises(TypeError, match="axis_names"):
        amp.LossScaler.all_reduce_found_inf(torch.tensor(1.0))
    with pytest.raises(TypeError, match="exactly one"):
        amp.LossScaler.all_reduce_found_inf(torch.tensor(1.0), "dp",
                                            group=object())
    with pytest.raises(NotImplementedError, match="A7c"):
        GradScaler().sync_found_inf(torch.tensor(1.0))
    with pytest.raises(NotImplementedError, match="A7c"):
        GradScaler().update_scale(
            GradScaler().init_state(device="cpu"), torch.tensor(1.0),
            synced=False)


def test_grad_scaler_matches_jax():
    """The Megatron GradScaler's constructor and update (``synced=True``)
    over a flag sequence: every state equal to JAX's."""
    flags = [0.0, 1.0, 0.0, 0.0, 1.0, 1.0]
    kw = dict(init_scale=2.0 ** 10, growth_factor=4.0, backoff_factor=0.25,
              growth_interval=2, hysteresis=2)
    s, js = GradScaler(**kw), JGradScaler(**kw)
    st, jst = s.init_state(device="cpu"), js.init_state()
    for f in flags:
        st, sk = s.update_scale(st, torch.tensor(f))
        jst, jsk = js.update_scale(jst, jnp.asarray(f))
        assert (float(st.loss_scale), int(st.unskipped),
                int(st.hysteresis_left), bool(sk)) == (
            float(jst.loss_scale), int(jst.unskipped),
            int(jst.hysteresis_left), bool(jsk))


# ---------------------------------------------------------------------------
# presets, overrides and param casting (test_amp.py:197-236)


def _policy_fields(p):
    name = lambda d: None if d is None else str(jnp.dtype(d)) \
        if not isinstance(d, torch.dtype) else str(d).split(".")[-1]
    return (p.opt_level, name(p.cast_model_type), name(p.compute_dtype),
            p.keep_batchnorm_fp32, p.master_weights, p.loss_scale)


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "FP8"])
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_opt_level_presets_match_jax(level, half):
    tdt, jdt = _DT[half]
    got = amp.get_policy(level, tdt)
    want = jamp.get_policy(level, jdt)
    assert _policy_fields(got) == _policy_fields(want)
    cd = amp.policy_compute_dtype(got)
    jcd = jamp.policy_compute_dtype(want)
    assert (cd is None) == (jcd is None)
    if cd is not None:
        assert str(cd).split(".")[-1] == str(jcd)


def test_opt_level_presets():
    assert amp.get_policy("O0").master_weights is False
    assert amp.get_policy("O1").compute_dtype == torch.bfloat16
    o2 = amp.get_policy("O2")
    assert o2.cast_model_type == torch.bfloat16 and o2.master_weights
    o3 = amp.get_policy("O3")
    assert o3.keep_batchnorm_fp32 is False and o3.loss_scale == 1.0
    with pytest.raises(ValueError):
        amp.get_policy("O4")


def test_policy_overrides_and_refusals():
    p = amp.get_policy("O2", loss_scale=512.0, keep_batchnorm_fp32=False)
    assert p.loss_scale == 512.0 and p.keep_batchnorm_fp32 is False
    with pytest.raises(ValueError, match="mutually exclusive"):
        amp.get_policy("O2", compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="loss_scale"):
        PrecisionConfig(loss_scale="sometimes")


@pytest.mark.parametrize("path", [
    "Dense_0/kernel", "BatchNorm_0/scale", "layer_norm/scale", "ln_f/bias",
    "bn1/scale", "FusedLayerNorm_2/bias", "MixedFusedRMSNorm_0/scale",
    "layers/ln1_w", "layers/ln2_b", "head/ln_w", "head/ln_b", "embed/tok",
    "layers/qkv_kernel", "layers/fc1_bias", "encoder/final_ln_w",
    "lnorm_extra_long/x", "groupnorm/scale", "sync_bn/w"])
def test_default_norm_predicate_matches_jax(path):
    assert amp.default_norm_predicate(path) == \
        jamp.default_norm_predicate(path)


def test_o2_keeps_norm_params_fp32():
    params = {"Dense_0": {"kernel": torch.ones(8, 4)},
              "BatchNorm_0": {"scale": torch.ones(4), "bias": torch.zeros(4)},
              "layer_norm": {"scale": torch.ones(4)}}
    state, _ = amp.initialize(params, "O2")
    mp = amp.model_params(state)
    assert mp["Dense_0"]["kernel"].dtype == torch.bfloat16
    assert mp["BatchNorm_0"]["scale"].dtype == torch.float32
    assert mp["layer_norm"]["scale"].dtype == torch.float32
    assert state.master_params["Dense_0"]["kernel"].dtype == torch.float32
    # masters are copies: the user's params are untouched by updates
    assert state.master_params["Dense_0"]["kernel"] is not \
        params["Dense_0"]["kernel"]


def test_o3_casts_everything_and_cast_inputs():
    state, policy = amp.initialize({"BatchNorm_0": {"scale": torch.ones(4)}},
                                   "O3")
    assert amp.model_params(state)["BatchNorm_0"]["scale"].dtype == \
        torch.bfloat16
    args = amp.cast_inputs((torch.ones(2), torch.arange(3)), policy)
    assert args[0].dtype == torch.bfloat16 and args[1].dtype == torch.int64


def test_model_params_out_writes_in_place():
    """``model_params(state, out=model)`` writes the cast into the same
    leaf tensors (autograd leaves keep their identity)."""
    state, _ = amp.initialize({"w": torch.ones(4, 4),
                               "ln_w": torch.ones(4)}, "O2")
    model = amp.model_params(state)
    leaves = amp.trainable_leaves(model)
    ids = [id(x) for x in leaves]
    with torch.no_grad():
        state.master_params["w"].mul_(3.0)
    again = amp.model_params(state, out=model)
    assert again is model and [id(x) for x in tree_leaves(model)] == ids
    assert float(model["w"][0, 0]) == 3.0


# ---------------------------------------------------------------------------
# the O2 step and its skip (test_amp.py:237-340)


def _sgd(mod):
    if mod is jamp:
        return lambda g, p: jax.tree_util.tree_map(
            lambda pi, gi: pi - 0.1 * gi, p, g)
    return lambda g, p: {k: p[k] - 0.1 * g[k] for k in p}


def test_o2_step_and_overflow_skip_match_jax():
    """One clean O2 step (SGD update_fn) and one with inf grads: masters
    equal JAX's (rtol 1e-6), the skip leaves them bitwise, the scale
    halves."""
    w = np.ones((8, 4), np.float32)
    x = np.ones((2, 8), np.float32)
    jstate, _ = jamp.initialize({"w": jnp.asarray(w)}, "O2")
    jmp = jamp.model_params(jstate)
    jg = jax.grad(lambda p: jamp.scale_loss(
        ((jnp.asarray(x) @ p["w"].astype(jnp.float32)) ** 2).mean(),
        jstate))(jmp)
    jstate2, jsk = jamp.apply_grads(jstate, jg, _sgd(jamp))

    state, _ = amp.initialize({"w": _t(w)}, "O2")
    mp = amp.model_params(state)
    leaf = mp["w"].requires_grad_(True)
    loss = ((_t(x) @ leaf.float()) ** 2).mean()
    g, = torch.autograd.grad(amp.scale_loss(loss, state), [leaf])
    state2, sk = amp.apply_grads(state, {"w": g}, _sgd(amp))
    assert not bool(sk) and not bool(jsk)
    assert state2.master_params["w"].dtype == torch.float32
    assert float(state2.master_params["w"][0, 0]) < 1.0
    np.testing.assert_allclose(_np(state2.master_params["w"]),
                               np.asarray(jstate2.master_params["w"]),
                               rtol=1e-6)
    state3, sk3 = amp.apply_grads(
        state2, {"w": torch.full((8, 4), float("inf"))}, _sgd(amp))
    assert bool(sk3)
    assert torch.equal(state3.master_params["w"],
                       state2.master_params["w"])
    assert float(state3.scaler.loss_scale) == \
        float(state2.scaler.loss_scale) / 2


def test_checkpoint_roundtrip():
    state, _ = amp.initialize({"w": torch.ones(2)}, "O2")
    scaler = amp.LossScaler("dynamic")
    s = state.scaler
    for _ in range(3):
        s, _ = scaler.update_scale(s, torch.tensor(0.0))
    state = state._replace(scaler=s)
    d = amp.state_dict(state)
    assert d["loss_scaler0"]["unskipped"] == 3
    restored = amp.load_state_dict(state, d)
    assert int(restored.scaler.unskipped) == 3
    assert float(restored.scaler.loss_scale) == float(s.loss_scale)
    jstate, _ = jamp.initialize({"w": jnp.ones((2,))}, "O2")
    jr = jamp.load_state_dict(jstate, d)
    assert jamp.state_dict(jr) == amp.state_dict(restored)


def test_two_models_independent_scalers():
    pa, _ = amp.initialize({"w": torch.ones(2)}, "O2")
    pb, _ = amp.initialize({"w": torch.ones(2)}, "O2")
    keep = lambda g, p: p
    pa2, _ = amp.apply_grads(pa, {"w": torch.full((2,), float("inf"))}, keep)
    pb2, _ = amp.apply_grads(pb, {"w": torch.ones(2)}, keep)
    assert float(pa2.scaler.loss_scale) == 2.0 ** 15
    assert float(pb2.scaler.loss_scale) == 2.0 ** 16


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_apply_grads_with_optimizer_guards_opt_state(opt):
    """A clean step then a NaN step through ``apply_grads_with_optimizer``:
    after the clean step masters, moments and count equal JAX's (rtol
    1e-6); the NaN step keeps masters, moments and count bitwise, as JAX's
    guard."""
    ctor = {"adam": (lambda ps: FusedAdam(ps, lr=1e-2),
                     JFusedAdam(lr=1e-2, fused_tail="off")),
            "lamb": (lambda ps: FusedLAMB(ps, lr=1e-2),
                     JFusedLAMB(lr=1e-2))}[opt]
    jstate, _ = jamp.initialize({"w": jnp.ones((4,))}, "O2")
    tx = ctor[1]
    jopt = tx.init(jstate.master_params)
    jstate2, jopt2, jsk = jamp.apply_grads_with_optimizer(
        jstate, {"w": jnp.ones((4,))}, tx, jopt)
    state, _ = amp.initialize({"w": torch.ones(4)}, "O2")
    optimizer = ctor[0](tree_leaves(state.master_params))
    state2, optimizer, sk = amp.apply_grads_with_optimizer(
        state, {"w": torch.ones(4)}, optimizer)
    assert not bool(sk) and int(optimizer.param_groups[0]["step"]) == 1
    w = state2.master_params["w"]
    np.testing.assert_allclose(_np(w), np.asarray(jstate2.master_params["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(optimizer.state[w]["exp_avg"]),
                               np.asarray(jopt2.mu["w"]), rtol=1e-6)
    before = (w.clone(), optimizer.state[w]["exp_avg"].clone(),
              optimizer.state[w]["exp_avg_sq"].clone())
    state3, optimizer, sk3 = amp.apply_grads_with_optimizer(
        state2, {"w": torch.full((4,), float("nan"))}, optimizer)
    assert bool(sk3) and int(optimizer.param_groups[0]["step"]) == 1
    after = (w, optimizer.state[w]["exp_avg"], optimizer.state[w]["exp_avg_sq"])
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert float(state3.scaler.loss_scale) == 2.0 ** 15


# ---------------------------------------------------------------------------
# GPT under amp, small size, against JAX


def _jax_cfg(dtype):
    return JGPTConfig(vocab_size=96, max_seq=16, hidden=64, num_layers=2,
                      num_heads=4, dtype=dtype)


def _port_cfg(dtype):
    return GPTConfig(vocab_size=96, max_seq=16, hidden=64, num_layers=2,
                     num_heads=4, dtype=dtype)


def _tokens():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 96, (2, 16)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _jax_loss_fn(jcfg, tok, tgt):
    mesh = build_mesh(tp=1, pp=1, sp=1)
    specs = gpt_param_specs(jcfg)

    def loss_fn(p):
        return jax.shard_map(
            lambda p, a, b: jax_gpt_loss(p, a, b, jcfg), mesh=mesh,
            in_specs=(specs, P(), P()), out_specs=P())(p, tok, tgt)

    return loss_fn


_OVERFLOW_SCALE = 2.0 ** 127   # a loss of ~4.6 times this is inf in fp32


def _with_scale(mod, state, scale):
    if mod is jamp:
        return state._replace(scaler=state.scaler._replace(
            loss_scale=jnp.asarray(scale, jnp.float32)))
    return state._replace(scaler=state.scaler._replace(
        loss_scale=torch.full((), scale, dtype=torch.float32)))


def _o2_runs(half, opt):
    """Three O2 steps of the small GPT, JAX and port, from the same
    params: step 1 at the initial scale, step 2 at 2**127 (the scaled loss
    overflows fp32: skipped), step 3 after the checkpointed scaler state
    of 2**16 is restored (trains)."""
    jdt, tdt = _DT[half][1], _DT[half][0]
    # the config's dtype is the init's alone (the model's comes from
    # amp's cast); the port's GPTConfig takes fp32 or bf16
    jcfg = _jax_cfg(jdt)
    tcfg = _port_cfg(torch.float32 if half == "float16" else tdt)
    p0 = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    tok, tgt = _tokens()
    jtx = {"adam": JFusedAdam(lr=1e-3, fused_tail="off"),
           "lamb": JFusedLAMB(lr=1e-3)}[opt]
    jstate, _ = jamp.initialize(jax.tree.map(jnp.asarray, p0), "O2",
                                half_dtype=jdt)
    jopt = jtx.init(jstate.master_params)
    loss_fn = _jax_loss_fn(jcfg, tok, tgt)

    @jax.jit
    def jstep(st, os_):
        loss, g = jax.value_and_grad(
            lambda p: jamp.scale_loss(loss_fn(p), st))(jamp.model_params(st))
        st2, os2, sk = jamp.apply_grads_with_optimizer(st, g, jtx, os_)
        return st2, os2, sk, loss

    params = params_from_numpy(p0, "cpu")
    state, _ = amp.initialize(params, "O2", half_dtype=tdt)
    model = amp.model_params(state)
    leaves = amp.trainable_leaves(model)
    ctor = {"adam": lambda ps: FusedAdam(ps, lr=1e-3),
            "lamb": lambda ps: FusedLAMB(ps, lr=1e-3)}[opt]
    optimizer = ctor(tree_leaves(state.master_params))
    ttok, ttgt = _t(tok).long(), _t(tgt).long()
    restore = {"loss_scaler0": {"loss_scale": 2.0 ** 16, "unskipped": 0,
                                "hysteresis_left": 1}}
    runs = []
    for i in range(3):
        if i == 1:
            jstate = _with_scale(jamp, jstate, _OVERFLOW_SCALE)
            state = _with_scale(amp, state, _OVERFLOW_SCALE)
        if i == 2:
            jstate = jamp.load_state_dict(jstate, restore)
            state = amp.load_state_dict(state, restore)
        jstate, jopt, jsk, jl = jstep(jstate, jopt)
        amp.model_params(state, out=model)
        loss = gpt_loss(model, ttok, ttgt, tcfg)
        scaled = amp.scale_loss(loss, state)
        grads = torch.autograd.grad(scaled, leaves)
        state, optimizer, sk = amp.apply_grads_with_optimizer(
            state, grads, optimizer)
        runs.append(dict(
            jloss=float(jl), loss=float(scaled), jsk=bool(jsk),
            sk=bool(sk), jscaler=jamp.state_dict(jstate),
            scaler=amp.state_dict(state), jcount=int(jopt.count),
            count=int(optimizer.param_groups[0]["step"]),
            jmasters=dict(named_leaves(jax.tree.map(
                np.asarray, jstate.master_params))),
            masters={k: _np(v) for k, v in named_leaves(
                state.master_params)},
            jmu=dict(named_leaves(jax.tree.map(np.asarray, jopt.mu))),
            mu={k: _np(optimizer.state[v]["exp_avg"])
                for k, v in named_leaves(state.master_params)}))
    return runs


@pytest.mark.parametrize("half,opt", [("float32", "adam"),
                                      ("float32", "lamb"),
                                      ("bfloat16", "adam"),
                                      ("bfloat16", "lamb"),
                                      ("float16", "adam")])
def test_gpt_o2_steps_with_an_overflow_match_jax(half, opt):
    """GPT (2 layers, hidden 64, 4 heads, seq 16) under O2 with FusedAdam
    or FusedLAMB over the fp32 masters, JAX's ``initialize`` +
    ``apply_grads_with_optimizer`` beside the port's, 3 steps, the second
    overflowing: the skips, the scaler state and the count equal JAX's at
    every step; the skipped step keeps the masters bitwise. An fp32 model
    (``half_dtype`` fp32): losses rel 1e-5, masters rel 1e-5 + atol lr/100
    (Adam's step is lr·m/sqrt(v) for every element: where a gradient is
    tiny its fp32 summation order moves the step by a fraction of lr),
    first moments rel 1e-4. A bf16 / fp16 model, JAX's gates: loss rel
    1e-2, masters atol 4·lr (two applied steps of ±lr each, where a tiny
    half-precision gradient can change sign), each first moment within
    5e-2 of its norm (a half-precision gradient differs by a rounding)."""
    runs = _o2_runs(half, opt)
    assert [r["sk"] for r in runs] == [r["jsk"] for r in runs] == \
        [False, True, False]
    for r in runs:
        assert r["scaler"] == r["jscaler"] and r["count"] == r["jcount"]
    assert runs[1]["scaler"]["loss_scaler0"]["loss_scale"] == 2.0 ** 126
    assert [r["count"] for r in runs] == [1, 1, 2]
    for k in runs[0]["masters"]:
        np.testing.assert_array_equal(runs[1]["masters"][k],
                                      runs[0]["masters"][k])
    tight = half == "float32"
    for i in (0, 2):
        r = runs[i]
        if i == 0 or tight:
            np.testing.assert_allclose(r["loss"], r["jloss"],
                                       rtol=1e-5 if tight else 1e-2)
        for k in r["masters"]:
            if tight:
                np.testing.assert_allclose(r["masters"][k], r["jmasters"][k],
                                           rtol=1e-5, atol=1e-5, err_msg=k)
                np.testing.assert_allclose(r["mu"][k], r["jmu"][k],
                                           rtol=1e-4, atol=1e-7, err_msg=k)
            else:
                np.testing.assert_allclose(r["masters"][k], r["jmasters"][k],
                                           atol=4e-3, err_msg=k)
                rel = np.linalg.norm(r["mu"][k] - r["jmu"][k]) / max(
                    np.linalg.norm(r["jmu"][k]), 1e-30)
                assert rel < 5e-2, (k, rel)


def test_gpt_o2_model_params_keep_ln_fp32():
    """GPT's LN params match the norm predicate (``ln1_w``, ``ln2_b``,
    ``head/ln_w``): fp32 under O2, every other leaf bf16, as JAX."""
    jcfg = _jax_cfg(jnp.bfloat16)
    p0 = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    jstate, _ = jamp.initialize(jax.tree.map(jnp.asarray, p0), "O2")
    want = {k: str(v.dtype) for k, v in named_leaves(jax.tree.map(
        np.asarray, jamp.model_params(jstate)))}
    state, _ = amp.initialize(params_from_numpy(p0, "cpu"), "O2")
    got = {k: str(v.dtype).split(".")[-1]
           for k, v in named_leaves(amp.model_params(state))}
    assert got == want
    assert got["layers.ln1_w"] == got["head.ln_w"] == "float32"
    assert got["layers.qkv_kernel"] == "bfloat16"


def test_amp_state_from_numpy_carries_jax_state():
    """A JAX AmpState after one clean step, carried over: masters, scaler
    state and policy equal."""
    jstate, _ = jamp.initialize({"w": jnp.ones((4,)), "ln_w": jnp.ones(4)},
                                "O2")
    jstate, _ = jamp.apply_grads(jstate, {"w": jnp.ones((4,)),
                                          "ln_w": jnp.ones(4)},
                                 lambda g, p: p)
    state = amp_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert amp.state_dict(state) == jamp.state_dict(jstate)
    assert state.policy == amp.get_policy("O2")
    assert amp.model_params(state)["ln_w"].dtype == torch.float32


@pytest.fixture
def jax_flash_on_kernel(monkeypatch):
    """JAX's GPT takes its XLA attention reference off the TPU by default;
    force its flash onto the Pallas kernels in interpret mode (a custom
    VJP, opaque to its autocast, as the port's flash is)."""
    import apex_tpu.ops.attention as jattn

    orig = jattn._pallas_ok
    monkeypatch.setattr(jattn, "_pallas_ok",
                        lambda sq, sk, d, causal, allow_interpret:
                        orig(sq, sk, d, causal, True))


@pytest.mark.parametrize("remat", [True, False])
def test_gpt_o1_autocast_matches_jax(jax_flash_on_kernel, remat):
    """GPT (fp32 params) under O1 autocast (bf16 products), JAX's flash on
    its interpret-mode kernels, the port's on its plain version (both
    opaque, both fed fp32 q/k/v: the bias add promotes the bf16 product):
    the loss within 1e-3 relative and every gradient within 2e-2 of its
    norm (the same bf16 products summed in other orders); with remat the
    recompute runs under the forward's casts (no checkpoint metadata
    error)."""
    jcfg = dataclasses.replace(_jax_cfg(jnp.float32), remat=remat)
    tcfg = dataclasses.replace(_port_cfg(torch.float32), remat=remat)
    p0 = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    tok, tgt = _tokens()
    loss_fn = _jax_loss_fn(jcfg, tok, tgt)
    jl, jg = jax.value_and_grad(jamp.autocast(loss_fn))(
        jax.tree.map(jnp.asarray, p0))
    params = params_from_numpy(p0, "cpu")
    amp.trainable_leaves(params)
    loss = amp.autocast(lambda: gpt_loss(params, _t(tok).long(),
                                         _t(tgt).long(), tcfg))()
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    want = dict(named_leaves(jax.tree.map(np.asarray, jg)))
    for (name, p) in named_leaves(params):
        g = _np(p.grad)
        rel = np.linalg.norm(g - want[name]) / max(
            np.linalg.norm(want[name]), 1e-30)
        assert rel < 2e-2, (name, rel)


def test_gpt_o1_flash_gets_fp32_inputs():
    """Under O1 with fp32 params the flash region receives fp32 q/k/v (the
    dtype JAX traces it at) and the products run bf16."""
    from apex_tpu_torch.ops import attention as port_attention

    seen = {"flash": set(), "mm": set()}
    orig = port_attention.flash_attention_fwd_reference

    def spy(q, k, v, *a, **kw):
        seen["flash"].add(q.dtype)
        return orig(q, k, v, *a, **kw)

    cfg = _port_cfg(torch.float32)
    p0 = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                           _jax_cfg(jnp.float32)))
    params = params_from_numpy(p0, "cpu")
    tok, tgt = _tokens()
    mp = pytest.MonkeyPatch()
    mp.setattr(port_attention, "flash_attention_fwd_reference", spy)
    try:
        amp.autocast(lambda: gpt_loss(params, _t(tok).long(),
                                      _t(tgt).long(), cfg))()
    finally:
        mp.undo()
    assert seen["flash"] == {torch.float32}


def test_jax_kernels_take_fp16_in_interpret_mode():
    """JAX's Pallas wrappers have no dtype gate: LayerNorm, RMSNorm, flash,
    the LM-head loss and the Adam tail compute fp16 inputs in interpret
    mode (finite outputs, fp16 where JAX returns x's type). The port's
    kernels take fp16 on the card as well
    (``test_torch_kernels_cuda.py::test_kernels_take_fp16``); its plain
    versions take fp16 on every device (the fp16 O2 GPT case above)."""
    from apex_tpu.ops.attention import flash_attention as jflash
    from apex_tpu.ops.fused_update import fused_adam_tail as jtail
    from apex_tpu.ops.layer_norm import layer_norm as jln
    from apex_tpu.ops.layer_norm import rms_norm as jrms
    from apex_tpu.ops.lm_head_loss import lm_head_loss as jlm

    r = np.random.default_rng(0)
    h = jnp.float16
    x = jnp.asarray(r.standard_normal((32, 128)), h)
    w, b = jnp.ones(128, h), jnp.zeros(128, h)
    qkv = [jnp.asarray(r.standard_normal((1, 2, 128, 64)), h)
           for _ in range(3)]
    outs = {
        "layer_norm": jln(x, w, b, use_pallas=True),
        "rms_norm": jrms(x, w, use_pallas=True),
        "flash": jflash(*qkv, causal=True, use_pallas=True, interpret=True),
        "lm_head": jlm(jnp.asarray(r.standard_normal((128, 128)), h),
                       jnp.asarray(r.standard_normal((256, 128)), h),
                       jnp.asarray(r.integers(0, 256, 128), jnp.int32),
                       use_pallas=True),
        "adam_tail": jtail(jnp.asarray(r.standard_normal(1024), h),
                           jnp.zeros(1024), jnp.zeros(1024),
                           jnp.asarray(r.standard_normal(1024), h), 0.1,
                           0.001, betas=(0.9, 0.999), eps=1e-8,
                           use_pallas=True),
    }
    for name, out in outs.items():
        for leaf in jax.tree.leaves(out):
            assert bool(jnp.isfinite(leaf.astype(jnp.float32)).all()), name
    for name in ("layer_norm", "rms_norm", "flash"):
        assert outs[name].dtype == jnp.float16, name
