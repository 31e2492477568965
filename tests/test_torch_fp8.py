"""apex_tpu_torch.amp.fp8 on the CPU, against apex_tpu.amp.fp8 (the cases of
``tests/test_sub8.py``'s fp8 section): the e4m3 / e5m2 codes bitwise,
``fp8_dot`` within its cast tolerance, the delayed-scaling state after each
training step, the state dict round trip and refusals, the metrics, and
the product routes. JAX runs as its own tests run it on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu.amp import fp8 as jfp8

from apex_tpu_torch import amp
from apex_tpu_torch.amp import fp8
from apex_tpu_torch.convert import fp8_state_from_numpy
from apex_tpu_torch.monitor.metrics import Metrics

REC = fp8.Fp8Recipe(history_len=4)
JREC = jfp8.Fp8Recipe(history_len=4)
_DT = {"e4m3": (fp8.E4M3, jfp8.E4M3), "e5m2": (fp8.E5M2, jfp8.E5M2)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes_t(q):
    return q.view(torch.uint8).numpy()


def _codes_j(q):
    return np.asarray(q).view(np.uint8)


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
@pytest.mark.parametrize("scale", [1.0, 0.37, 123.5, 2.0 ** -10])
def test_cast_codes_bitwise_jax(kind, scale):
    """``cast_fp8`` of the same fp32 data at the same scale: the fp8 codes
    equal JAX's bit for bit (scale, clip at the fp8 max, round to nearest
    even), saturated values and subnormals included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4000) * 10.0 ** rng.integers(
        -6, 6, 4000), [0.0, -0.0, 1e30, -1e30, 448.0, 57344.0]]).astype(
            np.float32)
    tdt, jdt = _DT[kind]
    got = fp8.cast_fp8(_t(x), torch.tensor(scale), tdt)
    want = jfp8.cast_fp8(jnp.asarray(x), jnp.float32(scale), jdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_codes_t(got), _codes_j(want))


def test_fp8_max_and_recipe_and_policy_surface():
    with pytest.raises(ValueError):
        fp8.Fp8Recipe(history_len=0)
    with pytest.raises(ValueError):
        fp8.Fp8Recipe(margin=-1.0)
    assert fp8.fp8_max(fp8.E4M3) == jfp8.fp8_max(jfp8.E4M3) == 448.0
    assert fp8.fp8_max(fp8.E5M2) == jfp8.fp8_max(jfp8.E5M2) == 57344.0
    pol = amp.get_policy("FP8")
    assert pol.opt_level == "FP8" and pol.master_weights
    assert amp.policy_compute_dtype(pol) == torch.float8_e4m3fn
    assert fp8.fp8_policy() == pol
    assert str(jamp.policy_compute_dtype(jamp.get_policy("FP8"))) == \
        "float8_e4m3fn"


def test_observe_and_update_match_jax():
    """amax, saturated fraction and the delayed-scaling state over a run
    of 8 casts whose range moves (history 4, margin 1): bitwise JAX's."""
    rec = fp8.Fp8Recipe(history_len=4, margin=1.0)
    jrec = jfp8.Fp8Recipe(history_len=4, margin=1.0)
    st = fp8.init_tensor_state(rec, device="cpu")
    jst = jfp8.init_tensor_state(jrec)
    rng = np.random.default_rng(2)
    for i in range(8):
        x = (rng.standard_normal(256) * 10.0 ** (i % 4 - 1)).astype(
            np.float32)
        amax, over = fp8._observe(_t(x), st.scale, fp8.E4M3)
        jamax, jover = jfp8._observe(jnp.asarray(x), jst.scale, jfp8.E4M3)
        assert float(amax) == float(jamax)
        np.testing.assert_allclose(float(over), float(jover), rtol=1e-7)
        st = fp8.update_tensor_state(st, amax, over, fp8.E4M3, rec)
        jst = jfp8.update_tensor_state(jst, jamax, jover, jfp8.E4M3, jrec)
        assert float(st.scale) == float(jst.scale), i
        np.testing.assert_array_equal(st.amax_history.numpy(),
                                      np.asarray(jst.amax_history))


def test_fp8_delayed_scale_reacts_within_history_window():
    """A 100x larger tensor drops the scale by 100x and the overflow rate
    spikes (the stale scale saturates every element), as JAX's."""
    st = fp8.init_tensor_state(REC, device="cpu")
    x = torch.full((64,), 1.0)
    for _ in range(4):
        amax, over = fp8._observe(x, st.scale, fp8.E4M3)
        st = fp8.update_tensor_state(st, amax, over, fp8.E4M3, REC)
    s_small = float(st.scale)
    amax, over = fp8._observe(x * 100.0, st.scale, fp8.E4M3)
    assert float(over) > 0.99
    st = fp8.update_tensor_state(st, amax, over, fp8.E4M3, REC)
    assert float(st.scale) == pytest.approx(s_small / 100.0, rel=1e-5)
    assert float(st.overflow_rate) > 0.99


def _fixture_np():
    k = jax.random.PRNGKey(0)
    params = {"w1": jax.random.normal(k, (16, 32)) * 0.1,
              "w2": jax.random.normal(jax.random.fold_in(k, 1), (32, 8)) * 0.1}
    x = jax.random.normal(jax.random.fold_in(k, 2), (4, 16))
    return jax.tree.map(np.asarray, params), np.asarray(x)


def _jax_step(x):
    def loss_fn(params, st):
        h, st1 = jfp8.fp8_dot(x, params["w1"], st["l1"], JREC)
        h = jax.nn.relu(h)
        y, st2 = jfp8.fp8_dot(h, params["w2"], st["l2"], JREC)
        return jnp.mean(y ** 2), {"l1": st1, "l2": st2}

    @jax.jit
    def step(params, st):
        (loss, fwd), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(params, st)
        st = jfp8.merge_state_grads(fwd, grads[1])
        params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params,
                                        grads[0])
        return params, st, loss

    return step


def _port_step(x):
    def step(params, st):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        h, st1 = fp8.fp8_dot(x, leaves["w1"], st["l1"], REC)
        h = torch.relu(h)
        y, st2 = fp8.fp8_dot(h, leaves["w2"], st["l2"], REC)
        loss = torch.mean(y ** 2)
        loss.backward()
        st = fp8.merge_state_grads({"l1": st1, "l2": st2})
        with torch.no_grad():
            params = {k: v - 0.1 * v.grad for k, v in leaves.items()}
        return params, st, loss.detach()

    return step


def _states_close(st, jst, rtol):
    for site in ("l1", "l2"):
        for half in ("x", "w", "g"):
            a, b = getattr(st[site], half), getattr(jst[site], half)
            for name, u, v in zip(a._fields, a, b):
                np.testing.assert_allclose(u.numpy(), np.asarray(v),
                                           rtol=rtol, atol=1e-12,
                                           err_msg=f"{site}.{half}.{name}")


def test_fp8_training_matches_jax():
    """Six steps of the two-product MLP (JAX's test fixture), JAX's
    value_and_grad over (params, state) + merge beside the port's backward
    + merge: losses within rtol 1e-5 and every state tensor (both forward
    halves and the gradient half) within rtol 1e-5 after every step (the
    codes are equal; the fp32 sums of the products run in other orders),
    the loss falls and every scale moves off its init."""
    params_np, x_np = _fixture_np()
    jstep, tstep = _jax_step(jnp.asarray(x_np)), _port_step(_t(x_np))
    jp = jax.tree.map(jnp.asarray, params_np)
    jst = jfp8.init_fp8_state(["l1", "l2"], JREC)
    tp = {k: _t(v) for k, v in params_np.items()}
    tst = fp8.init_fp8_state(["l1", "l2"], REC, device="cpu")
    losses = []
    for _ in range(6):
        jp, jst, jl = jstep(jp, jst)
        tp, tst, tl = tstep(tp, tst)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _states_close(tst, jst, 1e-5)
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    for site in ("l1", "l2"):
        for half in ("x", "w", "g"):
            assert float(getattr(tst[site], half).scale) != 1.0
        assert float(torch.max(tst[site].g.amax_history)) > 0


def test_fp8_dot_matches_fp32_within_cast_tolerance():
    """With calibrated scales (4 steps), e4m3 x e4m3 tracks the fp32
    product within e4m3's relative error (JAX's bound 0.06), and equals
    JAX's fp8_dot output (rtol 1e-5: the same codes)."""
    params_np, x_np = _fixture_np()
    tstep = _port_step(_t(x_np))
    tp = {k: _t(v) for k, v in params_np.items()}
    st = fp8.init_fp8_state(["l1", "l2"], REC, device="cpu")
    for _ in range(4):
        tp, st, _ = tstep(tp, st)
    y8, _ = fp8.fp8_dot(_t(x_np), tp["w1"], st["l1"], REC)
    yf = _t(x_np) @ tp["w1"]
    rel = float((y8 - yf).abs().max() / yf.abs().max())
    assert 0 < rel < 0.06, rel
    jst = jax.tree.map(lambda a: jnp.asarray(a.numpy()), st["l1"])
    jy, _ = jfp8.fp8_dot(jnp.asarray(x_np), jnp.asarray(tp["w1"].numpy()),
                         jst, JREC)
    np.testing.assert_allclose(y8.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


def test_fp8_state_dict_roundtrip_midrun_exact():
    """The state survives a state_dict round trip mid-run: the continued
    runs are bitwise equal."""
    params_np, x_np = _fixture_np()
    step = _port_step(_t(x_np))
    tp = {k: _t(v) for k, v in params_np.items()}
    st = fp8.init_fp8_state(["l1", "l2"], REC, device="cpu")
    for _ in range(3):
        tp, st, _ = step(tp, st)
    d = fp8.state_dict(st)
    zero = fp8.init_fp8_state(["l1", "l2"], REC, device="cpu")
    st2 = fp8.load_state_dict(zero, d)
    pa, sa, la = step(tp, st)
    pb, sb, lb = step(tp, st2)
    assert float(la) == float(lb)
    for k in pa:
        assert torch.equal(pa[k], pb[k])
    for a, b in zip(fp8._flatten(sa)[0], fp8._flatten(sb)[0]):
        assert torch.equal(a, b)


def test_fp8_state_dict_rejects_mismatch():
    st = fp8.init_fp8_state(["a"], REC, device="cpu")
    d = fp8.state_dict(st)
    with pytest.raises(ValueError):
        fp8.load_state_dict(fp8.init_fp8_state(["b"], REC, device="cpu"), d)
    with pytest.raises(ValueError):
        fp8.load_state_dict(fp8.init_fp8_state(
            ["a"], fp8.Fp8Recipe(history_len=8), device="cpu"), d)


def test_fp8_metrics_match_jax():
    """``fp8_metrics`` gives JAX's names and values, and every value is a
    Metrics scalar."""
    st = fp8.init_fp8_state(["l1", "l2"], REC, device="cpu")
    jst = jfp8.init_fp8_state(["l1", "l2"], JREC)
    m, jm = fp8.fp8_metrics(st), jfp8.fp8_metrics(jst)
    assert sorted(m) == sorted(jm)
    assert {k: float(v) for k, v in m.items()} == \
        {k: float(v) for k, v in jm.items()}
    metrics = Metrics().record(**m)
    assert float(metrics["fp8_overflow_rate"]) == 0.0
    assert "fp8_l1_x_scale" in m and "fp8_l2_g_amax" in m


def test_fp8_state_from_numpy_continues_jax():
    """JAX's state and params after 3 steps carried over
    (``fp8_state_from_numpy``): one more port step matches JAX's 4th (loss
    rtol 1e-5, state rtol 1e-5)."""
    params_np, x_np = _fixture_np()
    jstep, tstep = _jax_step(jnp.asarray(x_np)), _port_step(_t(x_np))
    jp = jax.tree.map(jnp.asarray, params_np)
    jst = jfp8.init_fp8_state(["l1", "l2"], JREC)
    for _ in range(3):
        jp, jst, _ = jstep(jp, jst)
    tst = fp8_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    jp, jst, jl = jstep(jp, jst)
    tp, tst, tl = tstep(tp, tst)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _states_close(tst, jst, 1e-5)


def test_merge_takes_jax_style_state_grads():
    """``merge_state_grads(fwd, grads)``: the g halves from the given tree,
    the x / w halves from the forward, as JAX's merge."""
    a = fp8.init_fp8_state(["l1"], REC, device="cpu")
    b = fp8.init_fp8_state(["l1"], REC, device="cpu")
    b["l1"].g.scale.fill_(3.0)
    a["l1"].x.scale.fill_(2.0)
    out = fp8.merge_state_grads(a, b)
    assert float(out["l1"].g.scale) == 3.0
    assert float(out["l1"].x.scale) == 2.0


def test_product_routes_on_the_cpu():
    """On the CPU the route is the fp32 product of the upcast operands
    (every fp8 product exact in fp32; equal to the fp64 product within the
    fp32 sum's rounding, rtol 1e-6); ``scaled_mm`` is refused for CPU
    operands, and any other route name raises."""
    rng = np.random.default_rng(7)
    a = fp8.cast_fp8(_t(rng.standard_normal((32, 64)).astype(np.float32)),
                     torch.tensor(1.0), fp8.E4M3)
    b = fp8.cast_fp8(_t(rng.standard_normal((64, 16)).astype(np.float32)),
                     torch.tensor(1.0), fp8.E5M2)
    assert fp8.fp8_route(a, b) == "upcast"
    got = fp8.fp8_matmul(a, b)
    want = a.double() @ b.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="scaled_mm"):
        fp8.fp8_matmul(a, b, route="scaled_mm")
    with pytest.raises(ValueError, match="route"):
        fp8.fp8_matmul(a, b, route="other")
