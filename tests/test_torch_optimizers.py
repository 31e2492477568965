"""apex_tpu_torch's optimizer suite on the CPU, against apex_tpu.optimizers.

Each port optimizer runs 5 steps from the same numpy params and gradients
as JAX's transform (``tx.update`` + ``apply_updates``), with JAX's
parameter grids (``tests/test_optimizers.py``), on fp32 and bf16 params;
then LARC, ``global_norm``, grad accumulation, ``MultiTensorApply``, the
overflow guard, the state carry-over and the Adam tail's device
arguments. Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import optimizers as jopt
from apex_tpu.multi_tensor_apply import MultiTensorApply as JMultiTensorApply
from apex_tpu.optimizers import apply_updates as japply

from apex_tpu_torch import optimizers as opt
from apex_tpu_torch.convert import (named_leaves,
                                    optimizer_state_from_numpy,
                                    params_from_numpy)
from apex_tpu_torch.multi_tensor_apply import (MultiTensorApply,
                                               multi_tensor_applier)
from apex_tpu_torch.ops.fused_update import (adam_tail_reference,
                                             fused_adam_tail,
                                             fused_lamb_tail,
                                             lamb_tail_reference)
from apex_tpu_torch.optimizers._common import tree_leaves


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy().copy()


def _tree(seed=0, shapes=((7, 3), (11,), (2, 5, 3))):
    rng = np.random.RandomState(seed)
    return {f"p{i}": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _grad_seq(n=5, seed=1):
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(*v.shape).astype(np.float32)
             for k, v in _tree().items()} for _ in range(n)]


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _run_jax(tx, dtype, grads_seq):
    params = {k: jnp.asarray(v, _JDT[dtype]) for k, v in _tree().items()}
    state = tx.init(params)

    @jax.jit
    def step(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return japply(params, updates), state

    for g in grads_seq:
        params, state = step(params, state, {
            k: jnp.asarray(v, _JDT[dtype]) for k, v in g.items()})
    return jax.tree.map(np.asarray, params), state


def _port_params(dtype):
    return {k: _t(v).to(_TDT[dtype]) for k, v in _tree().items()}


def _run_port(ctor, dtype, grads_seq, found_inf=False):
    params = _port_params(dtype)
    optimizer = ctor(list(params.values()))
    for g in grads_seq:
        for k, p in params.items():
            p.grad = _t(g[k]).to(_TDT[dtype])
        if found_inf:
            optimizer.step(found_inf=torch.tensor(0.0))
        else:
            optimizer.step()
    return {k: _np(p) for k, p in params.items()}, optimizer, params


# (name, port constructor, JAX transform) over JAX's grids
_CASES = []
for _m, _n, _wd in [(0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 0.0),
                    (0.9, False, 0.05)]:
    _CASES.append((f"sgd m={_m} nesterov={_n} wd={_wd}",
                   (lambda m, n, wd: lambda ps: opt.FusedSGD(
                       ps, lr=1e-2, momentum=m, nesterov=n,
                       weight_decay=wd))(_m, _n, _wd),
                   jopt.FusedSGD(lr=1e-2, momentum=_m, nesterov=_n,
                                 weight_decay=_wd)))
_CASES.append(("sgd wd_after_momentum dampening",
               lambda ps: opt.FusedSGD(ps, lr=1e-2, momentum=0.9,
                                       dampening=0.1, weight_decay=0.05,
                                       wd_after_momentum=True),
               jopt.FusedSGD(lr=1e-2, momentum=0.9, dampening=0.1,
                             weight_decay=0.05, wd_after_momentum=True)))
for _wd, _w in [(0.0, False), (0.1, False), (0.1, True)]:
    _CASES.append((f"adagrad wd={_wd} w_mode={_w}",
                   (lambda wd, w: lambda ps: opt.FusedAdagrad(
                       ps, lr=1e-2, weight_decay=wd,
                       adagrad_w_mode=w))(_wd, _w),
                   jopt.FusedAdagrad(lr=1e-2, weight_decay=_wd,
                                     adagrad_w_mode=_w)))
for _wd, _mgn, _nv in [(0.01, 1.0, False), (0.0, 1.0, False),
                       (0.1, 0.0, False), (0.0, 1.0, True)]:
    _CASES.append((f"lamb wd={_wd} mgn={_mgn} nvlamb={_nv}",
                   (lambda wd, mgn, nv: lambda ps: opt.FusedLAMB(
                       ps, lr=1e-2, weight_decay=wd, max_grad_norm=mgn,
                       use_nvlamb=nv))(_wd, _mgn, _nv),
                   jopt.FusedLAMB(lr=1e-2, weight_decay=_wd,
                                  max_grad_norm=_mgn, use_nvlamb=_nv)))
_CASES.append(("mixed precision lamb",
               lambda ps: opt.FusedMixedPrecisionLamb(ps, lr=1e-2,
                                                      max_grad_norm=0.5),
               jopt.FusedMixedPrecisionLamb(lr=1e-2, max_grad_norm=0.5)))
for _wd, _kw in [(0.0, {}), (0.01, {}), (0.01, dict(reg_inside_moment=True)),
                 (0.0, dict(norm_type=0)), (0.0, dict(init_zero=True)),
                 (0.0, dict(grad_averaging=False))]:
    _CASES.append((f"novograd wd={_wd} {sorted(_kw)}",
                   (lambda wd, kw: lambda ps: opt.FusedNovoGrad(
                       ps, lr=1e-2, betas=(0.95, 0.98), weight_decay=wd,
                       **kw))(_wd, _kw),
                   jopt.FusedNovoGrad(lr=1e-2, betas=(0.95, 0.98),
                                      weight_decay=_wd, **_kw)))
for _aw, _wd in [(True, 0.0), (True, 0.1), (False, 0.0), (False, 0.1)]:
    _CASES.append((f"adam adam_w={_aw} wd={_wd}",
                   (lambda aw, wd: lambda ps: opt.FusedAdam(
                       ps, lr=1e-2, weight_decay=wd, adam_w_mode=aw))(
                           _aw, _wd),
                   jopt.FusedAdam(lr=1e-2, weight_decay=_wd,
                                  adam_w_mode=_aw, fused_tail="off")))
_BY_NAME = {c[0]: c for c in _CASES}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_BY_NAME))
def test_optimizer_matches_jax(name, dtype):
    """5 steps of the port optimizer vs JAX's transform from the same
    params and gradients. fp32: params within rtol 1e-5 + atol 1e-6 (one
    fp32 op chain each, libm and sums in other orders). bf16 params: each
    update rounded to bf16 and added in fp32 on both sides, where an
    update near a rounding midpoint can land one bf16 step apart in any of
    the 5 steps (XLA may fuse a multiply-add the port rounds twice): rtol
    4e-2 (5 steps of one bf16 step, up to 2**-7 relative), atol 1e-4."""
    _, ctor, tx = _BY_NAME[name]
    grads = _grad_seq()
    want, _ = _run_jax(tx, dtype, grads)
    # Adam with found_inf takes the device-count path; the rest always do
    kw = {"found_inf": name.startswith("adam")}
    got, _, params = _run_port(ctor, dtype, grads, **kw)
    for k in want:
        assert params[k].dtype == _TDT[dtype]
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want[k].astype(np.float32),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k].astype(np.float32),
                                       rtol=4e-2, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(_BY_NAME))
def test_state_is_fp32_and_count_on_device(name):
    """Every state tensor is fp32 (bf16 params too) and the count is a
    0-d int32 tensor equal to JAX's count."""
    _, ctor, tx = _BY_NAME[name]
    grads = _grad_seq(3)
    _, jstate = _run_jax(tx, "bfloat16", grads)
    _, optimizer, params = _run_port(ctor, "bfloat16", grads,
                                     found_inf=True)
    step = optimizer.param_groups[0]["step"]
    assert torch.is_tensor(step) and step.dtype == torch.int32
    assert int(step) == int(jstate.count) == 3
    for p in params.values():
        for v in optimizer.state[p].values():
            assert v.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(_BY_NAME))
def test_found_inf_keeps_params_state_and_count(name):
    """A step with the overflow flag set keeps every param, every state
    tensor and the count bitwise (amp's guard, on the device), then a
    clean step moves the params."""
    _, ctor, _ = _BY_NAME[name]
    grads = _grad_seq(3)
    _, optimizer, params = _run_port(ctor, "float32", grads[:2],
                                     found_inf=True)
    before = {k: p.clone() for k, p in params.items()}
    state = {id(p): {n: v.clone() for n, v in optimizer.state[p].items()}
             for p in params.values()}
    count = optimizer.param_groups[0]["step"].clone()
    for k, p in params.items():
        p.grad = torch.full_like(p, float("inf"))
    optimizer.step(found_inf=torch.tensor(1.0))
    for k, p in params.items():
        assert torch.equal(p, before[k]), k
        for n, v in optimizer.state[p].items():
            assert torch.equal(v, state[id(p)][n]), (k, n)
    assert torch.equal(optimizer.param_groups[0]["step"], count)
    for k, p in params.items():
        p.grad = _t(grads[2][k])
    optimizer.step(found_inf=torch.tensor(0.0))
    assert int(optimizer.param_groups[0]["step"]) == int(count) + 1
    assert any(not torch.equal(p, before[k]) for k, p in params.items())


def test_callable_lr_gets_the_device_count():
    """A schedule is called with the 1-based count as a 0-d int32 tensor
    (JAX's ``value_at``) and its value is used without a host read: the
    params equal JAX's with the same schedule (rtol 1e-5)."""
    seen = []

    def sched(count):
        seen.append(count)
        return 1e-2 / (count.astype(jnp.float32) if hasattr(count, "astype")
                       and not torch.is_tensor(count) else count.float())

    grads = _grad_seq(3)
    want, _ = _run_jax(jopt.FusedSGD(lr=sched, momentum=0.9), "float32",
                       grads)
    seen.clear()
    got, _, _ = _run_port(lambda ps: opt.FusedSGD(ps, lr=sched,
                                                  momentum=0.9),
                          "float32", grads)
    assert [int(c) for c in seen] == [1, 2, 3]
    assert all(torch.is_tensor(c) and c.dtype == torch.int32 for c in seen)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)


def test_optimizer_state_from_numpy_continues_jax():
    """JAX's state after 2 steps carried over (``optimizer_state_from_
    numpy``), 3 more port steps: the params equal JAX's 5-step run (rtol
    1e-5), for SGD, Adagrad, NovoGrad and LAMB."""
    grads = _grad_seq()
    for ctor, tx in ((lambda ps: opt.FusedSGD(ps, lr=1e-2, momentum=0.9),
                      jopt.FusedSGD(lr=1e-2, momentum=0.9)),
                     (lambda ps: opt.FusedAdagrad(ps, lr=1e-2),
                      jopt.FusedAdagrad(lr=1e-2)),
                     (lambda ps: opt.FusedNovoGrad(ps, lr=1e-2),
                      jopt.FusedNovoGrad(lr=1e-2)),
                     (lambda ps: opt.FusedLAMB(ps, lr=1e-2),
                      jopt.FusedLAMB(lr=1e-2))):
        mid, jstate = _run_jax(tx, "float32", grads[:2])
        want, _ = _run_jax(tx, "float32", grads)
        params = params_from_numpy(mid, "cpu")
        optimizer = ctor([p for _, p in named_leaves(params)])
        optimizer_state_from_numpy(jax.tree.map(np.asarray, jstate), params,
                                   optimizer)
        assert int(optimizer.param_groups[0]["step"]) == 2
        for g in grads[2:]:
            for k, p in params.items():
                p.grad = _t(g[k])
            optimizer.step()
        for k in want:
            np.testing.assert_allclose(_np(params[k]), want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# LARC


def _run_larc(params_np, grads_seq, larc_kw, inner):
    tparams = {k: _t(v) for k, v in params_np.items()}
    o = opt.LARC(inner(list(tparams.values())), **larc_kw)
    for g in grads_seq:
        for k, p in tparams.items():
            p.grad = _t(g[k])
        o.step()
    return {k: _np(p) for k, p in tparams.items()}


def test_larc_rescales_gradients():
    """JAX's two LARC cases: tiny grads clip to plain SGD, huge grads are
    scaled by the adaptive rate (rtol 1e-6 / 1e-5, JAX's)."""
    params = {"w": np.full((4,), 2.0, np.float32)}
    kw = dict(trust_coefficient=0.02, clip=True, lr=0.1)
    sgd = lambda ps: opt.FusedSGD(ps, lr=0.1)
    got = _run_larc(params, [{"w": np.full((4,), 0.001, np.float32)}], kw,
                    sgd)
    np.testing.assert_allclose(got["w"], 2.0 - 0.1 * 0.001, rtol=1e-6)
    got2 = _run_larc(params, [{"w": np.full((4,), 100.0, np.float32)}], kw,
                     sgd)
    adaptive = 0.02 * 4.0 / 200.0 / 0.1
    np.testing.assert_allclose(got2["w"], 2.0 - 0.1 * 100.0 * adaptive,
                               rtol=1e-5)


def test_zero_norm_params_passthrough_larc():
    got = _run_larc({"w": np.zeros((4,), np.float32)},
                    [{"w": np.ones((4,), np.float32)}],
                    dict(clip=True, lr=0.1),
                    lambda ps: opt.FusedSGD(ps, lr=0.1))
    np.testing.assert_allclose(got["w"], -0.1, rtol=1e-6)


@pytest.mark.parametrize("clip,wd", [(True, 0.0), (False, 0.0),
                                     (True, 0.01), (False, 0.01)])
def test_larc_matches_jax(clip, wd):
    """LARC(FusedSGD(momentum 0.9)) over 5 steps vs JAX's
    ``LARC(FusedSGD)``: params within rtol 1e-5 + atol 1e-6."""
    kw = dict(trust_coefficient=0.02, clip=clip, weight_decay=wd, lr=0.1)
    want, _ = _run_jax(jopt.LARC(jopt.FusedSGD(lr=0.1, momentum=0.9), **kw),
                       "float32", _grad_seq())
    got = _run_larc(_tree(), _grad_seq(), kw,
                    lambda ps: opt.FusedSGD(ps, lr=0.1, momentum=0.9))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_larc_transform_alone_and_refusal():
    """``larc_transform`` as a stage (init / update) equals JAX's on one
    step (rtol 1e-6); clip mode without lr is refused, as JAX."""
    t = opt.larc_transform(lr=0.1, weight_decay=0.01)
    params = {k: _t(v) for k, v in _tree().items()}
    grads = {k: _t(v) for k, v in _grad_seq(1)[0].items()}
    out, count = t.update(grads, t.init(params), params)
    jt = jopt.larc_transform(lr=0.1, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, _tree())
    jout, jstate = jt.update(jax.tree.map(jnp.asarray, _grad_seq(1)[0]),
                             jt.init(jp), jp)
    assert int(count) == int(jstate.count) == 1
    for k in out:
        np.testing.assert_allclose(_np(out[k]), np.asarray(jout[k]),
                                   rtol=1e-6)
    for mod in (opt, jopt):
        with pytest.raises(ValueError, match="clip mode"):
            mod.larc_transform(clip=True)


def test_larc_keeps_its_count_on_overflow():
    o = opt.LARC(opt.FusedSGD([torch.ones(4)], lr=0.1), lr=0.1)
    p = o.param_groups[0]["params"][0]
    p.grad = torch.ones(4)
    o.step(found_inf=torch.tensor(0.0))
    p.grad = torch.full((4,), float("inf"))
    before = p.clone()
    o.step(found_inf=torch.tensor(1.0))
    assert int(o.count) == 1 and torch.equal(p, before)


# ---------------------------------------------------------------------------
# global_norm, apply_updates, grad accumulation, multi_tensor_apply


def test_global_norm_and_apply_updates_match_jax():
    tree = {"a": np.ones((3,), np.float32),
            "b": np.full((4,), 2.0, np.float32)}
    got = opt.global_norm({k: _t(v) for k, v in tree.items()})
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    assert float(got) == float(want)
    np.testing.assert_allclose(float(got), np.sqrt(3 + 16), rtol=1e-6)
    assert float(opt.global_norm({})) == 0.0
    upd = {"a": np.full((3,), 0.5, np.float32),
           "b": np.full((4,), 1e-3, np.float32)}
    p = {"a": _t(tree["a"]).bfloat16(), "b": _t(tree["b"])}
    out = opt.apply_updates(p, {"a": _t(upd["a"]).bfloat16(),
                                "b": _t(upd["b"])})
    jout = japply({"a": jnp.asarray(tree["a"], jnp.bfloat16),
                   "b": jnp.asarray(tree["b"])},
                  {"a": jnp.asarray(upd["a"], jnp.bfloat16),
                   "b": jnp.asarray(upd["b"])})
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == \
        torch.float32
    for k in out:
        np.testing.assert_array_equal(_np(out[k]),
                                      np.asarray(jout[k], np.float32))


def test_main_grads_accumulate_bf16_grads_in_fp32():
    """``init_main_grads`` / ``accumulate_into_main_grads``: bf16 grads
    added into fp32 accumulators, bitwise JAX's."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32)}
    main = opt.init_main_grads({"w": _t(params["w"]).bfloat16()})
    jmain = jopt.init_main_grads({"w": jnp.asarray(params["w"],
                                                   jnp.bfloat16)})
    assert main["w"].dtype == torch.float32
    for i in range(4):
        g = (rng.standard_normal((8, 4)) * 10 ** i).astype(np.float32)
        main = opt.accumulate_into_main_grads(main,
                                              {"w": _t(g).bfloat16()})
        jmain = jopt.accumulate_into_main_grads(
            jmain, {"w": jnp.asarray(g, jnp.bfloat16)})
    np.testing.assert_array_equal(_np(main["w"]), np.asarray(jmain["w"]))


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accumulate_gradients_matches_jax(mean, dtype):
    """``accumulate_gradients`` over 4 microbatches of a two-layer MLP
    loss: the fp32 loss and fp32 main grads vs JAX's (fp32: rtol 1e-5;
    bf16 params: the same bf16 backward on both sides, each microbatch's
    gradient within a bf16 rounding: rtol 2e-2 + atol 1e-3 of the
    gradient scale)."""
    rng = np.random.default_rng(5)
    w1 = rng.standard_normal((6, 8)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((8, 3)).astype(np.float32) * 0.3
    xs = rng.standard_normal((4, 5, 6)).astype(np.float32)

    def jloss(p, x):
        h = jnp.tanh(x @ p["w1"])
        return jnp.mean((h @ p["w2"]).astype(jnp.float32) ** 2)

    def tloss(p, x):
        h = torch.tanh(x @ p["w1"])
        return torch.mean((h @ p["w2"]).float() ** 2)

    jp = {"w1": jnp.asarray(w1, _JDT[dtype]),
          "w2": jnp.asarray(w2, _JDT[dtype])}
    jl, jg = jopt.accumulate_gradients(jloss, jp, jnp.asarray(xs,
                                                               _JDT[dtype]),
                                       mean=mean)
    tp = {"w1": _t(w1).to(_TDT[dtype]).requires_grad_(True),
          "w2": _t(w2).to(_TDT[dtype]).requires_grad_(True)}
    tl, tg = opt.accumulate_gradients(tloss, tp, _t(xs).to(_TDT[dtype]),
                                      mean=mean)
    assert tl.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in tg.values())
    tight = dtype == "float32"
    np.testing.assert_allclose(float(tl), float(jl),
                               rtol=1e-5 if tight else 2e-2)
    for k in tg:
        scale = float(np.abs(np.asarray(jg[k])).max())
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]),
                                   rtol=1e-5 if tight else 2e-2,
                                   atol=1e-7 if tight else 1e-3 * scale)


def test_multi_tensor_apply_matches_jax():
    """``op`` over zipped trees and the fp32 0/1 overflow flag over every
    input leaf, as JAX's shim (a NaN or an inf in any list sets it)."""
    a = {"x": np.ones((3,), np.float32), "y": np.arange(4, dtype=np.float32)}
    b = {"x": np.full((3,), 2.0, np.float32),
         "y": np.ones((4,), np.float32)}
    op = lambda u, v, s: u * s + v
    applier, japplier = MultiTensorApply(2048 * 32), JMultiTensorApply()
    assert applier.chunk_size == 2048 * 32
    for poison in (None, np.inf, np.nan):
        bb = {k: v.copy() for k, v in b.items()}
        if poison is not None:
            bb["y"][2] = poison
        out, flag = applier(op, None, [{k: _t(v) for k, v in a.items()},
                                       {k: _t(v) for k, v in bb.items()}],
                            3.0)
        jout, jflag = japplier(op, None, [jax.tree.map(jnp.asarray, a),
                                          jax.tree.map(jnp.asarray, bb)],
                               3.0)
        assert flag.dtype == torch.float32
        assert float(flag) == float(jflag) == (0.0 if poison is None
                                               else 1.0)
        np.testing.assert_array_equal(_np(out["x"]), np.asarray(jout["x"]))
    out, flag = multi_tensor_applier(lambda u: u, None, [[]])
    assert float(flag) == 0.0


# ---------------------------------------------------------------------------
# the Adam tail's device arguments (B #15's plain version)


def _tail_inputs(seed=0, n=1000):
    rng = np.random.default_rng(seed)
    g = _t(rng.standard_normal(n).astype(np.float32))
    m = _t(0.01 * rng.standard_normal(n).astype(np.float32))
    v = _t(1e-4 * rng.random(n).astype(np.float32))
    p = _t(rng.standard_normal(n).astype(np.float32))
    return g, m, v, p


_KW = dict(betas=(0.9, 0.999), eps=1e-8)
_C1 = float(np.float32(1) - np.float32(0.9) ** np.float32(3))
_C2 = float(np.float32(1) - np.float32(0.999) ** np.float32(3))


@pytest.mark.parametrize("wd,adam_w", [(0.0, True), (0.01, True),
                                       (0.01, False)])
def test_adam_tail_null_arguments_give_the_same_bits(wd, adam_w):
    """``corr=None, found_inf=None`` is the host path: the same bits as the
    call without them, for both decay modes."""
    g, m, v, p = _tail_inputs()
    m2, v2 = m.clone(), v.clone()
    a = fused_adam_tail(g, m, v, p, _C1, _C2, weight_decay=wd,
                        adam_w_mode=adam_w, **_KW)
    b = fused_adam_tail(g, m2, v2, p, _C1, _C2, weight_decay=wd,
                        adam_w_mode=adam_w, corr=None, found_inf=None, **_KW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_adam_tail_flag_changes_nothing():
    """A set flag leaves m and v bitwise, gives u = 0 (so p + (-lr·u) is p
    bitwise) and LAMB sums of 0; a clear flag gives the unflagged values
    bitwise; device corrections holding the host values give the host
    path's bits (true division on both)."""
    g, m, v, p = _tail_inputs(1)
    m0, v0 = m.clone(), v.clone()
    u, m1, v1 = fused_adam_tail(g, m, v, p, _C1, _C2,
                                found_inf=torch.ones(1), **_KW)
    assert torch.equal(m, m0) and torch.equal(v, v0)
    assert torch.equal(u, torch.zeros_like(u))
    assert torch.equal(p + (-1e-3 * u), p)
    out = fused_lamb_tail(g, m.clone(), v.clone(), p, _C1, _C2,
                          weight_decay=0.01, found_inf=torch.ones(1), **_KW)
    assert float(out[3]) == 0.0 and float(out[4]) == 0.0
    want = adam_tail_reference(g, m0.clone(), v0.clone(), p, _C1, _C2,
                               **_KW)
    got = fused_adam_tail(g, m0.clone(), v0.clone(), p, _C1, _C2,
                          found_inf=torch.zeros(1), **_KW)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    corr = torch.tensor([_C1, _C2], dtype=torch.float32)
    got = adam_tail_reference(g, m0.clone(), v0.clone(), p, 0.5, 0.5,
                              corr=corr, **_KW)
    want = adam_tail_reference(g, m0.clone(), v0.clone(), p,
                               torch.tensor(_C1), torch.tensor(_C2), **_KW)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    lamb = lamb_tail_reference(g, m0.clone(), v0.clone(), p, _C1, _C2,
                               weight_decay=0.01, found_inf=torch.zeros(1),
                               **_KW)
    plain = lamb_tail_reference(g, m0.clone(), v0.clone(), p, _C1, _C2,
                                weight_decay=0.01, **_KW)
    for x, y in zip(lamb, plain):
        assert torch.equal(x, y)


def test_fused_adam_device_step_tracks_the_host_step():
    """FusedAdam's device-count path (``step(found_inf=0)``) vs its host
    path over 5 steps: params within rtol 1e-6 (c1, c2 from the device
    count; the division by a tensor is a true division where the host's
    Python float goes through its reciprocal), the count a 0-d int32 5."""
    grads = _grad_seq()
    host, _, _ = _run_port(lambda ps: opt.FusedAdam(ps, lr=1e-2), "float32",
                           grads)
    dev, o, _ = _run_port(lambda ps: opt.FusedAdam(ps, lr=1e-2), "float32",
                          grads, found_inf=True)
    step = o.param_groups[0]["step"]
    assert torch.is_tensor(step) and int(step) == 5
    for k in host:
        np.testing.assert_allclose(dev[k], host[k], rtol=1e-6, atol=1e-7)


def test_tree_leaves_order_is_jax_order():
    tree = {"b": {"y": 1, "x": 2}, "a": [3, (4, 5)]}
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
