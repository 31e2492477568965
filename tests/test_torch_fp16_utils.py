"""``fp16_utils`` of the port against JAX's (``apex_tpu/fp16_utils``): the
tree casts, master-param bookkeeping, ``clip_grad_norm``, the legacy
scalers and ``FP16_Optimizer`` (steps, overflow skips, clipping, the
``state_dict`` round trip), in fp16 and bf16, on the CPU.

The same numpy values go to both sides. Tolerances: casts and the
scaler's states exactly; norms and clipped grads rtol 1e-6 (fp32 sums in
other orders); masters after Adam steps rtol 1e-6, atol 1e-7 (the same
fp32 tail on both sides, torch dividing through its reciprocal).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.fp16_utils import FP16_Optimizer as JFP16_Optimizer
from apex_tpu.fp16_utils import DynamicLossScaler as JDynamicLossScaler
from apex_tpu.fp16_utils import LossScaler as JLossScaler
from apex_tpu.fp16_utils import clip_grad_norm as jax_clip
from apex_tpu.fp16_utils import convert_network as jax_convert
from apex_tpu.fp16_utils import master_params_to_model_params as jax_m2m
from apex_tpu.fp16_utils import model_grads_to_master_grads as jax_g2m
from apex_tpu.fp16_utils import network_to_half as jax_to_half
from apex_tpu.fp16_utils import prep_param_lists as jax_prep
from apex_tpu.optimizers import FusedAdam as JFusedAdam

from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.fp16_utils import (DynamicLossScaler, FP16_Optimizer,
                                       FP16OptimizerState, LossScaler,
                                       clip_grad_norm, convert_network,
                                       master_params_to_model_params,
                                       model_grads_to_master_grads,
                                       network_to_half, prep_param_lists,
                                       to_python_float)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers._common import tree_leaves

DTYPES = {"float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _net_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.standard_normal((8, 4)).astype(np.float32),
                      "bias": rng.standard_normal(4).astype(np.float32)},
            "LayerNorm_0": {"scale": np.ones(4, np.float32),
                            "bias": np.zeros(4, np.float32)},
            "steps": np.arange(3, dtype=np.int32)}


def _port(tree):
    return {k: _port(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same_leaves(port_tree, jax_tree, rtol=0.0, atol=0.0):
    jl = dict(named_leaves(jax.tree.map(np.asarray, jax_tree)))
    pl = dict(named_leaves(port_tree))
    assert sorted(jl) == sorted(pl)
    for name, t in pl.items():
        want = jl[name]
        assert str(t.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("half", list(DTYPES))
def test_convert_network_and_to_half_match_jax(half):
    """Float leaves to the half type, norm params fp32, ints untouched;
    ``network_to_half`` defaults to bf16 as JAX's."""
    tdt, jdt = DTYPES[half]
    _same_leaves(convert_network(_port(_net_np()), tdt),
                 jax_convert(_jax(_net_np()), jdt))
    _same_leaves(network_to_half(_port(_net_np())),
                 jax_to_half(_jax(_net_np())))
    _same_leaves(network_to_half(_port(_net_np()), tdt),
                 jax_to_half(_jax(_net_np()), jdt))


@pytest.mark.parametrize("half", list(DTYPES))
@pytest.mark.parametrize("flat", [False, True])
def test_master_param_lists_match_jax(half, flat):
    """``prep_param_lists`` (fp32 masters, flat or not),
    ``model_grads_to_master_grads`` and ``master_params_to_model_params``
    against JAX's, values and dtypes."""
    tdt, jdt = DTYPES[half]
    net = {k: v for k, v in _net_np(1).items() if k != "steps"}
    pm = convert_network(_port(net), tdt)
    jm = jax_convert(_jax(net), jdt)
    p_model, p_master = prep_param_lists(pm, flat_master=flat)
    j_model, j_master = jax_prep(jm, flat_master=flat)
    assert p_model is pm
    if flat:
        assert p_master.dtype == torch.float32
        np.testing.assert_array_equal(p_master.numpy(),
                                      np.asarray(j_master))
    else:
        _same_leaves(p_master, j_master)
        moved = master_params_to_model_params(
            {k: {kk: vv + 0.25 for kk, vv in d.items()}
             for k, d in p_master.items()}, pm)
        jmoved = jax_m2m(jax.tree.map(lambda m: m + 0.25, j_master), jm)
        _same_leaves(moved, jmoved)
    if flat:
        np.testing.assert_array_equal(
            model_grads_to_master_grads(pm, flat_master=True).numpy(),
            np.asarray(jax_g2m(jm, flat_master=True)))
    else:
        _same_leaves(model_grads_to_master_grads(pm), jax_g2m(jm))


@pytest.mark.parametrize("half", list(DTYPES))
@pytest.mark.parametrize("norm_type,max_norm", [(2.0, 5.0), (2.0, 1e3),
                                                (float("inf"), 1.0),
                                                (1.5, 2.0)])
def test_clip_grad_norm_matches_jax(half, norm_type, max_norm):
    """The total norm (fp32) and the clipped leaves (back in their type)
    against JAX's ``clip_grad_norm``; a norm under max_norm keeps the
    leaves."""
    tdt, jdt = DTYPES[half]
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((16, 8)).astype(np.float32),
         "b": (3 * rng.standard_normal(40)).astype(np.float32)}
    pg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
    jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
    clipped, total = clip_grad_norm(pg, max_norm, norm_type)
    jclipped, jtotal = jax_clip(jg, max_norm, norm_type)
    assert total.dtype == torch.float32 and total.dim() == 0
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    _same_leaves(clipped, jclipped, rtol=2 ** -7 if half == "bfloat16"
                 else 2 ** -10)
    assert to_python_float(total) == float(total)


def test_legacy_scalers_match_jax():
    """The static scaler's ``cur_scale`` and fixed scale; the dynamic
    scaler's defaults, ``has_overflow`` and backoff, against JAX's."""
    s, js = LossScaler(64.0), JLossScaler(64.0)
    assert s.cur_scale == js.cur_scale == 64.0
    st, jst = s.init_state(device="cpu"), js.init_state()
    st, sk = s.update_scale(st, torch.tensor(1.0))
    jst, jsk = js.update_scale(jst, jnp.asarray(1.0))
    assert float(st.loss_scale) == float(jst.loss_scale) == 64.0
    assert bool(sk) == bool(jsk)
    d, jd = DynamicLossScaler(scale_window=2), JDynamicLossScaler(
        scale_window=2)
    st, jst = d.init_state(device="cpu"), jd.init_state()
    assert float(st.loss_scale) == float(jst.loss_scale) == 2.0 ** 32
    for f in (0.0, 0.0, 1.0, 0.0):
        st, sk = d.update_scale(st, torch.tensor(f))
        jst, jsk = jd.update_scale(jst, jnp.asarray(f))
        assert (float(st.loss_scale), bool(sk)) == (float(jst.loss_scale),
                                                    bool(jsk))
    for bad in (False, True):
        g = np.ones((3, 3), np.float32)
        if bad:
            g[1, 2] = np.inf
        got = DynamicLossScaler.has_overflow({"g": torch.from_numpy(g)})
        want = JDynamicLossScaler.has_overflow({"g": jnp.asarray(g)})
        assert bool(got) == bool(want) == bad


def _grad_steps(seed, n_steps, overflow_at, scale):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        g = {"dense": {"kernel": rng.standard_normal((8, 4)),
                       "bias": rng.standard_normal(4)},
             "LayerNorm_0": {"scale": rng.standard_normal(4),
                             "bias": rng.standard_normal(4)}}
        g = jax.tree.map(lambda a: (a * scale).astype(np.float32), g)
        if i == overflow_at:
            g["dense"]["kernel"][0, 0] = np.inf
        out.append(g)
    return out


def _run_both(half, static, max_grad_norm=None, steps=4, overflow_at=2,
              save_at=None):
    tdt, jdt = DTYPES[half]
    net = {k: v for k, v in _net_np(2).items() if k != "steps"}
    pm = convert_network(_port(net), tdt)
    jm = jax_convert(_jax(net), jdt)
    kw = (dict(static_loss_scale=128.0) if static else
          dict(dynamic_loss_scale=True,
               dynamic_loss_args={"init_scale": 2.0 ** 8,
                                  "scale_window": 2}))
    opt = FP16_Optimizer(FusedAdam(tree_leaves(pm), lr=1e-2), **kw)
    jopt = JFP16_Optimizer(JFusedAdam(lr=1e-2, fused_tail="off"), **kw)
    st, jst = opt.init(pm), jopt.init(jm)
    grads = _grad_steps(3, steps, overflow_at, 128.0)
    saved = None
    for i, g in enumerate(grads):
        if i == save_at:
            saved = opt.state_dict(st)
        pg = [torch.from_numpy(np.asarray(x)).to(l.dtype)
              for x, l in zip(jax.tree.leaves(g), tree_leaves(pm))]
        jg = jax.tree.map(lambda x, l: jnp.asarray(x, l.dtype), g, jm)
        masters, st, skipped = opt.step(pg, st, max_grad_norm=max_grad_norm)
        jmasters, jst, jskipped = jopt.step(jg, jst,
                                            max_grad_norm=max_grad_norm)
        assert bool(skipped) == bool(jskipped) == (i == overflow_at)
        _same_leaves(masters, jmasters, rtol=1e-6, atol=1e-7)
        assert float(st.scaler.loss_scale) == float(jst.scaler.loss_scale)
    return opt, st, saved, grads, pm


@pytest.mark.parametrize("half", list(DTYPES))
@pytest.mark.parametrize("static", [True, False])
def test_fp16_optimizer_steps_and_skips_match_jax(half, static):
    """``FP16_Optimizer`` over ``FusedAdam``: fp32 masters after every
    step, the skip on the overflow step (masters, moments and the count
    kept) and the scale (static, or dynamic with backoff and growth)
    against JAX's over ``FusedAdam``; the model view in the half type."""
    opt, st, _, _, pm = _run_both(half, static)
    group = opt.optimizer.param_groups[0]
    assert int(group["step"]) == 3      # four steps, one skipped
    view = opt.model_params(st, pm)
    assert view["dense"]["kernel"].dtype == DTYPES[half][0]
    assert view["LayerNorm_0"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("half", list(DTYPES))
def test_fp16_optimizer_clipping_matches_jax(half):
    _run_both(half, static=True, max_grad_norm=0.5)


@pytest.mark.parametrize("half", list(DTYPES))
def test_fp16_optimizer_state_dict_round_trip(half):
    """A state saved before the last step and loaded back gives that
    step's masters and scaler state bitwise; the saved dict does not move
    with later steps."""
    opt, st, saved, grads, pm = _run_both(half, static=False, steps=4,
                                          overflow_at=1, save_at=3)
    kernel_saved = saved["master_params"]["dense"]["kernel"].clone()
    st2 = opt.load_state_dict(saved)
    assert isinstance(st2, FP16OptimizerState)
    assert torch.equal(saved["master_params"]["dense"]["kernel"],
                       kernel_saved)
    pg = [torch.from_numpy(np.asarray(x)).to(l.dtype)
          for x, l in zip(jax.tree.leaves(grads[3]), tree_leaves(pm))]
    masters, st2, _ = opt.step(pg, st2)
    for a, b in zip(tree_leaves(masters), tree_leaves(st.master_params)):
        assert torch.equal(a, b)
    assert float(st2.scaler.loss_scale) == float(st.scaler.loss_scale)
    assert int(st2.scaler.unskipped) == int(st.scaler.unskipped)


def test_fp16_optimizer_refuses_an_optimizer_over_other_params():
    pm = convert_network(_port({k: v for k, v in _net_np().items()
                                if k != "steps"}), torch.float16)
    opt = FP16_Optimizer(FusedAdam([torch.zeros(3)], lr=1e-3))
    with pytest.raises(ValueError, match="float leaves"):
        opt.init(pm)
