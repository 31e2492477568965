"""apex_tpu_torch's third slice on the CPU, against apex_tpu: the fused
LM-head + cross-entropy, the fused Adam / LAMB tail, and the default train
step that runs both.

The same numpy inputs go through the JAX function and its port. The JAX
side runs as its own tests run it on the CPU: ``_lm_head_loss(...,
"pallas_interpret")`` (``tests/test_lm_head_loss.py``), the update-tail
Pallas kernels in interpret mode (``tests/test_megakernel.py``), and the
model through the ``shard_map`` + ``value_and_grad`` recipe of
``tests/test_gpt_fused_loss.py``, whose fused branch takes the dense
implementation off the TPU. The port's wrappers take their plain PyTorch
versions for CPU tensors; the CUDA kernels are held against those on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.ops.fused_update import fused_adam_tail as jax_adam_tail
from apex_tpu.ops.fused_update import fused_lamb_tail as jax_lamb_tail
from apex_tpu.ops.lm_head_loss import _lm_head_loss as jax_lm_head_loss
from apex_tpu.ops.lm_head_loss import pallas_fits as jax_pallas_fits
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import gpt_param_specs
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.convert import (adam_state_from_numpy, named_leaves,
                                    params_from_numpy)
from apex_tpu_torch.ops.fused_update import (fused_adam_tail,
                                             fused_lamb_tail, resolve_fused)
from apex_tpu_torch.ops.lm_head_loss import (kernel_fits, lm_head_loss,
                                             lm_head_loss_bwd_reference,
                                             lm_head_loss_fwd_reference,
                                             lm_head_loss_reference)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.testing import (GPTConfig, build_train_step,
                                                gpt_loss)
from apex_tpu_torch.transformer.testing.standalone_gpt import \
    _use_fused_loss
from apex_tpu_torch.transformer.testing.train import param_leaves


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# fused LM-head + cross-entropy (B #12-14)


def _lm_inputs(seed, n, v, h):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((v, h)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    return x, w, t


def _jax_loss_and_grads(x, w, t, bn, bv, dtype=jnp.float32):
    def fused(x2, w):
        return jnp.mean(jax_lm_head_loss(x2, w, jnp.asarray(t), None, bn, bv,
                                         "pallas_interpret"))

    loss, (dx, dw) = jax.jit(jax.value_and_grad(fused, argnums=(0, 1)))(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    return (float(loss), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port_loss_and_grads(x, w, t, dtype=torch.float32):
    tx = _t(x).to(dtype).requires_grad_()
    tw = _t(w).to(dtype).requires_grad_()
    loss = lm_head_loss(tx, tw, _t(t)).mean()
    loss.backward()
    return loss.item(), tx.grad, tw.grad


@pytest.mark.parametrize("n,v,h,bn,bv", [
    (16, 64, 128, 8, 16),     # aligned vocab
    (16, 37, 128, 8, 16),     # ragged final vocab block
    (32, 100, 256, 16, 32),   # ragged, larger
])
def test_lm_head_loss_matches_jax_kernel(n, v, h, bn, bv):
    """Mean loss, dx and dw of the port's ``lm_head_loss`` (its plain
    versions, through autograd) vs ``jax.value_and_grad`` of the JAX
    Pallas kernels in interpret mode, fp32: loss rtol 1e-5, gradients
    rtol 1e-4 / atol 1e-5 (the JAX package's own tolerances against its
    dense reference)."""
    x, w, t = _lm_inputs(n + v, n, v, h)
    want = _jax_loss_and_grads(x, w, t, bn, bv)
    got = _port_loss_and_grads(x, w, t)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(_np(got[1]), want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got[2]), want[2], rtol=1e-4, atol=1e-5)
    per_row = lm_head_loss(_t(x), _t(w), _t(t))
    np.testing.assert_allclose(
        per_row.numpy(), lm_head_loss_reference(_t(x), _t(w), _t(t)).numpy(),
        rtol=1e-6, atol=1e-6)


def test_lm_head_loss_bf16_rounds_dl_like_the_jax_kernel():
    """bf16 in and out. Both sides round dl to bf16 before the dx and dw
    products (``lm_head_loss.py:152,179``): the port's plain backward is
    within one bf16 step (rtol 2**-7) plus atol 2e-5 of the JAX kernel in
    interpret mode, while the same backward without the rounding is
    further from it than that tolerance allows."""
    n, v, h = 16, 37, 128
    x, w, t = _lm_inputs(7, n, v, h)
    x = x * 4                       # larger scores: dl spans many binades
    _, dx_j, dw_j = _jax_loss_and_grads(x, w, t, 8, 16, jnp.bfloat16)
    loss, dx, dw = _port_loss_and_grads(x, w, t, torch.bfloat16)
    assert dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(dx), dx_j, rtol=2 ** -7, atol=2e-5)
    np.testing.assert_allclose(_np(dw), dw_j, rtol=2 ** -7, atol=2e-5)
    # the unrounded dl (fp32 through both products) misses JAX's numbers
    tx, tw, tt = _t(x).bfloat16(), _t(w).bfloat16(), _t(t)
    lse, _ = lm_head_loss_fwd_reference(tx, tw, tt)
    g = torch.full((n,), 1.0 / n)
    dx32, dw32 = lm_head_loss_bwd_reference(tx.float(), tw.float(), tt, lse,
                                            g)
    off = max(np.abs(_np(dx32) - dx_j).max(), np.abs(_np(dw32) - dw_j).max())
    on = max(np.abs(_np(dx) - dx_j).max(), np.abs(_np(dw) - dw_j).max())
    assert off > on


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_dw_gate_catches_a_wrong_softmax_term():
    """``chip_smoke.py`` holds dW row by row. With bf16 and g = 1/n, as on
    the training path, most vocab rows get no target and hold only the
    softmax term, far below a hit row's scale. A dW from an lse 1e-6 off
    (scores summed in another order) passes; a dW whose softmax term is
    10 % too large (an lse log 1.1 low) fails, though a gate on 1e-2 of
    the whole tensor's max lets it through."""
    cs = _chip_smoke()
    n, v, h = 256, 4096, 128
    x, w, t = _lm_inputs(3, n, v, h)
    tx, tw, tt = _t(x * 2).bfloat16(), _t(w * 0.5).bfloat16(), _t(t)
    g = torch.full((n,), 1.0 / n)
    lse, _ = lm_head_loss_fwd_reference(tx, tw, tt)
    want = lm_head_loss_bwd_reference(tx, tw, tt, lse, g)[1]
    hit = torch.zeros(v, dtype=torch.bool)
    hit[tt.long()] = True
    assert hit.float().mean() < 0.1
    near = lm_head_loss_bwd_reference(tx, tw, tt, lse + 1e-6, g)[1]
    _, row_err = cs.check_rows("dw", near, want, 1e-2, 2 ** -7)
    assert row_err < 1e-2
    wrong = lm_head_loss_bwd_reference(tx, tw, tt, lse - math.log(1.1), g)[1]
    with pytest.raises(AssertionError, match="dw"):
        cs.check_rows("dw", wrong, want, 1e-2, 2 ** -7)
    cs.check_close("dw", wrong, want, 1e-2 * float(want.float().abs().max()),
                   2 ** -7)


def test_kernel_fits_is_the_jax_predicate():
    """``kernel_fits`` gives JAX's ``pallas_fits`` on every (rows, hidden)
    pair, so a config takes the same branch in both packages."""
    for n in (0, 8, 16, 96, 120, 128, 200, 256, 1000, 1024, 2048, 3000,
              8192, 8200):
        for h in (64, 128, 192, 256, 768, 1000):
            assert kernel_fits(n, h) == jax_pallas_fits(n, h), (n, h)


def test_lm_head_loss_refuses_the_vocab_parallel_form():
    """The vocab-parallel form, ported with the tensor-parallel slice (held
    to JAX across ranks in ``tests/test_torch_tensor_parallel.py``): on
    one device (no mesh, one rank on tp) it is the plain form, the loss
    and gradients bitwise the plain form's."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 128, generator=g)
    w = torch.randn(8, 128, generator=g)
    t = torch.tensor([0, 3, 7, 5])
    outs = []
    for axis in (None, "tp"):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        loss = lm_head_loss(xi, wi, t, axis_name=axis)
        outs.append((loss, *torch.autograd.grad(loss.sum(), (xi, wi))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# fused Adam / LAMB tail (B #15)


def _tail_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    g, m, p = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    v = np.abs(rng.standard_normal(shape)).astype(np.float32)
    return g, m, v, p


C1, C2 = np.float32(1 - 0.9 ** 3), np.float32(1 - 0.999 ** 3)


@pytest.mark.parametrize("shape", [(7, 13), (1,), (1025,), (33, 65)])
@pytest.mark.parametrize("wd,adam_w", [(0.0, True), (0.01, True),
                                       (0.01, False)])
def test_fused_adam_tail_matches_jax_kernel(shape, wd, adam_w):
    """u, m', v' of the port (its plain version, m and v updated in
    place) vs the JAX Pallas tail in interpret mode, on leaves far from
    the TPU tile, in both decay modes: rtol 5e-6 / atol 5e-7 (the JAX
    package's own tolerance for its kernel vs its reference)."""
    g, m, v, p = _tail_inputs(len(shape) + shape[0], shape)
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
              adam_w_mode=adam_w)
    want = jax_adam_tail(*(jnp.asarray(a) for a in (g, m, v, p)),
                         jnp.float32(C1), jnp.float32(C2), use_pallas=True,
                         interpret=True, **kw)
    tm, tv = _t(m), _t(v)
    got = fused_adam_tail(_t(g), tm, tv, _t(p), float(C1), float(C2), **kw)
    assert got[1] is tm and got[2] is tv
    for a, b, name in zip(got, want, ("u", "m", "v")):
        assert tuple(a.shape) == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-6,
                                   atol=5e-7, err_msg=name)


@pytest.mark.parametrize("shape", [(300, 70), (5,)])
def test_fused_lamb_tail_matches_jax_kernel(shape):
    """LAMB: u, m', v' within rtol 5e-6 / atol 5e-7 and Σp², Σu² within
    rtol 1e-5 of the JAX Pallas kernel's grid-accumulated sums
    (interpret mode)."""
    g, m, v, p = _tail_inputs(11, shape)
    kw = dict(betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01)
    want = jax_lamb_tail(*(jnp.asarray(a) for a in (g, m, v, p)),
                         jnp.float32(C1), jnp.float32(C2), use_pallas=True,
                         interpret=True, **kw)
    got = fused_lamb_tail(_t(g), _t(m), _t(v), _t(p), float(C1), float(C2),
                          **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-6,
                                   atol=5e-7)
    for a, b in zip(got[3:], want[3:]):
        assert a.dim() == 0
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)


def test_resolve_fused_modes():
    assert resolve_fused("auto") and resolve_fused("on")
    assert not resolve_fused("off")
    with pytest.raises(ValueError, match="fused_tail"):
        resolve_fused("always", what="fused_tail")


# ---------------------------------------------------------------------------
# the default model loss and train step vs JAX

JCFG = JGPTConfig(vocab_size=96, max_seq=32, hidden=64, num_layers=2,
                  num_heads=4, dtype=jnp.float32)
TCFG = GPTConfig(vocab_size=96, max_seq=32, hidden=64, num_layers=2,
                 num_heads=4, dtype=torch.float32)
LR = 1e-3


def _jax_loss_fn(cfg):
    mesh = build_mesh(tp=1, pp=1, sp=1)
    specs = gpt_param_specs(cfg)

    def loss_fn(p, tok, tgt):
        def body(p, tok, tgt):
            return jax_gpt_loss(p, tok, tgt, cfg)

        return jax.shard_map(body, mesh=mesh, in_specs=(specs, P(), P()),
                             out_specs=P())(p, tok, tgt)

    return loss_fn


def _batch():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, JCFG.vocab_size, (4, JCFG.max_seq)).astype(
        np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _trainable(tree):
    params = params_from_numpy(tree, "cpu")
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


@pytest.mark.parametrize("tie", [True, False])
def test_fused_gpt_loss_and_grads_match_jax(tie):
    """Loss and every gradient leaf of the port's ``gpt_loss`` with
    ``fused_loss=True`` (the default; tied and untied head) vs JAX
    ``value_and_grad`` of its ``gpt_loss``, whose fused branch runs the
    dense implementation on the CPU; loss rtol 1e-5, grads atol 2e-6 +
    rtol 1e-4 (fp32, summation order differs)."""
    jcfg = dataclasses.replace(JCFG, tie_embeddings=tie)
    tcfg = dataclasses.replace(TCFG, tie_embeddings=tie)
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    tok, tgt = _batch()
    loss_j, g_j = jax.jit(jax.value_and_grad(_jax_loss_fn(jcfg)))(
        params, tok, tgt)
    tparams = _trainable(jax.tree.map(np.asarray, params))
    assert _use_fused_loss(tcfg, tok.size, torch.device("cpu"))
    loss = gpt_loss(tparams, _t(tok).long(), _t(tgt).long(), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    got = dict(named_leaves(jax.tree.map(lambda t: t.grad.numpy(),
                                         tparams)))
    want = dict(named_leaves(jax.tree.map(np.asarray, g_j)))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-6,
                                   rtol=1e-4, err_msg=name)


def test_three_default_train_steps_match_jax():
    """From the JAX params and ``FusedAdam(fused_tail="on")`` state after
    one default step (fused loss, the Pallas tail in interpret mode),
    carried over by ``params_from_numpy`` + ``adam_state_from_numpy``,
    three port steps with ``fused_loss=True`` and ``FusedAdam(fused_tail=
    "on")`` give JAX's losses (rtol 1e-5) and final params within atol
    lr/100 + rtol 1e-5 (where a gradient is tiny, its fp32 summation order
    moves Adam's lr-sized step by a fraction of lr)."""
    params = jax_init(jax.random.PRNGKey(0), JCFG)
    tok, tgt = _batch()
    opt = JFusedAdam(lr=LR, fused_tail="on")
    loss_fn = _jax_loss_fn(JCFG)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p, tok, tgt)
        u, s = opt.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s, loss

    p, s, _ = step(params, opt.init(params))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    start_p, start_s = host(p), host(s)
    losses_j = []
    for _ in range(3):
        p, s, loss = step(p, s)
        losses_j.append(float(loss))

    tparams = _trainable(start_p)
    topt = FusedAdam(param_leaves(tparams), lr=LR, fused_tail="on")
    adam_state_from_numpy(start_s, tparams, topt)
    ttok, ttgt = _t(tok).long(), _t(tgt).long()
    losses = []
    for _ in range(3):
        topt.zero_grad(set_to_none=True)
        loss = gpt_loss(tparams, ttok, ttgt, TCFG)
        loss.backward()
        topt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    got = dict(named_leaves(jax.tree.map(_np, tparams)))
    for name, want in named_leaves(host(p)):
        np.testing.assert_allclose(got[name], want, atol=LR / 100,
                                   rtol=1e-5, err_msg=name)


def test_default_build_train_step_on_cpu_matches_the_op_chain():
    """``build_train_step`` with JAX's defaults (fused loss, fused tail)
    on the CPU: the loss falls, two builds repeat bitwise, and the losses
    stay within rtol 1e-5 of the unfused step with the Adam op chain."""
    cfg = dataclasses.replace(TCFG, vocab_size=64)
    runs = []
    for _ in range(2):
        step, _, opt, _, _ = build_train_step(cfg, 2, 32, device="cpu")
        assert opt.use_fused
        runs.append([float(step()) for _ in range(5)])
    assert runs[0] == runs[1] and runs[0][-1] < runs[0][0]
    step, *_ = build_train_step(dataclasses.replace(cfg, fused_loss=False),
                                2, 32, device="cpu", fused_tail="off")
    np.testing.assert_allclose(runs[0], [float(step()) for _ in range(5)],
                               rtol=1e-5)
