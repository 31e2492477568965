"""apex_tpu_torch's training slice on the CPU, against apex_tpu.

The same numpy inputs go through the JAX function and its port. The JAX
side runs as its own tests run it on the CPU: the LayerNorm and flash
attention Pallas kernels in interpret mode (``use_pallas=True``), the
model through the ``shard_map`` + ``value_and_grad`` recipe of
``tests/test_gpt_fused_loss.py`` and ``FusedAdam(fused_tail="off")``. The
port's wrappers take their plain PyTorch versions for CPU tensors; the
CUDA kernels are held against those on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.ops.attention import _fa_fwd
from apex_tpu.ops.attention import _pallas_ok as jax_pallas_ok
from apex_tpu.ops.attention import _pick_block as jax_pick_block
from apex_tpu.ops.attention import attention_dropout_mask as jax_drop_mask
from apex_tpu.ops.attention import flash_attention as jax_flash
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import gpt_param_specs
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.convert import (adam_state_from_numpy, named_leaves,
                                    params_from_numpy)
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops.attention import (attention_dropout_mask,
                                          attention_reference,
                                          flash_attention,
                                          flash_attention_fwd_reference)
from apex_tpu_torch.ops.layer_norm import (layer_norm,
                                           layer_norm_bwd_reference,
                                           layer_norm_fwd_reference)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.testing import (GPTConfig, build_train_step,
                                                gpt_loss)
from apex_tpu_torch.transformer.testing.train import param_leaves


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# LayerNorm backward (B #2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_backward_matches_jax_kernel(dtype):
    """dx, dw, db of the port (its plain backward, and autograd through
    ``layer_norm``) vs ``jax.vjp`` of the JAX Pallas kernels in interpret
    mode. fp32: atol 1e-5 (same formula, summation order differs). bf16:
    one bf16 rounding of each output (rtol 2**-7) plus atol 2e-3 for the
    dw/db sums over 32 rows."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((32, 128)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(128)).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    dy = rng.standard_normal((32, 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw, jb, jdy = (jnp.asarray(a, jdt) for a in (x, w, b, dy))
    y_j, vjp = jax.vjp(lambda x, w, b: jax_layer_norm(x, w, b,
                                                      use_pallas=True),
                       jx, jw, jb)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdy)]

    tx, tw, tb, tdy = (_t(a).to(tdt) for a in (x, w, b, dy))
    _, mean, rstd = layer_norm_fwd_reference(tx, tw, tb)
    plain = layer_norm_bwd_reference(tdy, tx, mean, rstd, tw)
    tx.requires_grad_(), tw.requires_grad_(), tb.requires_grad_()
    y = layer_norm(tx, tw, tb)
    assert y.grad_fn is not None
    y.backward(tdy)
    auto = (tx.grad, tw.grad, tb.grad)
    atol, rtol = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 2 ** -7)
    np.testing.assert_allclose(_np(y), np.asarray(y_j.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
    for got_set in (plain, auto):
        for got, ref, name in zip(got_set, want, ("dx", "dw", "db")):
            assert got.dtype == tdt, name
            np.testing.assert_allclose(_np(got), ref, atol=atol, rtol=rtol,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# flash attention (B #5-7)


def _qkv(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_and_lse_match_jax_kernel(causal):
    """o and lse of the port's plain forward vs the JAX Pallas forward in
    interpret mode at 32-row blocks; atol 2e-5 (o) and 1e-5 (lse)."""
    q, k, v, _ = _qkv(1, 1, 2, 64, 32)
    scale = 1 / np.sqrt(32)
    q3, k3, v3 = (a.reshape(2, 64, 32) for a in (q, k, v))
    o_j, lse_j = _fa_fwd(jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3),
                         scale, causal, 32, 32, interpret=True)
    o, lse = flash_attention_fwd_reference(_t(q3), _t(k3), _t(v3), scale,
                                           causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5)
    front = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(front.numpy(), np.asarray(o_j).reshape(
        q.shape), atol=2e-5)


def test_flash_forward_bf16_matches_jax_kernel():
    """bf16 in and out; p is rounded to bf16 before p @ v in both (the
    port relative to the row max, JAX relative to its running max), so
    atol 3e-2 as the JAX package's own bf16 flash test."""
    q, k, v, _ = _qkv(2, 1, 2, 64, 32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax_flash(*jb, causal=True, use_pallas=True, block_q=32,
                     block_k=32)
    got = flash_attention(*(_t(a).bfloat16() for a in (q, k, v)),
                          causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(
        jnp.float32)), atol=3e-2)


@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.0),
                                         (False, 0.3), (True, 0.25)])
def test_flash_grads_match_jax_kernel(causal, rate):
    """o and dq, dk, dv through the port's ``FlashAttention`` (plain
    versions) vs ``jax.vjp`` of the JAX Pallas kernels (interpret mode,
    32-row blocks), with and without the counter-hash dropout at the same
    seed; atol 2e-5 (o) and 1e-4 (grads, as the JAX package's own flash
    backward test)."""
    q, k, v, do = _qkv(3, 2, 2, 64, 32)
    seed = 1234
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=jnp.int32(seed) if rate else None)
    o_j, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, use_pallas=True, block_q=32, block_k=32, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal, dropout_rate=rate,
                        dropout_seed=seed if rate else None)
    o.backward(_t(do))
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=2e-5)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   err_msg=f"d{name}")


def test_flash_gate_matches_jax():
    """The port's ``_pick_block`` / ``_pallas_ok`` equal JAX's (with
    ``allow_interpret=True``) on a grid of lengths, head dims and causal:
    the shapes where a CUDA tensor takes the flash kernels are exactly the
    ones where JAX takes its Pallas kernel."""
    seqs = (8, 16, 40, 64, 100, 128, 130, 200, 328, 512, 1000, 1024, 2056)
    for seq in seqs:
        for want in (8, 32, 128, 200, 512):
            assert (port_attention._pick_block(seq, want)
                    == jax_pick_block(seq, want)), (seq, want)
    for sq in seqs:
        for sk in seqs:
            for d in (12, 32, 40, 64, 100, 128, 136, 256):
                for causal in (False, True):
                    assert (port_attention._pallas_ok(sq, sk, d, causal)
                            == jax_pallas_ok(sq, sk, d, causal,
                                             allow_interpret=True)), (
                        sq, sk, d, causal)


@pytest.mark.parametrize("sq,sk,d,causal,bias", [
    (200, 328, 40, False, False), (200, 328, 128, False, True),
    (200, 200, 40, True, True), (200, 200, 128, True, False),
    (128, 128, 256, True, True), (64, 136, 192, False, False)])
def test_flash_tail_shapes_and_head_dims_match_jax_kernel(sq, sk, d, causal,
                                                          bias):
    """Lengths that are not multiples of the port's 64-row tile and head
    dims 40 and 128 (the shapes the repaired kernels take on the card):
    o and every gradient, the bias's included, of the port's
    ``flash_attention`` (plain versions) vs ``jax.vjp`` of JAX's
    interpret-mode kernels at one block per sequence; atol 2e-5 (o) and
    1e-4 (grads), as the flash tests above."""
    rng = np.random.default_rng(sq + sk + d)
    q, do = (rng.standard_normal((1, 2, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, sk, d)).astype(np.float32)
            for _ in range(2))
    b = rng.standard_normal((2, sq, sk)).astype(np.float32) if bias else None
    args = [q, k, v] + ([b] if bias else [])

    def jfn(q, k, v, *bb):
        return jax_flash(q, k, v, causal=causal, bias=bb[0] if bb else None,
                         use_pallas=True, block_q=sq, block_k=sk)

    o_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in args]
    o = flash_attention(*leaves[:3], causal=causal,
                        bias=leaves[3] if bias else None)
    o.backward(_t(do))
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=2e-5)
    for got, ref, name in zip(leaves, want, ("q", "k", "v", "bias")):
        np.testing.assert_allclose(_np(got.grad), np.asarray(ref),
                                   atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [136, 192, 256])
def test_head_dims_up_to_256_take_the_kernel_path(monkeypatch, d):
    """JAX's gate takes head_dim 136-256, and so do the port's kernels
    (D = 256 with zeros past d; they have no upper limit): ``flash_attention``
    goes through the flash autograd function (the kernels on CUDA, their
    plain versions here), with JAX's interpret-mode kernel's output (atol
    2e-5)."""
    assert port_attention._flash_route(torch.float32, 4096) == "cuda_core"
    assert jax_pallas_ok(64, 64, d, True, allow_interpret=True)
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 2, 64, d)).astype(np.float32)
               for _ in range(3))
    calls = []
    real = port_attention.FlashAttention.apply

    def count(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(port_attention.FlashAttention, "apply", count)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                     use_pallas=True, block_q=64, block_k=64)
    assert calls == [(2, 64, d)]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("sq,sk,d,causal", [
    (64, 128, 32, True), (100, 100, 32, False), (64, 64, 12, False)])
def test_shapes_jax_sends_to_its_reference_take_the_plain_path(
        monkeypatch, sq, sk, d, causal):
    """Causal with sq != sk, a length that is not a multiple of 8, head_dim
    % 8 != 0: JAX's gate sends these to ``attention_reference``; so does
    the port, on every device (the flash autograd function is never
    reached), with JAX's result (atol 2e-5)."""
    rng = np.random.default_rng(sq * sk + d)
    q = rng.standard_normal((1, 2, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, sk, d)).astype(np.float32)
            for _ in range(2))

    def refuse(*a):
        raise AssertionError("took the flash kernels' path")

    monkeypatch.setattr(port_attention.FlashAttention, "apply", refuse)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("seed,q_off,k_off", [
    (0, 0, 0), (1234, 0, 0), (2 ** 31 - 1, 0, 0), (77, 96, 32),
    (5, 2 ** 20, 3)])
def test_dropout_keep_mask_bitwise_equal_to_jax(seed, q_off, k_off):
    """The port's int64 evaluation of the uint32 counter hash gives
    bitwise JAX's keep mask, offsets included."""
    for rate in (0.1, 0.5):
        want = np.asarray(jax_drop_mask(jnp.int32(seed), rate, 3, 40, 24,
                                        q_off=q_off, k_off=k_off))
        got = attention_dropout_mask(seed, rate, 3, 40, 24, q_off=q_off,
                                     k_off=k_off).numpy()
        assert got.dtype == np.bool_ and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert abs(got.mean() - (1 - rate)) < 0.05


def test_masked_attention_takes_the_reference_path_like_jax():
    """``mask=`` goes to ``attention_reference`` on both sides, dropout
    through the same counter-hash mask; atol 2e-5."""
    q, k, v, _ = _qkv(4, 1, 2, 16, 8)
    mask = np.arange(16)[None, None, None, :] >= 11
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                     mask=jnp.asarray(mask), dropout_rate=0.2,
                     dropout_seed=jnp.int32(9))
    got = flash_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                          dropout_rate=0.2, dropout_seed=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(
        flash_attention(_t(q), _t(k), _t(v), mask=_t(mask)).numpy(),
        attention_reference(_t(q), _t(k), _t(v), mask=_t(mask)).numpy(),
        atol=0)


def test_cross_entropy_matches_torch_and_keeps_logits_dtype():
    """Per-position loss equals ``F.cross_entropy`` in fp32 (atol 1e-5);
    the gradient is (softmax − onehot)·g in the logits' dtype."""
    rng = np.random.default_rng(5)
    logits = _t(rng.standard_normal((2, 5, 33)).astype(np.float32) * 3)
    target = _t(rng.integers(0, 33, (2, 5)))
    lg = logits.clone().requires_grad_()
    loss = vocab_parallel_cross_entropy(lg, target)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 33), target.reshape(-1), reduction="none")
    np.testing.assert_allclose(loss.detach().numpy().reshape(-1),
                               want.numpy(), atol=1e-5)
    loss.sum().backward()
    onehot = torch.nn.functional.one_hot(target, 33).float()
    np.testing.assert_allclose(lg.grad.numpy(), (torch.softmax(
        logits, -1) - onehot).numpy(), atol=1e-6)
    lb = logits.bfloat16().requires_grad_()
    vocab_parallel_cross_entropy(lb, target).mean().backward()
    assert lb.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the model, the optimizer and the train step vs JAX

JCFG = JGPTConfig(vocab_size=96, max_seq=32, hidden=64, num_layers=2,
                  num_heads=4, dtype=jnp.float32, fused_loss=False)
TCFG = GPTConfig(vocab_size=96, max_seq=32, hidden=64, num_layers=2,
                 num_heads=4, dtype=torch.float32, fused_loss=False)
LR = 1e-3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX flagship step (value_and_grad + FusedAdam(fused_tail="off")
    + p + u) on the tiny config: loss and grads at init, then the state
    after one step and the losses/params of three more, all as numpy."""
    params = jax_init(jax.random.PRNGKey(0), JCFG)
    mesh = build_mesh(tp=1, pp=1, sp=1)
    specs = gpt_param_specs(JCFG)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, JCFG.vocab_size, (4, JCFG.max_seq)).astype(
        np.int32)
    tgt = np.roll(tok, -1, axis=1)
    opt = JFusedAdam(lr=LR, fused_tail="off")

    def loss_fn(p, tok, tgt):
        def body(p, tok, tgt):
            return jax_gpt_loss(p, tok, tgt, JCFG)

        return jax.shard_map(body, mesh=mesh, in_specs=(specs, P(), P()),
                             out_specs=P())(p, tok, tgt)

    @jax.jit
    def step(p, s, tok, tgt):
        loss, g = jax.value_and_grad(loss_fn)(p, tok, tgt)
        u, s = opt.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s, loss, g

    host = lambda tree: jax.tree.map(np.asarray, tree)
    out = {"params0": host(params), "tok": tok, "tgt": tgt}
    p, s, loss, g = step(params, opt.init(params), tok, tgt)
    out.update(loss0=float(loss), grads0=host(g), params1=host(p),
               state1=host(s))
    losses = []
    for _ in range(3):
        p, s, loss, _ = step(p, s, tok, tgt)
        losses.append(loss.item())
    out.update(losses=losses, params4=host(p))
    return out


def _trainable(tree):
    params = params_from_numpy(tree, "cpu")
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


@pytest.mark.parametrize("remat", [True, False])
def test_gpt_loss_and_grads_match_jax(jax_run, remat):
    """Loss and every gradient leaf of the port's ``gpt_loss`` (fp32,
    ``fused_loss=False``) vs JAX ``value_and_grad`` of its ``gpt_loss``
    from the same params and tokens; loss rtol 1e-5, grads atol 2e-6 +
    rtol 1e-4 (fp32, summation order differs)."""
    params = _trainable(jax_run["params0"])
    cfg = dataclasses.replace(TCFG, remat=remat)
    loss = gpt_loss(params, _t(jax_run["tok"]).long(),
                    _t(jax_run["tgt"]).long(), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["loss0"], rtol=1e-5)
    got = dict(named_leaves(jax.tree.map(lambda t: t.grad.numpy(), params)))
    want = dict(named_leaves(jax_run["grads0"]))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-6,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_fused_adam_matches_jax(adam_w_mode, weight_decay):
    """Two updates of the port's FusedAdam vs JAX ``FusedAdam(fused_tail=
    "off")`` (both decay modes, with and without decay): params and fp32
    moments within rtol 1e-6, atol 1e-8 (one fp32 op chain each)."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal(16).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree) for _ in range(2)]
    jopt = JFusedAdam(lr=LR, weight_decay=weight_decay,
                      adam_w_mode=adam_w_mode, fused_tail="off")
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    params = _trainable(tree)
    opt = FusedAdam(param_leaves(params), lr=LR, weight_decay=weight_decay,
                    adam_w_mode=adam_w_mode, fused_tail="off")
    for g in grads:
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, u)
        for p, (_, gl) in zip(param_leaves(params), named_leaves(g)):
            p.grad = _t(gl)
        opt.step()
    assert opt.param_groups[0]["step"] == int(js.count) == 2
    for (name, want), p in zip(named_leaves(jax.tree.map(np.asarray, jp)),
                               param_leaves(params)):
        np.testing.assert_allclose(_np(p), want, rtol=1e-6, atol=1e-8,
                                   err_msg=name)
    for key, jtree in (("exp_avg", js.mu), ("exp_avg_sq", js.nu)):
        host = jax.tree.map(np.asarray, jtree)
        for (name, want), p in zip(named_leaves(host), param_leaves(params)):
            np.testing.assert_allclose(_np(opt.state[p][key]), want,
                                       rtol=1e-6, atol=1e-10,
                                       err_msg=f"{key}{name}")


def test_three_train_steps_match_jax(jax_run):
    """From the JAX params and FusedAdam state after one step (carried
    over by ``params_from_numpy`` + ``adam_state_from_numpy``), three port
    steps give JAX's losses (rtol 1e-5) and final params within atol
    lr/100 (Adam's step is lr·m/sqrt(v) for every element, so where a
    gradient is tiny its fp32 summation order moves the step by a fraction
    of lr) + rtol 1e-5."""
    params = _trainable(jax_run["params1"])
    opt = FusedAdam(param_leaves(params), lr=LR, fused_tail="off")
    adam_state_from_numpy(jax_run["state1"], params, opt)
    assert opt.param_groups[0]["step"] == 1
    tok, tgt = _t(jax_run["tok"]).long(), _t(jax_run["tgt"]).long()
    losses = []
    for _ in range(3):
        opt.zero_grad(set_to_none=True)
        loss = gpt_loss(params, tok, tgt, TCFG)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    got = dict(named_leaves(jax.tree.map(_np, params)))
    for name, want in named_leaves(jax_run["params4"]):
        np.testing.assert_allclose(got[name], want, atol=LR / 100,
                                   rtol=1e-5, err_msg=name)


def test_build_train_step_on_cpu_falls_and_repeats():
    """The flagship step at a tiny size on the CPU: tgt is tok rolled by
    one, the loss falls over 5 steps, and two builds from one seed give
    bitwise equal losses."""
    cfg = dataclasses.replace(TCFG, vocab_size=64)
    runs = []
    for _ in range(2):
        step, params, opt, tok, tgt = build_train_step(cfg, 2, 32,
                                                       device="cpu")
        assert torch.equal(tgt, torch.roll(tok, -1, dims=1))
        runs.append([float(step()) for _ in range(5)])
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]
    assert all(np.isfinite(runs[0]))


# ported since the dropout slice: accepted now, the rest still refused (A7)
ACCEPTED_FIELDS = ("remat_policy", "attention_dropout", "hidden_dropout")


@pytest.mark.parametrize("field,value", [
    ("remat_policy", "dots"), ("remat_policy", "dots_attn"),
    ("attention_dropout", 0.1),
    ("hidden_dropout", 0.1), ("megatron_sp", True), ("overlap_comm", True),
    ("num_experts", 4), ("remat_policy", "bogus")])
def test_refused_training_fields_raise(field, value):
    """Each refused field raises ``NotImplementedError`` from
    ``validate()``, ``gpt_loss`` and ``build_train_step``; an unknown
    ``remat_policy`` raises ``ValueError`` there, as JAX's ``validate``.
    The fields ported since (the remat policies, both dropout rates) are
    accepted: ``validate()`` passes and ``gpt_loss`` and a
    ``build_train_step`` step run on the CPU with a dropout key."""
    cfg = dataclasses.replace(TCFG, **{field: value})
    tok = torch.zeros(1, 4, dtype=torch.long)
    if field in ACCEPTED_FIELDS and value != "bogus":
        cfg.validate()
        key = np.asarray(jax.random.PRNGKey(1))
        params = _trainable(jax.tree.map(np.asarray, jax_init(
            jax.random.PRNGKey(0), JCFG)))
        loss = gpt_loss(params, tok, tok, cfg, dropout_key=key)
        loss.backward()
        assert np.isfinite(loss.item())
        step = build_train_step(cfg, 1, 4, device="cpu")[0]
        assert np.isfinite(float(step(key)))
        return
    err = ValueError if value == "bogus" else NotImplementedError
    with pytest.raises(err, match=field):
        cfg.validate()
    with pytest.raises(err, match=field):
        gpt_loss({}, tok, tok, cfg)
    with pytest.raises(err, match=field):
        build_train_step(cfg, 1, 4, device="cpu")


def test_refused_optimizer_and_attention_options_raise():
    p = [torch.zeros(3, requires_grad=True)]
    for kw, fused in (({}, True), ({"fused_tail": "auto"}, True),
                      ({"fused_tail": "on"}, True),
                      ({"fused_tail": "off"}, False)):
        assert FusedAdam(p, **kw).use_fused == fused   # JAX default "auto"
    with pytest.raises(ValueError, match="fused_tail"):
        FusedAdam(p, fused_tail="always")
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)
    q = torch.zeros(1, 1, 8, 8)
    # the bias must be batch-shared (heads, sq, sk), as JAX checks it
    with pytest.raises(ValueError, match="heads, sq, sk"):
        flash_attention(q, q, q, bias=torch.zeros(2, 2, 8, 8))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, dropout_rate=0.1)
