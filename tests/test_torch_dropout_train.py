"""apex_tpu_torch's GPT and T5 training with dropout and the remat policies
on the CPU, against apex_tpu.

The same numpy params and tokens and the same threefry key go through
JAX's ``gpt_loss`` / ``t5_loss`` (inside ``shard_map`` on a tp = 1 mesh,
``value_and_grad``, as ``tests/test_gpt_dropout.py`` and
``tests/test_t5.py`` run them) and the port's. Both rates are 0.2, so the
embedding, attention and residual dropout sites all drop. The port's keys
are JAX's key data, derived on the host; its attention dropout is the
flash kernels' counter hash under JAX's ``attention_dropout_seed``, its
hidden dropout JAX's bernoulli bits (``ops/dropout.py``).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import gpt_param_specs
from apex_tpu.transformer.testing import init_gpt_params as jax_init
from apex_tpu.transformer.testing import standalone_t5 as jt5

from apex_tpu_torch.convert import named_leaves, params_from_numpy
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import dropout as port_dropout
from apex_tpu_torch.transformer.tensor_parallel import fold_in
from apex_tpu_torch.transformer.testing import (GPTConfig, T5Config,
                                                build_t5_train_step,
                                                build_train_step, gpt_loss,
                                                t5_loss)
from apex_tpu_torch.transformer.testing.train import param_leaves

RATES = dict(attention_dropout=0.2, hidden_dropout=0.2)
GPT_SMALL = dict(vocab_size=96, max_seq=32, hidden=64, num_layers=2,
                 num_heads=4, fused_loss=False, **RATES)
T5_SMALL = dict(vocab_size=96, hidden=64, num_heads=4, enc_layers=2,
                dec_layers=2, max_seq_enc=16, max_seq_dec=8,
                relative_position_bias=True, encoder_final_ln=True, **RATES)
B, S, S_ENC, S_DEC = 2, 32, 16, 8
POLICIES = ("full", "dots", "dots_attn")
_JAX = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _trainable(tree):
    params = params_from_numpy(tree, "cpu")
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def _grads(params):
    return dict(named_leaves(jax.tree.map(lambda t: t.grad.clone(),
                                          params)))


def _jax_gpt(policy, key_seed):
    """JAX's loss and grads of the dropout GPT under ``policy`` and
    ``PRNGKey(key_seed)``, with its params and tokens, as numpy; cached."""
    ck = ("gpt", policy, key_seed)
    if ck not in _JAX:
        cfg = JGPTConfig(dtype=jnp.float32, remat_policy=policy, **GPT_SMALL)
        params = jax_init(jax.random.PRNGKey(0), cfg)
        mesh = build_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:1])
        rng = np.random.default_rng(1)
        tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tgt = np.roll(tok, -1, axis=1)
        specs = gpt_param_specs(cfg)

        def loss_fn(p, tok, tgt, key):
            def body(p, tok, tgt, key):
                return jax_gpt_loss(p, tok, tgt, cfg, dropout_key=key)

            return jax.shard_map(body, mesh=mesh,
                                 in_specs=(specs, P(), P(), P()),
                                 out_specs=P())(p, tok, tgt, key)

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, tok, tgt,
                                                       _jkey(key_seed))
        host = lambda tree: jax.tree.map(np.asarray, tree)
        _JAX[ck] = {"params": host(params), "tok": tok, "tgt": tgt,
                    "loss": float(loss), "grads": host(g)}
    return _JAX[ck]


def _port_gpt(run, policy, key, remat=True):
    cfg = GPTConfig(dtype=torch.float32, remat_policy=policy, remat=remat,
                    **GPT_SMALL)
    params = _trainable(run["params"])
    loss = gpt_loss(params, _t(run["tok"]).long(), _t(run["tgt"]).long(),
                    cfg, dropout_key=key)
    loss.backward()
    return loss.item(), _grads(params)


@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_dropout_loss_and_grads_match_jax(policy):
    """Loss and every gradient leaf of the port's ``gpt_loss`` with a
    ``dropout_key`` vs JAX's under the same policy and key, fp32, both
    rates 0.2; the whole-model tolerances of ``tests/test_torch_train.py``:
    loss rtol 1e-5, grads atol 2e-6 + rtol 1e-4."""
    run = _jax_gpt(policy, 42)
    loss, got = _port_gpt(run, policy,
                          np.asarray(_jkey(42)))
    np.testing.assert_allclose(loss, run["loss"], rtol=1e-5)
    want = dict(named_leaves(run["grads"]))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=2e-6,
                                   rtol=1e-4, err_msg=name)


class _CountGemms(TorchDispatchMode):
    """Counts the 2-d products (``aten.mm``) that reach their kernel."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_gpt_policies_agree_bitwise_and_dots_attn_saves_the_forward(
        monkeypatch):
    """The port's ``dots`` and ``dots_attn`` give ``full``'s loss and
    gradients bitwise (with and without remat), and count what they save:
    2 layers run the attention forward 4 times under ``full`` and ``dots``
    (forward and recompute), 2 times under ``dots_attn``, which saves (o,
    lse); ``dots`` and ``dots_attn`` run 6 GEMMs fewer than ``full`` (the
    recompute's qkv, out and fc1 of each layer; fc2's is not replayed
    under any policy: a recompute stops after the last saved input that
    backward reads, here fc2's); the hidden dropout runs 12 times under
    each (forward 5, recompute 2, backward 5)."""
    counts, gemms = {}, {}

    def counting(fn, name):
        def run(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(port_attention, "flash_attention_fwd_reference",
                        counting(port_attention.flash_attention_fwd_reference,
                                 "flash_fwd"))
    monkeypatch.setattr(port_dropout, "hidden_dropout_reference",
                        counting(port_dropout.hidden_dropout_reference,
                                 "dropout"))
    run = _jax_gpt("full", 42)
    key = np.asarray(_jkey(42))
    results = {}
    for policy in POLICIES:
        counts.clear()
        with _CountGemms() as mode:
            results[policy] = _port_gpt(run, policy, key)
        gemms[policy] = mode.mm
        assert counts == {"flash_fwd": 2 if policy == "dots_attn" else 4,
                          "dropout": 12}, (policy, counts)
    assert gemms["dots"] == gemms["dots_attn"] == gemms["full"] - 6, gemms
    counts.clear()
    results["no_remat"] = _port_gpt(run, "full", key, remat=False)
    assert counts == {"flash_fwd": 2, "dropout": 10}
    loss0, g0 = results["full"]
    for name, (loss, g) in results.items():
        assert loss == loss0, name
        for leaf in g0:
            assert torch.equal(g[leaf], g0[leaf]), (name, leaf)


def test_gpt_dropout_key_semantics():
    """The same key gives the same loss, another key another, and no key is
    eval mode: the rates-0 config's loss, bitwise."""
    run = _jax_gpt("full", 42)
    k1, k2 = (np.asarray(k) for k in jax.random.split(_jkey(5)))
    a, _ = _port_gpt(run, "full", k1)
    b, _ = _port_gpt(run, "full", k1)
    c, _ = _port_gpt(run, "full", k2)
    d, _ = _port_gpt(run, "full", None)
    cfg0 = GPTConfig(dtype=torch.float32,
                     **{**GPT_SMALL, "attention_dropout": 0.0,
                        "hidden_dropout": 0.0})
    e = gpt_loss(params_from_numpy(run["params"], "cpu"),
                 _t(run["tok"]).long(), _t(run["tgt"]).long(), cfg0,
                 dropout_key=k1).item()
    assert a == b and a != c and a != d
    assert d == e, "rates 0 with a key and no key both run without dropout"


def test_build_train_step_with_dropout_keys_on_cpu():
    """``train_step(dropout_key)`` on the CPU under ``dots_attn``: the loss
    falls over 6 steps of a fresh key each, repeats bitwise from a second
    build, and a step without a key differs from one with a key."""
    cfg = GPTConfig(dtype=torch.float32, remat_policy="dots_attn",
                    **{**GPT_SMALL, "vocab_size": 64})
    base = np.asarray(_jkey(0))
    runs = []
    for _ in range(2):
        step = build_train_step(cfg, 2, 32, device="cpu")[0]
        runs.append([float(step(fold_in(base, i))) for i in range(6)])
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0] and np.isfinite(runs[0]).all()
    step = build_train_step(cfg, 2, 32, device="cpu")[0]
    assert float(step()) != runs[0][0]


# ---------------------------------------------------------------------------
# T5


def _jax_t5(key_seed):
    ck = ("t5", key_seed)
    if ck not in _JAX:
        cfg = jt5.T5Config(dtype=jnp.float32, **T5_SMALL)
        params = jt5.init_t5_params(jax.random.PRNGKey(0), cfg)
        mesh = build_mesh(tp=1, pp=1, sp=1, devices=jax.devices()[:1])
        specs = jt5.t5_param_specs(cfg)
        rng = np.random.default_rng(1)
        enc = rng.integers(0, cfg.vocab_size, (B, S_ENC)).astype(np.int32)
        dec = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
        tgt = np.roll(dec, -1, axis=1)

        def loss_fn(p, e, d, t, key):
            def body(p, e, d, t, key):
                return jt5.t5_loss(p, e, d, t, cfg, dropout_key=key)

            return jax.shard_map(body, mesh=mesh,
                                 in_specs=(specs, P(), P(), P(), P()),
                                 out_specs=P())(p, e, d, t, key)

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(
            params, enc, dec, tgt, _jkey(key_seed))
        host = lambda tree: jax.tree.map(np.asarray, tree)
        _JAX[ck] = {"params": host(params), "enc": enc, "dec": dec,
                    "tgt": tgt, "loss": float(loss), "grads": host(g)}
    return _JAX[ck]


def _port_t5(run, key, **over):
    cfg = T5Config(dtype=torch.float32, **{**T5_SMALL, **over})
    params = _trainable(run["params"])
    loss = t5_loss(params, *(_t(run[k]).long() for k in ("enc", "dec",
                                                          "tgt")),
                   cfg, dropout_key=key)
    loss.backward()
    return loss.item(), _grads(params)


def test_t5_dropout_loss_and_grads_match_jax():
    """T5 proper (relative bias, final LN, fused loss) with both rates 0.2
    under one key: the port's loss and every gradient leaf vs JAX's; the
    whole-model tolerances of ``tests/test_torch_t5.py``: loss rtol 1e-5,
    grads rtol 5e-4, atol 1e-5."""
    run = _jax_t5(3)
    loss, got = _port_t5(run, np.asarray(_jkey(3)))
    np.testing.assert_allclose(loss, run["loss"], rtol=1e-5)
    want = dict(named_leaves(run["grads"]))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=5e-4,
                                   atol=1e-5, err_msg=name)


def test_t5_dropout_key_semantics_and_remat():
    """Same key same loss, another key another, no key eval mode (the
    rates-0 loss bitwise); remat off gives remat's loss and gradients
    bitwise; ``build_t5_train_step``'s step takes a key and repeats
    bitwise."""
    run = _jax_t5(3)
    k1, k2 = (np.asarray(k) for k in jax.random.split(_jkey(8)))
    a, ga = _port_t5(run, k1)
    b, _ = _port_t5(run, k1)
    c, _ = _port_t5(run, k2)
    d, _ = _port_t5(run, None)
    e, _ = _port_t5(run, k1, attention_dropout=0.0, hidden_dropout=0.0)
    f, gf = _port_t5(run, k1, remat=False)
    assert a == b and a != c and a != d and d == e and a == f
    for leaf in ga:
        assert torch.equal(ga[leaf], gf[leaf]), leaf
    cfg = T5Config(dtype=torch.float32, **T5_SMALL)
    losses = []
    for _ in range(2):
        step = build_t5_train_step(cfg, 2, S_ENC, S_DEC, device="cpu")[0]
        losses.append([float(step(k)) for k in (k1, k2, k1)])
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()


@pytest.mark.parametrize("model", ["gpt", "t5"])
def test_dropout_configs_validate_and_refuse_bad_policy(model):
    """The lifted refusals: rates > 0 and (GPT) every remat policy pass
    ``validate()``; an unknown policy raises ``ValueError``, as in JAX."""
    if model == "gpt":
        for policy in POLICIES:
            GPTConfig(remat_policy=policy, **RATES).validate()
        with pytest.raises(ValueError, match="remat_policy"):
            GPTConfig(remat_policy="bogus").validate()
        with pytest.raises(ValueError, match="remat_policy"):
            JGPTConfig(remat_policy="bogus").validate()
    else:
        T5Config(**RATES).validate()
