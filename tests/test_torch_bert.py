"""The port's BERT (``transformer/testing/standalone_bert.py``) against
JAX's ``bert_mlm_loss``, on the CPU.

JAX's loss runs as its own tests run GPT's (``tests/test_torch_train.py``):
inside ``jax.shard_map`` on a one-device ``build_mesh(tp=1)`` mesh, its
params converted to the port's tree with ``convert.params_from_numpy``.
Padded calls take the reference attention on both sides (JAX sends a
masked call to its XLA path); unpadded ones the flash path (the port's
plain versions of the kernels here).

Tolerances: fp32 loss rtol 1e-5, every gradient leaf within 1e-5 of its
largest magnitude (sums in other orders); bf16 the repo's bf16 gate
(``chip_smoke.py`` ``bf16_gate``): loss rtol 1e-2, each leaf's |port -
JAX| norm within 5e-2 of its JAX norm (a bf16 output one rounding step
apart runs through every later layer and back; a leaf whose true value is
near zero, such as the key bias's, is all rounding noise element by
element).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel.mesh import build_mesh
from apex_tpu.transformer.testing import BertConfig as JBertConfig
from apex_tpu.transformer.testing import bert_mlm_loss as jax_bert_loss
from apex_tpu.transformer.testing import gpt_param_specs
from apex_tpu.transformer.testing.standalone_bert import (
    init_bert_params as jax_init)

from apex_tpu_torch.convert import named_leaves, params_from_numpy
from apex_tpu_torch.transformer.testing import (BertConfig, bert_forward,
                                                bert_mlm_loss,
                                                init_bert_params,
                                                init_bert_params_numpy)

B, S = 4, 32
SIZES = dict(vocab_size=96, max_seq=S, hidden=64, num_layers=2,
             num_heads=4, remat=False)


def _cfgs(dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (JBertConfig(dtype=jdt, **SIZES),
            BertConfig(dtype=tdt, **SIZES))


def _batch(seed, padded):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, SIZES["vocab_size"], (B, S)).astype(np.int32)
    tgt = rng.integers(0, SIZES["vocab_size"], (B, S)).astype(np.int32)
    lm = (rng.random((B, S)) < 0.15).astype(np.float32)
    lm[:, 0] = 1.0
    types = rng.integers(0, 2, (B, S)).astype(np.int32)
    pad = None
    if padded:
        # a padded tail on half the rows
        lens = np.array([S, S - 9, S, S - 17])
        pad = np.arange(S)[None, :] >= lens[:, None]
        lm = lm * ~pad
    return tok, tgt, lm, types, pad


def _jax_run(jcfg, params, tok, tgt, lm, types, pad):
    mesh = build_mesh(tp=1, pp=1, sp=1)
    specs = gpt_param_specs(jcfg)
    specs["embed"].update(type=P(), ln_w=P(), ln_b=P())
    specs["head"] = {k: P() for k in ("dense_kernel", "dense_bias", "ln_w",
                                      "ln_b")}

    def loss_fn(p):
        def body(p, tok, tgt, lm, tt, pm):
            return jax_bert_loss(p, tok, tgt, lm, jcfg, token_types=tt,
                                 padding_mask=pm)

        return jax.shard_map(body, mesh=mesh,
                             in_specs=(specs, P(), P(), P(), P(), P()),
                             out_specs=P())(
            p, jnp.asarray(tok), jnp.asarray(tgt), jnp.asarray(lm),
            None if types is None else jnp.asarray(types),
            None if pad is None else jnp.asarray(pad))

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax.tree.map(lambda a: np.asarray(a, np.float32), g)


def _port_run(tcfg, params_np, tok, tgt, lm, types, pad):
    params = params_from_numpy(params_np, "cpu", dtype=tcfg.dtype)
    leaves = dict(named_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    t_ = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    loss = bert_mlm_loss(params, t_(tok).long(), t_(tgt).long(), t_(lm),
                         tcfg, token_types=(None if types is None
                                            else t_(types).long()),
                         padding_mask=t_(pad))
    loss.backward()
    # an unused leaf (the type table without token types) has no grad
    return loss.item(), {k: (torch.zeros_like(t) if t.grad is None
                             else t.grad).float().numpy()
                         for k, t in leaves.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("with_types", [False, True])
def test_bert_mlm_loss_and_grads_match_jax(dtype, padded, with_types):
    jcfg, tcfg = _cfgs(dtype)
    params = jax_init(jax.random.PRNGKey(6), jcfg)
    params_np = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tok, tgt, lm, types, pad = _batch(int(padded) + 2 * int(with_types),
                                      padded)
    types = types if with_types else None
    jl, jg = _jax_run(jcfg, params, tok, tgt, lm, types, pad)
    pl, pg = _port_run(tcfg, params_np, tok, tgt, lm, types, pad)
    fp32 = dtype == "float32"
    np.testing.assert_allclose(pl, jl, rtol=1e-5 if fp32 else 1e-2)
    jgl = dict(named_leaves(jg))
    assert sorted(jgl) == sorted(pg)
    for name, want in jgl.items():
        if fp32:
            np.testing.assert_allclose(
                pg[name], want, rtol=0,
                atol=1e-5 * float(np.abs(want).max()), err_msg=name)
        else:
            err = np.linalg.norm(pg[name] - want)
            assert err <= 5e-2 * max(np.linalg.norm(want), 1e-30), name
    if not with_types:
        assert not np.abs(pg["embed.type"]).any()


def test_bert_padding_masks_keys_and_unpadded_takes_flash(monkeypatch):
    """A padded call runs the reference attention (JAX's masked path) and
    its pad keys change no other row's output; an unpadded call takes the
    flash path, non-causal."""
    from apex_tpu_torch.ops import attention as pa
    _, tcfg = _cfgs("float32")
    params = init_bert_params(tcfg, seed=3, device="cpu")
    tok, _, _, _, pad = _batch(5, True)
    calls = []
    real = pa.FlashAttention.apply

    def spy(*a):
        calls.append(a[5])            # causal
        return real(*a)

    monkeypatch.setattr(pa.FlashAttention, "apply", spy)
    tok_t, pad_t = torch.from_numpy(tok).long(), torch.from_numpy(pad)
    with torch.no_grad():
        out = bert_forward(params, tok_t, tcfg, padding_mask=pad_t)
        assert calls == []
        tok2 = tok_t.clone()
        tok2[pad_t] = (tok2[pad_t] + 1) % tcfg.vocab_size
        out2 = bert_forward(params, tok2, tcfg, padding_mask=pad_t)
        assert torch.equal(out[~pad_t], out2[~pad_t])
        bert_forward(params, tok_t, tcfg)
    assert calls == [False] * tcfg.num_layers


def test_bert_numpy_init_layout():
    """The numpy twin's tree: GPT's leaves plus the token-type table, the
    embedding LN and the MLM head, each of JAX's shape."""
    _, tcfg = _cfgs("float32")
    jcfg, _ = _cfgs("float32")
    got = dict(named_leaves(init_bert_params_numpy(tcfg, seed=1)))
    want = dict(named_leaves(jax_init(jax.random.PRNGKey(0), jcfg)))
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert got["embed.type"].shape == (2, SIZES["hidden"])


@pytest.mark.parametrize("field,value", [("megatron_sp", True),
                                         ("num_experts", 4)])
def test_bert_refuses_what_is_multi_device(field, value):
    """Both fields once refused as multi-device now run on one device.
    ``megatron_sp`` (the tensor-parallel slice) gives the plain loss
    bitwise with no mesh (held to JAX at tp > 1 in
    ``tests/test_torch_tp_gpt.py``); ``num_experts`` (the MoE slice) adds
    the router loss, which reaches the router's gradient (held to JAX at
    dp 4 in ``tests/test_torch_moe.py``)."""
    _, tcfg = _cfgs("float32")
    cfg = dataclasses.replace(tcfg, **{field: value})
    params = init_bert_params(tcfg, device="cpu")
    tok = torch.zeros(1, 8, dtype=torch.long)
    if field == "megatron_sp":
        assert torch.equal(
            bert_mlm_loss(params, tok, tok, torch.ones(1, 8), cfg),
            bert_mlm_loss(params, tok, tok, torch.ones(1, 8), tcfg))
        return
    params = init_bert_params(cfg, device="cpu")
    router = params["layers"]["router"].requires_grad_()
    loss = bert_mlm_loss(params, tok, tok, torch.ones(1, 8), cfg)
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())
    assert router.shape == (cfg.num_layers, cfg.hidden, value)
    (g,) = torch.autograd.grad(loss, router)
    assert torch.any(g != 0.0)
