"""``contrib.sparsity`` (ASP) on the CPU, the port against apex_tpu.

The same numpy-seeded tensors go through JAX's and the port's
``create_mask`` (bitwise, ties included: zeros and repeated bf16
magnitudes), ASP's mask trees over a GPT tree converted from JAX's (the
stacked layers and per-head-interleaved QKV kept), the channel-permutation
search (the same permutation, mask and magnitudes) and three steps of
the ASP-wrapped optimizer (the port's ``FusedAdam`` against JAX's wrapped
``optax.adam``: params within 1e-5, pruned slots exactly 0 on both).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from apex_tpu.contrib.sparsity import ASP as JASP
from apex_tpu.contrib.sparsity import create_mask as jax_create_mask
from apex_tpu.contrib.sparsity import permutation as jperm
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch.contrib.sparsity import ASP, create_mask
from apex_tpu_torch.contrib.sparsity import permutation as pperm
from apex_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers._common import tree_leaves


def _tied(seed, shape, dtype):
    """Values with many ties: zeros, a few repeated magnitudes of both
    signs, and random bf16-rounded values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    pick = rng.random(shape)
    x[pick < 0.2] = 0.0
    x[(pick >= 0.2) & (pick < 0.35)] = 0.5
    x[(pick >= 0.35) & (pick < 0.45)] = -0.5
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern,shape", [("m4n2_1d", (16, 32)),
                                           ("m4n2_1d", (3, 8, 64)),
                                           ("m4n2_2d", (12, 16)),
                                           ("m8n4_1d", (6, 48)),
                                           ("m4n1_1d", (5, 20))])
def test_create_mask_bitwise_jax_with_ties(dtype, pattern, shape):
    x = _tied(sum(shape), shape, dtype)
    want = np.asarray(jax_create_mask(jnp.asarray(x), pattern))
    got = create_mask(tensor_from_numpy(x, torch.device("cpu")), pattern)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_create_mask_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="unknown sparsity pattern"):
        create_mask(torch.zeros(4, 8), "m4n2")
    with pytest.raises(ValueError, match="not divisible"):
        create_mask(torch.zeros(4, 6), "m4n2_1d")
    with pytest.raises(ValueError, match="m4n2_1d"):
        ASP(mask_calculator="m8n4_1d", allow_permutation=True)


JCFG = JGPTConfig(vocab_size=96, max_seq=32, hidden=32, num_layers=2,
                  num_heads=4, dtype=jnp.float32, fused_loss=False)


def _gpt_pair():
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_gpt_masks_equal_jax():
    """ASP's default whitelist over the GPT tree: the same leaves masked
    (None elsewhere) and every mask bitwise JAX's; apply_masks zeroes the
    same slots, in place or not."""
    jp, pp = _gpt_pair()
    jmasks = JASP().compute_sparse_masks(jp)
    masks = ASP().compute_sparse_masks(pp)
    jflat = jax.tree_util.tree_flatten_with_path(
        jmasks, is_leaf=lambda x: x is None)[0]
    count = 0
    for path, jm in jflat:
        node = masks
        for k in path:
            node = node[k.key]
        if jm is None:
            assert node is None, path
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(jm))
            count += 1
    assert count >= 6
    japplied = JASP.apply_masks(jp, jmasks)
    applied = ASP.apply_masks(pp, masks)
    for a, b in zip(tree_leaves(applied), jax.tree.leaves(japplied)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    same = ASP.apply_masks(pp, masks, in_place=True)
    for a, b in zip(tree_leaves(same), tree_leaves(applied)):
        assert torch.equal(a, b)


def test_permute_and_mask_equal_jax():
    """The greedy channel search: the same permutation, mask and base /
    best magnitudes as JAX's; the permuted mask keeps no less magnitude
    than the aligned one."""
    rng = np.random.default_rng(7)
    m = (rng.standard_normal((64, 32)) * rng.choice([0.1, 1.0, 3.0],
                                                    (64, 32))
         ).astype(np.float32)
    jmask, jp, jbase, jbest = jperm.permute_and_mask(m, escape_attempts=3,
                                                     seed=2)
    mask, perm, base, best = pperm.permute_and_mask(m, escape_attempts=3,
                                                    seed=2)
    np.testing.assert_array_equal(perm, jp)
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert base == jbase and best == jbest and best >= base
    # a tensor goes through the same search
    tmask = pperm.permute_and_mask(torch.from_numpy(m), 3, seed=2)[0]
    np.testing.assert_array_equal(tmask, mask)
    assert pperm.magnitude_after_2_4(m) == jperm.magnitude_after_2_4(m)


def test_asp_with_permutation_masks_equal_jax():
    jp, pp = _gpt_pair()
    jm = JASP(allow_permutation=True,
              permutation_escape_attempts=1).compute_sparse_masks(
        {"w": jp["layers"]["fc1_kernel"][0]})
    pm = ASP(allow_permutation=True,
             permutation_escape_attempts=1).compute_sparse_masks(
        {"w": pp["layers"]["fc1_kernel"][0]})
    np.testing.assert_array_equal(pm["w"].numpy(), np.asarray(jm["w"]))


def test_pruned_optimizer_matches_jax_wrapped_adam():
    """Three steps of ASP-wrapped Adam (the port's FusedAdam, JAX's
    optax.adam) on a masked tree with the same numpy gradients: params
    within 1e-5 of JAX's, every pruned slot exactly 0 after every step on
    both sides; restore_pruned_weights gives the dense copy back."""
    rng = np.random.default_rng(3)
    shapes = {"a": {"kernel": (16, 32)}, "b": {"kernel": (2, 8, 12),
                                               "bias": (12,)}}
    tree = {g: {k: rng.standard_normal(s).astype(np.float32)
                for k, s in d.items()} for g, d in shapes.items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    dense = {g: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
             for g, d in tree.items()}
    params = {g: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
              for g, d in tree.items()}
    jasp, asp = JASP(), ASP()
    jmasks = jasp.compute_sparse_masks(jparams)
    masks = asp.compute_sparse_masks(params)
    assert masks["b"]["bias"] is None
    jparams = JASP.apply_masks(jparams, jmasks)
    asp.apply_masks(params, masks, in_place=True)
    tx = jasp.init_optimizer_for_pruning(optax.adam(1e-2), jmasks)
    jstate = tx.init(jparams)
    leaves = tree_leaves(params)
    opt = asp.init_optimizer_for_pruning(FusedAdam(leaves, lr=1e-2),
                                         masks, params)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, g in zip(leaves, jax.tree.leaves(grads)):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, jpv in zip(leaves, jax.tree.leaves(jparams)):
            np.testing.assert_allclose(p.numpy(), np.asarray(jpv),
                                       atol=1e-5, rtol=1e-5)
        for g in ("a", "b"):
            m = masks[g]["kernel"]
            assert not params[g]["kernel"][~m].any(), (step, g)
            assert not np.asarray(jparams[g]["kernel"])[~m.numpy()].any()
    back = asp.restore_pruned_weights(params, dense, in_place=True)
    for a, b in zip(tree_leaves(back), tree_leaves(dense)):
        assert torch.equal(a, b)
