"""``reparameterization`` (weight norm) and ``_autocast_utils`` on the CPU,
the port against apex_tpu: the decomposition's g (JAX's fp32 norm over
every dim but ``dim``, cast to the weight's type) and the recomposed
weight within 1e-6 (fp32; bf16 bitwise, one rounding of the same fp32
value), their gradients within 1e-5; the autocast helpers' types and
casts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import _autocast_utils as jac
from apex_tpu import reparameterization as jrep

from apex_tpu_torch import _autocast_utils as pac
from apex_tpu_torch import reparameterization as prep
from apex_tpu_torch.convert import params_from_numpy


def _tree():
    rng = np.random.default_rng(0)
    return {"dense": {"kernel": rng.standard_normal((6, 4)),
                      "bias": rng.standard_normal(4)},
            "conv": {"kernel": rng.standard_normal((3, 3, 2, 5))},
            "scale": rng.standard_normal((4,))}


def _to(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [0, -1])
def test_weight_norm_matches_jax(dtype, dim):
    jt = _to(_tree(), getattr(jnp, dtype))
    pt = params_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    jw, pw = jrep.apply_weight_norm(jt, dim=dim), \
        prep.apply_weight_norm(pt, dim=dim)
    assert set(pw["dense"]["kernel"]) == {"wn_g", "wn_v"}
    assert torch.is_tensor(pw["dense"]["bias"]) and torch.is_tensor(
        pw["scale"])
    tol = 1e-6 if dtype == "float32" else 0
    for path in (("dense", "kernel"), ("conv", "kernel")):
        jg, pg = jw, pw
        for k in path:
            jg, pg = jg[k], pg[k]
        np.testing.assert_allclose(pg["wn_g"].float().numpy(),
                                   np.asarray(jg["wn_g"], np.float32),
                                   rtol=tol, atol=tol)
        assert pg["wn_g"].dtype == pg["wn_v"].dtype
    jr, pr = jrep.remove_weight_norm(jw, dim=dim), \
        prep.remove_weight_norm(pw, dim=dim)
    for a, b in zip(jax.tree.leaves(jr), jax.tree.leaves(pr)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=tol,
                                   atol=tol)


def test_weight_norm_gradients_match_jax():
    """d(sum(w · c)) by g and v through remove_weight_norm."""
    jt = _to(_tree(), jnp.float32)
    jw = jrep.apply_weight_norm(jt, name_filter=lambda p: "kernel" in p)
    c = np.random.default_rng(1).standard_normal((6, 4)).astype(np.float32)

    def jloss(w):
        return jnp.sum(jrep.remove_weight_norm(w)["dense"]["kernel"] * c)

    jg = jax.grad(jloss)(jw)["dense"]["kernel"]
    pw = prep.apply_weight_norm(
        params_from_numpy(jax.tree.map(np.asarray, jt), "cpu"),
        name_filter=lambda p: "kernel" in p)
    assert set(pw["dense"]) == {"kernel", "bias"}
    g, v = pw["dense"]["kernel"]["wn_g"], pw["dense"]["kernel"]["wn_v"]
    g.requires_grad_()
    v.requires_grad_()
    w = prep.remove_weight_norm(pw)["dense"]["kernel"]
    (w * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg["wn_g"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg["wn_v"]),
                               atol=1e-5, rtol=1e-5)


def test_autocast_utils_match_jax():
    assert [str(t).split(".")[1] for t in pac._get_autocast_dtypes()] == \
        [jnp.dtype(t).name for t in jac._get_autocast_dtypes()]
    assert pac._get_current_dtype() == torch.bfloat16
    assert jnp.dtype(jac._get_current_dtype()).name == "bfloat16"
    assert pac._get_current_dtype(torch.float16) == torch.float16
    x = np.random.default_rng(2).standard_normal(5).astype(np.float32)
    i = np.arange(3)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        got = pac._cast_if_autocast_enabled(torch.from_numpy(x),
                                            torch.from_numpy(i), "s", 2.0,
                                            dtype=dt)
        want = jac._cast_if_autocast_enabled(jnp.asarray(x), jnp.asarray(i),
                                             "s", 2.0, dtype=jdt)
        assert got[0].dtype == dt and got[1].dtype == torch.int64
        assert got[2:] == ("s", 2.0) and want[2:] == ("s", 2.0)
        np.testing.assert_array_equal(got[0].float().numpy(),
                                      np.asarray(want[0], np.float32))
