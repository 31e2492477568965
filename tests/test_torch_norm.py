"""apex_tpu_torch's LayerNorm / RMSNorm (``ops.layer_norm``) and the
``normalization`` modules on the CPU, against apex_tpu.

The same numpy inputs go through the JAX function and its port. The JAX
side runs as its own tests run it (``tests/test_ops.py``): ``rms_norm`` /
``layer_norm`` with ``use_pallas=True`` (the Pallas kernels B #1-4 in
interpret mode), its flax modules as they are. The port runs on CPU
tensors, so inside JAX's gate its wrappers take the kernels' plain
PyTorch versions; the CUDA kernels are held against those on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerances (JAX's own, ``tests/test_ops.py``): fp32 forward 1e-5,
gradients 2e-4, anything with a bf16 input or output 3e-2. The backward
kernels' partition (``_bwd_plan``) and a plain emulation of their sum
order (``norm_bwd_split_reference``) are held here too: the emulation
against JAX's backward kernels at fp32 1e-5 (atol and rtol: the same
fp32 terms added in another order).
"""

import functools
import importlib
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from apex_tpu import normalization as jnorm

from apex_tpu_torch import normalization as pnorm
from apex_tpu_torch.contrib.layer_norm import FastLayerNorm, fast_layer_norm
from apex_tpu_torch.convert import norm_state_from_numpy, tensor_from_numpy
from apex_tpu_torch.ops import _kernel_util as ku

# ``ops.layer_norm`` is also a function name in both packages' ``ops``
jln = importlib.import_module("apex_tpu.ops.layer_norm")
pln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

FWD_TOL, GRAD_TOL, BF16_TOL = 1e-5, 2e-4, 3e-2
# (x, weight) types: fp32/fp32, bf16/bf16, bf16 x with an fp32 weight
TYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("bfloat16", "float32")]


def _np(t):
    return t.detach().float().numpy()


def _case(seed, rows, hidden, xt, wt):
    """numpy inputs; bf16 ones rounded in JAX, so both sides see the same
    bits."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, hidden)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(hidden)).astype(np.float32)
    b = (0.2 * rng.standard_normal(hidden)).astype(np.float32)
    dy = rng.standard_normal((rows, hidden)).astype(np.float32)
    cast = lambda a, t: np.asarray(jnp.asarray(a).astype(t))
    return cast(x, xt), cast(w, wt), cast(b, wt), cast(dy, xt)


def _tol(*types):
    return BF16_TOL if "bfloat16" in types else None


def _port(a):
    return tensor_from_numpy(a, torch.device("cpu"))


def _through(y, name):
    """Whether ``y``'s autograd graph holds a node of class ``name``."""
    todo, seen = [y.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        if fn.__class__.__name__ == name:
            return True
        todo += [f for f, _ in fn.next_functions]
    return False


@pytest.mark.parametrize("xt,wt", TYPES)
def test_rms_norm_matches_jax_kernel(xt, wt):
    """y and (dx, dw) of the port's ``rms_norm`` (plain versions inside
    the gate, through ``RMSNormAffine``) vs ``jax.vjp`` of JAX's
    interpret-mode kernels; y and dx in x's type, dw in the weight's."""
    x, w, _, dy = _case(1, 16, 256, xt, wt)
    y_j, vjp = jax.vjp(lambda x, w: jln.rms_norm(x, w, use_pallas=True),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    xl, wl = _port(x).requires_grad_(), _port(w).requires_grad_()
    y = pln.rms_norm(xl, wl)
    assert _through(y, "RMSNormAffineBackward")
    y.backward(_port(dy))
    assert y.dtype == xl.dtype and xl.grad.dtype == xl.dtype
    assert wl.grad.dtype == wl.dtype
    fwd, grad = _tol(xt) or FWD_TOL, _tol(xt, wt) or GRAD_TOL
    np.testing.assert_allclose(_np(y), np.asarray(y_j, np.float32),
                               atol=fwd)
    np.testing.assert_allclose(_np(xl.grad), np.asarray(dx_j, np.float32),
                               atol=grad)
    np.testing.assert_allclose(_np(wl.grad), np.asarray(dw_j, np.float32),
                               atol=grad, rtol=grad)


@pytest.mark.parametrize("xt,wt", TYPES)
def test_rms_plain_versions_match_jax_kernels(xt, wt):
    """The plain versions of the two kernels against JAX's kernels called
    alone (``_rms_fwd`` and ``_rms_norm_affine_bwd``, interpret mode): y,
    the fp32 rstd, dx and dw, from the same saved rstd."""
    x, w, _, dy = _case(2, 32, 384, xt, wt)
    y_j, rstd_j = jln._rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-5)
    y, rstd = pln.rms_norm_fwd_reference(_port(x), _port(w), 1e-5)
    assert rstd.dtype == torch.float32 and rstd.shape == (32,)
    np.testing.assert_allclose(_np(rstd), np.asarray(rstd_j)[:, 0],
                               rtol=FWD_TOL)
    np.testing.assert_allclose(_np(y), np.asarray(y_j, np.float32),
                               atol=_tol(xt) or FWD_TOL)
    dx_j, dw_j = jln._rms_norm_affine_bwd(
        1e-5, (jnp.asarray(x), jnp.asarray(w), rstd_j), jnp.asarray(dy))
    dx, dw = pln.rms_norm_bwd_reference(
        _port(dy), _port(x), _port(np.asarray(rstd_j)[:, 0]), _port(w))
    assert dx.dtype == _port(x).dtype and dw.dtype == _port(w).dtype
    tol = _tol(xt, wt) or GRAD_TOL
    np.testing.assert_allclose(_np(dx), np.asarray(dx_j, np.float32),
                               atol=tol)
    np.testing.assert_allclose(_np(dw), np.asarray(dw_j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("xt,wt", [("bfloat16", "float32"),
                                   ("float32", "float32")])
def test_layer_norm_mixed_types_match_jax_kernel(xt, wt):
    """LayerNorm with a bf16 x and an fp32 weight (what JAX's
    ``FusedLayerNorm`` gives a bf16 model): y and dx in bf16, dw/db in
    fp32, against JAX's interpret-mode kernels; fp32 beside it."""
    x, w, b, dy = _case(3, 24, 256, xt, wt)
    y_j, vjp = jax.vjp(
        lambda x, w, b: jln.layer_norm(x, w, b, use_pallas=True),
        *(jnp.asarray(a) for a in (x, w, b)))
    grads_j = vjp(jnp.asarray(dy))
    leaves = [_port(a).requires_grad_() for a in (x, w, b)]
    y = pln.layer_norm(*leaves)
    assert _through(y, "LayerNormAffineBackward")
    y.backward(_port(dy))
    assert y.dtype == leaves[0].dtype
    fwd, grad = _tol(xt) or FWD_TOL, _tol(xt, wt) or GRAD_TOL
    np.testing.assert_allclose(_np(y), np.asarray(y_j, np.float32),
                               atol=fwd)
    for leaf, want, name in zip(leaves, grads_j, "xwb"):
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(_np(leaf.grad),
                                   np.asarray(want, np.float32), atol=grad,
                                   rtol=grad, err_msg=name)


def test_layer_norm_outside_the_gate_is_the_reference(monkeypatch):
    """(5, 100) fails JAX's gate (rows % 8, hidden % 128): the port's
    dispatch takes the reference, as JAX's does, on every device — the
    kernels' autograd function is never reached — with JAX's result."""
    x, w, b, _ = _case(4, 5, 100, "float32", "float32")

    def refuse(*a):
        raise AssertionError("took the kernels' path")

    monkeypatch.setattr(pln.LayerNormAffine, "apply", refuse)
    monkeypatch.setattr(pln.RMSNormAffine, "apply", refuse)
    leaves = [_port(a).requires_grad_() for a in (x, w, b)]
    got = pln.layer_norm(*leaves)
    assert torch.equal(got, pln.layer_norm_reference(*leaves))
    np.testing.assert_allclose(
        _np(got), np.asarray(jln.layer_norm(*(jnp.asarray(a)
                                              for a in (x, w, b)))),
        atol=FWD_TOL)
    got = pln.rms_norm(*leaves[:2])
    np.testing.assert_allclose(
        _np(got), np.asarray(jln.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=FWD_TOL)


@pytest.mark.parametrize("rows", [1, 5, 8, 24, 64, 250, 256, 1024, 4096])
def test_norm_gate_matches_jax(rows):
    """``_pick_block_rows`` and ``_pallas_ok`` equal JAX's (with
    ``allow_interpret=True``) across row counts and widths, the VMEM
    budget's edge (37,376 takes 8-row blocks, 37,504 none) included."""
    for hidden in (64, 100, 128, 768, 4096, 12288, 16384, 37376, 37504):
        assert (pln._pick_block_rows(rows, hidden)
                == jln._pick_block_rows(rows, hidden)), hidden
        assert (pln._pallas_ok(rows, hidden)
                == jln._pallas_ok(rows, hidden, allow_interpret=True)), hidden


@pytest.mark.parametrize("fn", ["layer_norm", "rms_norm"])
def test_use_pallas_true_outside_the_gate_raises_like_jax(fn):
    """JAX's ``ValueError``, word for word; ``use_pallas=False`` is the
    reference inside the gate too."""
    x = np.ones((5, 100), np.float32)
    w = np.ones(100, np.float32)
    args = (w, w) if fn == "layer_norm" else (w,)
    with pytest.raises(ValueError) as want:
        getattr(jln, fn)(jnp.asarray(x), *map(jnp.asarray, args),
                         use_pallas=True)
    with pytest.raises(ValueError) as got:
        getattr(pln, fn)(_port(x), *map(_port, args), use_pallas=True)
    assert str(got.value) == str(want.value)
    x8 = _port(np.ones((8, 128), np.float32)).requires_grad_()
    w8 = _port(np.ones(128, np.float32)).requires_grad_()
    y = getattr(pln, fn)(x8, *([w8] * len(args)), use_pallas=False)
    assert not _through(y, "LayerNormAffineBackward")
    assert not _through(y, "RMSNormAffineBackward")


def test_rms_norm_non_affine_is_the_reference():
    """No weight: the reference on every device, as JAX (``:367-368``),
    with JAX's result, the gate's raise still checked first."""
    x, _, _, _ = _case(5, 16, 256, "float32", "float32")
    got = pln.rms_norm(_port(x))
    assert torch.equal(got, pln.rms_norm_reference(_port(x)))
    np.testing.assert_allclose(
        _np(got), np.asarray(jln.rms_norm(jnp.asarray(x))), atol=FWD_TOL)
    with pytest.raises(ValueError, match="pallas rms_norm"):
        pln.rms_norm(_port(x[:5]), use_pallas=True)


MODULES = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


@pytest.mark.parametrize("xt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODULES)
def test_normalization_modules_match_jax(name, xt):
    """Each module with the flax module's params (perturbed from their
    ones/zeros init) carried over by ``norm_state_from_numpy``, on a
    (2, 8, 256) batch: the output vs the JAX module's and vs JAX's
    interpret-mode kernel with the same params; the x and param
    gradients vs ``jax.grad`` through the JAX module. fp32 params, as
    JAX makes them."""
    rng = np.random.default_rng(6)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 8, 256)) * 2 + 0.3,
                               dtype=xt))
    dy = np.asarray(jnp.asarray(rng.standard_normal((2, 8, 256)), xt))
    jmod = getattr(jnorm, name)(256)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    inner = params["params"]
    assert all(v.dtype == np.float32 for v in inner.values())
    inner["scale"] = (inner["scale"]
                      + 0.3 * rng.standard_normal(256)).astype(np.float32)
    if "bias" in inner:
        inner["bias"] = (0.2 * rng.standard_normal(256)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda p, x: jmod.apply(p, x), params, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(dy))
    rms = "RMS" in name
    w = jnp.asarray(inner["scale"])
    kern = (jln.rms_norm(jnp.asarray(x), w, use_pallas=True) if rms else
            jln.layer_norm(jnp.asarray(x), w, jnp.asarray(inner["bias"]),
                           use_pallas=True))

    mod = getattr(pnorm, name)(256, device="cpu")
    mod.load_state_dict(norm_state_from_numpy(params, "cpu"))
    assert mod.weight.dtype == torch.float32
    assert (mod.bias is None) == rms
    xl = _port(x).requires_grad_()
    y = mod(xl)
    y.backward(_port(dy))
    assert y.dtype == xl.dtype and y.shape == xl.shape
    fwd, grad = _tol(xt) or FWD_TOL, _tol(xt) or GRAD_TOL
    for want in (y_j, kern):
        np.testing.assert_allclose(_np(y), np.asarray(want, np.float32),
                                   atol=fwd)
    np.testing.assert_allclose(_np(xl.grad), np.asarray(gx_j, np.float32),
                               atol=grad)
    for key, leaf in (("scale", mod.weight), ("bias", mod.bias)):
        if leaf is not None:
            np.testing.assert_allclose(
                _np(leaf.grad), np.asarray(gp_j["params"][key]), atol=grad,
                rtol=grad, err_msg=key)


@pytest.mark.parametrize("name", ["FusedLayerNorm", "FusedRMSNorm"])
def test_normalization_modules_take_a_shape_tuple(name):
    """``normalized_shape`` (4, 64) normalizes the last two dims as one
    hidden axis of 256, as JAX's ``__call__`` reshapes; non-affine
    modules have no parameters and match JAX's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    for affine in (True, False):
        jmod = getattr(jnorm, name)((4, 64), elementwise_affine=affine)
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        mod = getattr(pnorm, name)((4, 64), elementwise_affine=affine,
                                   device="cpu")
        assert len(list(mod.parameters())) == (
            0 if not affine else 1 if "RMS" in name else 2)
        np.testing.assert_allclose(
            _np(mod(_port(x))), np.asarray(jmod.apply(params,
                                                      jnp.asarray(x))),
            atol=FWD_TOL)


def test_modules_default_to_the_card_and_aliases():
    """Entry points run on the card unless asked for the CPU; the contrib
    names are the normalization ones; ``norm_state_from_numpy`` refuses a
    tree that is not a norm module's."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pnorm.FusedRMSNorm(8)
    assert FastLayerNorm is pnorm.FusedLayerNorm
    assert fast_layer_norm is pln.layer_norm
    assert pnorm.rms_norm is pln.rms_norm
    with pytest.raises(ValueError, match="norm module"):
        norm_state_from_numpy({"kernel": np.ones(3)}, "cpu")


def test_cpu_tensors_take_the_plain_versions():
    """Inside the gate a CPU tensor runs the plain versions: no launch
    counted, no CUDA wrapper reached; the kernel wrappers refuse CPU
    tensors."""
    x = torch.randn(16, 256, requires_grad=True)
    w = torch.ones(256, requires_grad=True)
    before = ku.launch_counts()
    pln.rms_norm(x, w).sum().backward()
    pln.layer_norm(x, w, w).sum().backward()
    assert ku.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        pln.rms_norm_fwd(x.detach(), w.detach())


# ---------------------------------------------------------------------------
# the backward's partition and sum order (csrc/layer_norm.cu)

# the shapes the card runs (chip_smoke's layer_norm_bwd and norm phases):
# GPT-2's training rows, T5-small's encoder and decoder rows, GPT-3's width
BWD_SHAPES = [(8192, 768), (4096, 512), (1024, 512), (2048, 12288)]


@pytest.mark.parametrize("rows,hidden", BWD_SHAPES)
def test_bwd_plan_is_the_shapes_and_its_partials_are_small(rows, hidden):
    """The partition is a function of (rows, hidden) alone, covers every
    row once and every column, fits a block (<= 256 threads) and a
    portable cluster, and the workspace it sizes (fp32 dw and db rows) is
    under 10 % of a bf16 LayerNorm backward's bound bytes (dy and x read,
    dx written, the vectors and statistics)."""
    assert list(inspect.signature(pln._bwd_plan).parameters) == [
        "rows", "hidden"]
    plan = pln._bwd_plan(rows, hidden)
    assert plan == pln._bwd_plan(rows, hidden)
    assert plan.rows_per_part * plan.parts >= rows
    assert plan.rows_per_part * (plan.parts - 1) < rows
    assert plan.teams * plan.team_warps * 32 <= 256
    assert plan.cluster == 1 or plan.teams == 1
    assert 1 <= plan.cluster <= 8 and 1 <= plan.chunks <= 3
    assert plan.chunks * plan.cluster * plan.team_warps * 32 * 8 >= hidden
    x = torch.empty(rows, hidden, dtype=torch.bfloat16)
    got_plan, work = pln._workspace(x, 2)
    assert got_plan == plan and work.dtype == torch.float32
    bound = 3 * rows * hidden * 2 + 3 * hidden * 2 + 8 * rows
    assert work.numel() * 4 < 0.1 * bound
    # wide rows take a cluster, each block a slice of the columns
    assert (plan.cluster > 1) == (hidden > 6144)


@pytest.mark.parametrize("hidden", range(128, 37377, 128))
def test_bwd_plan_takes_every_width_the_gate_admits(hidden):
    """Every hidden % 128 up to 37,376 (the widest JAX's gate admits, at
    8-row blocks) has a partition within the kernel's limits."""
    plan = pln._bwd_plan(8, hidden)
    assert 1 <= plan.cluster <= 8 and 1 <= plan.chunks <= 3
    assert plan.teams * plan.team_warps <= 8
    assert plan.chunks * plan.cluster * plan.team_warps * 32 * 8 >= hidden
    # no chunk is left to a thread past the row's end but the last's
    assert (plan.chunks - 1) * plan.cluster * plan.team_warps * 32 * 8 \
        < hidden


def _jax_norm_bwd(kind, x, w, dy, mean, rstd):
    """JAX's backward kernel (``_ln_bwd_kernel`` / ``_rms_bwd_kernel``)
    in interpret mode over the whole input: JAX's row block where its
    gate admits the shape (as ``_layer_norm_affine_bwd`` launches it),
    else one block of all the rows. dw/db cast to the weight's type."""
    rows, hidden = x.shape
    block = jln._pick_block_rows(rows, hidden) or rows
    row_spec = pl.BlockSpec((block, hidden), lambda i: (i, 0))
    col_spec = pl.BlockSpec((block, 1), lambda i: (i, 0))
    vec_spec = pl.BlockSpec((1, hidden), lambda i: (0, 0))
    sds = jax.ShapeDtypeStruct
    stats = ([jnp.asarray(mean)[:, None]] if kind == "ln" else []) + [
        jnp.asarray(rstd)[:, None]]
    kernel = jln._ln_bwd_kernel if kind == "ln" else jln._rms_bwd_kernel
    nvec = 2 if kind == "ln" else 1
    outs = pl.pallas_call(
        functools.partial(kernel, hidden=hidden),
        grid=(rows // block,),
        in_specs=[row_spec, row_spec] + [col_spec] * len(stats) + [vec_spec],
        out_specs=[row_spec] + [vec_spec] * nvec,
        out_shape=[sds((rows, hidden), x.dtype)]
        + [sds((1, hidden), jnp.float32)] * nvec,
        interpret=True,
    )(jnp.asarray(dy), jnp.asarray(x), *stats, jnp.asarray(w)[None, :])
    return [np.asarray(outs[0], np.float32)] + [
        np.asarray(o.reshape(-1).astype(w.dtype), np.float32)
        for o in outs[1:]]


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("xt,wt", TYPES)
@pytest.mark.parametrize("rows,hidden", [
    (40, 256),     # three parts: the last holds 8 of its 16 rows
    (1, 128), (7, 128),   # one part, most of its teams idle
    (24, 384),     # 48 chunks: a second chunk on half the lanes
    (16, 768),     # one warp a row at its widest (3 chunks a lane)
    (8, 896),      # two warps a row
    (8, 6272),     # past one block's 8 warps: a cluster of two
])
def test_norm_bwd_sum_order_matches_jax_kernel(kind, xt, wt, rows, hidden):
    """The plain emulation of the backward kernels' sum order (parts,
    teams, slices) against JAX's backward kernel in interpret mode on the
    same numpy inputs and saved statistics: dx, dw (and db); fp32 within
    1e-5, bf16 within the tolerance the tests above state."""
    x, w, _, dy = _case(rows + hidden, rows, hidden, xt, wt)
    xp = _port(x)
    if kind == "ln":
        _, mean, rstd = pln.layer_norm_fwd_reference(xp, _port(w))
    else:
        mean = None
        _, rstd = pln.rms_norm_fwd_reference(xp, _port(w))
    got = pln.norm_bwd_split_reference(_port(dy), xp, mean, rstd, _port(w))
    assert len(got) == (3 if kind == "ln" else 2)
    assert got[0].dtype == xp.dtype and got[1].dtype == _port(w).dtype
    want = _jax_norm_bwd(kind, x, w, dy,
                         None if mean is None else mean.numpy(),
                         rstd.numpy())
    tol = _tol(xt, wt) or 1e-5
    for g, wnt, name in zip(got, want, ("dx", "dw", "db")):
        np.testing.assert_allclose(_np(g), wnt, atol=tol, rtol=tol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the forward's geometry and sum order (csrc/layer_norm.cu)

# small widths the wrapper takes beside the gate's: fp32 ones that are not
# a multiple of 8 (4, 100) and a two-warp team off the 128 grid
FWD_SMALL_WIDTHS = [4, 8, 100, 136, 8 * 97]


@pytest.mark.parametrize(
    "hidden", FWD_SMALL_WIDTHS + list(range(128, 37377, 128)))
def test_fwd_plan_takes_every_width_the_gate_admits(hidden):
    """The forward's geometry is a function of hidden alone (the same
    answer twice), its teams cover every 4-column chunk of the row exactly
    once and stay within a block's limits: <= 1,024 threads, <= 6 chunks a
    thread in teams of <= 16 warps (at least 4 in a team of several warps),
    <= 12 in one wide team, eight warps a block of narrow teams."""
    assert list(inspect.signature(pln._fwd_plan).parameters) == ["hidden"]
    plan = pln._fwd_plan(hidden)
    assert plan == pln._fwd_plan(hidden)
    threads = plan.team_warps * 32
    assert plan.teams * threads <= 1024
    if plan.team_warps == 1:
        assert 1 <= plan.chunks <= 6 and plan.teams == 8
    elif plan.team_warps <= 16:
        assert 4 <= plan.chunks <= 6
        assert plan.teams * plan.team_warps <= 8 or plan.teams == 1
    else:
        assert plan.teams == 1 and 4 <= plan.chunks <= 12
        assert hidden > 16 * 32 * 6 * 4
    units = hidden // pln._FWD_UNIT
    owned = (np.arange(threads)[:, None]
             + np.arange(plan.chunks)[None, :] * threads).ravel()
    owned = np.sort(owned[owned < units])
    np.testing.assert_array_equal(owned, np.arange(units))
    # the fewest warps at the chunk cap, and no thread past the row but
    # in its last chunk
    assert (plan.chunks - 1) * threads < units
    if 1 < plan.team_warps <= 16:
        assert (plan.team_warps - 1) * 32 * 6 < units


def test_fwd_plan_is_one_warp_up_to_gpt2s_width():
    """GPT-2's 768 columns: one warp of 6 chunks, eight teams a block;
    T5-small's 512: one warp of 4; GPT-3's 12,288: 16 warps of 6; the
    widest gated row, 37,376: one team of 30 warps of 10."""
    assert pln._fwd_plan(768) == pln.FwdPlan(1, 8, 6)
    assert pln._fwd_plan(512) == pln.FwdPlan(1, 8, 4)
    assert pln._fwd_plan(12288) == pln.FwdPlan(16, 1, 6)
    assert pln._fwd_plan(37376) == pln.FwdPlan(30, 1, 10)
    with pytest.raises(ValueError, match="chunks of 4"):
        pln._fwd_plan(49152 + 8)


def _jax_norm_fwd(kind, x, w, b):
    """JAX's forward kernel (``_ln_fwd_kernel`` / ``_rms_fwd_kernel``) in
    interpret mode over the whole input, one block of all the rows (JAX's
    row block where its gate admits the shape: the kernel is per row).
    Returns y (fp32), then mean and rstd (or rstd) of shape (rows,)."""
    rows, hidden = x.shape
    block = jln._pick_block_rows(rows, hidden) or rows
    row_spec = pl.BlockSpec((block, hidden), lambda i: (i, 0))
    col_spec = pl.BlockSpec((block, 1), lambda i: (i, 0))
    vec_spec = pl.BlockSpec((1, hidden), lambda i: (0, 0))
    sds = jax.ShapeDtypeStruct
    nstats = 2 if kind == "ln" else 1
    kernel = functools.partial(
        jln._ln_fwd_kernel if kind == "ln" else jln._rms_fwd_kernel,
        eps=1e-5, hidden=hidden)
    vecs = [jnp.asarray(w)[None, :]] + (
        [jnp.asarray(b)[None, :]] if kind == "ln" else [])
    outs = pl.pallas_call(
        kernel,
        grid=(rows // block,),
        in_specs=[row_spec] + [vec_spec] * len(vecs),
        out_specs=[row_spec] + [col_spec] * nstats,
        out_shape=[sds((rows, hidden), x.dtype)]
        + [sds((rows, 1), jnp.float32)] * nstats,
        interpret=True,
    )(jnp.asarray(x), *vecs)
    return [np.asarray(outs[0], np.float32)] + [
        np.asarray(o)[:, 0] for o in outs[1:]]


FWD_TYPES = TYPES + [("float32", "bfloat16")]
# widths reaching each branch of the plan: one warp at its narrowest (one
# chunk) and widest (6 chunks), a two-warp team, GPT-3's 16-warp team, a
# wide team (30 warps of 10), and fp32 widths that are not a multiple of 8
FWD_ORDER_CASES = [
    (rows, hidden, xt, wt)
    for rows, hidden in ((8, 128), (16, 768), (8, 896), (4, 12288),
                         (2, 37376), (3, 100), (5, 4))
    for xt, wt in FWD_TYPES
    if hidden % 8 == 0 or xt == "float32"]


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("rows,hidden,xt,wt", FWD_ORDER_CASES)
def test_norm_fwd_sum_order_matches_jax_kernel(kind, rows, hidden, xt, wt):
    """The plain emulation of the forward kernel's sum order (a thread's
    chunks, the warp's xor tree, the team's warps) against JAX's forward
    kernel in interpret mode on the same numpy inputs: y, mean and rstd in
    every (x, weight) type pair; the fp32 statistics within 1e-5, y within
    1e-5 in fp32 and the tolerance above with a bf16 input or output."""
    x, w, b, _ = _case(rows * 7 + hidden, rows, hidden, xt, wt)
    got = pln.norm_fwd_split_reference(_port(x), _port(w), _port(b),
                                       rms=kind == "rms")
    assert len(got) == (3 if kind == "ln" else 2)
    assert got[0].dtype == _port(x).dtype
    assert all(t.dtype == torch.float32 and t.shape == (rows,)
               for t in got[1:])
    want = _jax_norm_fwd(kind, x, w, b)
    tol = _tol(xt, wt) or FWD_TOL
    np.testing.assert_allclose(_np(got[0]), want[0], atol=tol, rtol=tol,
                               err_msg="y")
    for g, wnt, name in zip(got[1:], want[1:], ("mean", "rstd")
                            if kind == "ln" else ("rstd",)):
        np.testing.assert_allclose(_np(g), wnt, atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_norm_fwd_split_reference_is_row_count_invariant(kind):
    """The emulated order holds a row's bits whatever rows share its call:
    8 rows alone equal the same rows inside a 64-row call, bitwise."""
    x, w, b, _ = _case(9, 64, 896, "float32", "float32")
    rms = kind == "rms"
    full = pln.norm_fwd_split_reference(_port(x), _port(w), _port(b),
                                        rms=rms)
    part = pln.norm_fwd_split_reference(_port(x[24:32]), _port(w), _port(b),
                                        rms=rms)
    for a, c in zip(full, part):
        assert torch.equal(a[24:32], c)
