"""``models`` (ResNet, DCGAN) and ``parallel.sync_batchnorm``'s one-device
path on the CPU, the port against apex_tpu.

flax variables (params and ``batch_stats``) from JAX's ``init`` are
carried into the port modules by ``convert.module_from_numpy`` (conv
kernels HWIO -> OIHW, transposed-conv kernels flipped); the same numpy
inputs go through both. fp32 throughout. Tolerances: outputs and running
statistics within 1e-5 (atol) + 1e-5 (rtol), the ResNets' logits within
1e-4 (atol: ``LOGIT_ATOL``); gradients within 1e-4 + 1e-4 of the largest
|gradient| of the leaf (PyTorch's CPU convs sum in another order than
XLA's, and BatchNorm divides those differences by a batch's std).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu.models import Discriminator as JDisc
from apex_tpu.models import Generator as JGen
from apex_tpu.models import ResNet18 as JResNet18
from apex_tpu.models import ResNet50 as JResNet50
from apex_tpu.models.resnet import make_norm as jmake_norm
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JSyncBN

from apex_tpu_torch import amp
from apex_tpu_torch.convert import (module_from_numpy, module_to_flax,
                                    param_tree)
from apex_tpu_torch.models import (Discriminator, Generator, ResNet18,
                                   ResNet50, make_norm)
from apex_tpu_torch.models.layers import (ConvTranspose, conv_transpose_pads,
                                          max_pool_same, same_pads)
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm, convert_syncbn_model, create_syncbn_process_group,
    sync_batch_stats)

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=1e-5, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _close_tree(got, want, scale_tol=None, what=""):
    """Leaf by leaf over flax's nested trees; with ``scale_tol`` each
    leaf within that fraction of its largest |value|."""
    gf = jax.tree_util.tree_flatten_with_path(got)[0]
    wf = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(gf) == len(wf), what
    for path, g in gf:
        w = np.asarray(wf[path], np.float32)
        if scale_tol is None:
            _close(g, w, what=f"{what} {jax.tree_util.keystr(path)}")
        else:
            tol = scale_tol * max(float(np.abs(w).max()), 1e-12)
            _close(g, w, atol=tol, rtol=scale_tol,
                   what=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# SyncBatchNorm


@pytest.mark.parametrize("affine,track", [(True, True), (False, True),
                                          (True, False)])
def test_sync_batchnorm_train_eval_and_running_stats(affine, track):
    """Two training calls then an eval call: outputs, the running mean and
    the unbiased running var (m / (m - 1)) as JAX's module on one device
    (``axis_name=None``); gradients of x, scale and bias."""
    rng = np.random.default_rng(0)
    x1 = (rng.standard_normal((4, 5, 3, 6)) * 3 + 1).astype(np.float32)
    x2 = rng.standard_normal((4, 5, 3, 6)).astype(np.float32)
    jm = JSyncBN(momentum=0.2, eps=1e-3, affine=affine,
                 track_running_stats=track, axis_name=None)
    var = jm.init(jax.random.PRNGKey(0), x1)
    if affine:
        var = {**var, "params": {"scale": jnp.asarray(1 + rng.random(6),
                                                      jnp.float32),
                                 "bias": jnp.asarray(rng.random(6),
                                                     jnp.float32)}}
    pm = SyncBatchNorm(6, momentum=0.2, eps=1e-3, affine=affine,
                       track_running_stats=track, axis_name=None,
                       device=CPU)
    module_from_numpy(_np(var), pm)
    for x in (x1, x2):
        y, upd = jm.apply(var, x, mutable=["batch_stats"])
        var = {**var, **upd}
        _close(pm(torch.from_numpy(x)).detach(), y)
        _close(pm.mean, var["batch_stats"]["mean"])
        _close(pm.var, var["batch_stats"]["var"])
    _close(pm(torch.from_numpy(x1), use_running_average=True).detach(),
           jm.apply(var, x1, use_running_average=True))
    ct = rng.standard_normal(x1.shape).astype(np.float32)

    def jloss(params, x):
        v = {**var, "params": params} if affine else var
        y, _ = jm.apply(v, x, mutable=["batch_stats"])
        return jnp.sum(y * ct)

    xt = torch.from_numpy(x2).requires_grad_()
    (pm(xt) * torch.from_numpy(ct)).sum().backward()
    gp, gx = jax.grad(jloss, argnums=(0, 1))(var.get("params", {}), x2)
    _close(xt.grad, gx, atol=1e-4, rtol=1e-4)
    if affine:
        _close(pm.scale.grad, gp["scale"], atol=1e-4, rtol=1e-4)
        _close(pm.bias.grad, gp["bias"], atol=1e-4, rtol=1e-4)


def test_sync_batch_stats_and_groups_match_jax():
    from apex_tpu.parallel.sync_batchnorm import (
        create_syncbn_process_group as jgroups,
        sync_batch_stats as jstats)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 5)) + 2).astype(np.float32)
    for got, want in zip(sync_batch_stats(torch.from_numpy(x), (0, 1)),
                         jstats(jnp.asarray(x), (0, 1), None)):
        _close(got, want)
    for size, world in ((2, 8), (0, 4), (4, 4), (3, 6)):
        assert create_syncbn_process_group(size, world) == jgroups(size,
                                                                    world)
    with pytest.raises(ValueError, match="must divide"):
        create_syncbn_process_group(3, 8)


def test_named_axis_raises_naming_a7():
    """A named mesh axis (JAX's default ``"dp"`` included) was refused,
    naming ROADMAP A7, until the cross-device statistics were ported
    (A7a). Now the module, the statistics, the factory, the default
    ResNet and the converter take it, and — as JAX's axis name is unbound
    outside a mesh program — the statistics raise while no mesh is
    installed. The cross-device behaviour itself:
    ``tests/test_torch_syncbn_dist.py``."""
    from apex_tpu_torch.parallel.mesh import get_mesh

    assert get_mesh(required=False) is None
    x = torch.zeros(2, 4)
    bn = SyncBatchNorm(4, device=CPU)
    assert bn.axis_name == "dp"
    with pytest.raises(RuntimeError, match="no mesh is installed"):
        bn(x)
    with pytest.raises(RuntimeError, match="no mesh is installed"):
        sync_batch_stats(x, (0,), "dp")
    assert make_norm(sync_bn=True)(4, device=CPU).axis_name == "dp"
    net = ResNet18(num_classes=10, width=8, device=CPU)   # JAX's default norm
    with pytest.raises(RuntimeError, match="no mesh is installed"):
        net(torch.zeros(1, 32, 32, 3))
    conv = convert_syncbn_model(torch.nn.BatchNorm2d(3))
    assert isinstance(conv, SyncBatchNorm) and conv.axis_name == "dp"


def test_convert_syncbn_model_replaces_batchnorm_recursively():
    """``nn.BatchNorm*`` submodules become one-device SyncBatchNorms over
    channel-first input, weights and running statistics carried across;
    the output is BatchNorm2d's in training (the same batch statistics)
    and in eval (the same running ones)."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              torch.nn.Sequential(torch.nn.BatchNorm2d(4),
                                                  torch.nn.ReLU()))
    bn = net[1][0]
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    x = torch.randn(2, 3, 8, 8)
    conv = convert_syncbn_model(copy.deepcopy(net), axis_name=None)
    sbn = conv[1][0]
    assert isinstance(sbn, SyncBatchNorm) and not sbn.channel_last
    assert isinstance(conv[1][1], torch.nn.ReLU)
    torch.testing.assert_close(sbn.mean, bn.running_mean)
    torch.testing.assert_close(sbn.var, bn.running_var)
    net.eval()
    torch.testing.assert_close(
        conv[1][1](sbn(conv[0](x), use_running_average=True)), net(x),
        atol=1e-5, rtol=1e-5)
    net.train()
    torch.testing.assert_close(conv(x), net(x), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the layers' padding


def test_lax_padding_rules():
    """lax's SAME padding, the odd pixel on the high side: 7x7/2 on 224
    pads (2, 3), 3x3/2 on 56 (0, 1); the transposed conv's (before,
    after) padding as lax computes it."""
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    from jax._src.lax.convolution import _conv_transpose_padding
    for k, s, pad in ((4, 2, "SAME"), (4, 1, "VALID"), (3, 2, "SAME"),
                      (5, 3, "SAME"), (4, 2, "VALID")):
        assert conv_transpose_pads(k, s, pad) == \
            _conv_transpose_padding(k, s, pad)
    x = np.random.default_rng(2).standard_normal((2, 7, 9, 3)).astype(
        np.float32)
    import flax.linen as nn
    _close(max_pool_same(torch.from_numpy(x), 3, 2),
           nn.max_pool(jnp.asarray(x), (3, 3), (2, 2), padding="SAME"))


@pytest.mark.parametrize("k,s,pad,size", [(4, 2, "SAME", 5),
                                          (4, 1, "VALID", 1),
                                          (3, 2, "SAME", 4)])
def test_conv_transpose_matches_flax(k, s, pad, size):
    """flax's ConvTranspose (no kernel flip) against the port's
    (``F.conv_transpose2d`` on the flipped kernel)."""
    import flax.linen as nn
    rng = np.random.default_rng(k + s)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jm = nn.ConvTranspose(5, (k, k), (s, s), padding=pad, use_bias=False)
    var = jm.init(jax.random.PRNGKey(0), x)
    pm = ConvTranspose(3, 5, (k, k), s, pad, use_bias=False, device=CPU)
    module_from_numpy(_np(var), pm)
    _close(pm(torch.from_numpy(x)).detach(), jm.apply(var, x))


# ---------------------------------------------------------------------------
# ResNet


# ResNet50 trained on batch statistics is ill-conditioned at this size:
# each norm's E[x^2] - E[x]^2 over 8-512 samples a channel cancels, and
# the two frameworks' sum orders (a few ulps of a var) grow through its 16
# blocks to 1.4e-3 of the logits and up to 27 % of a gradient leaf
# (measured; JAX's own fp32 and fp64 runs agree only because both sum
# their norms in fp32 in one order). Its training logits, loss and running
# statistics are held to LOGIT_ATOL / STATS_TOL, its gradients in eval
# mode (the running statistics: the norms affine). ResNet18's hold in
# training at 1e-4.
LOGIT_ATOL = {"resnet18": 1e-4, "resnet50": 5e-3}
STATS_TOL = {"resnet18": None, "resnet50": 1e-3}   # of each leaf's max


def _resnet_pair(arch, jarch):
    norm_j = jmake_norm(sync_bn=False)
    jm = jarch(num_classes=10, width=8, norm=norm_j)
    x = np.random.default_rng(3).standard_normal((8, 32, 32, 3)).astype(
        np.float32)
    var = jm.init(jax.random.PRNGKey(1), x, use_running_average=False)
    pm = arch(num_classes=10, width=8, norm=make_norm(), device=CPU)
    module_from_numpy(_np(var), pm)
    return jm, var, pm, x


@pytest.mark.parametrize("which", ["resnet18", "resnet50"])
def test_resnet_matches_jax(which):
    """ResNet18 / ResNet50 at width 8, 32 px, batch 8, 10 classes: the
    parameter names are flax's; in training the logits, the loss, the
    updated running statistics and (ResNet18) every gradient leaf as
    JAX's; in eval the logits from the running statistics and (ResNet50)
    every gradient leaf."""
    arch, jarch = {"resnet18": (ResNet18, JResNet18),
                   "resnet50": (ResNet50, JResNet50)}[which]
    jm, var, pm, x = _resnet_pair(arch, jarch)
    assert set(dict(pm.named_parameters())) == set(
        ".".join(k.key for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(var["params"])[0])
    labels = np.arange(8) % 10

    def jloss(params, variables, eval_mode):
        logits, upd = jm.apply({**variables, "params": params}, x,
                               use_running_average=eval_mode,
                               mutable=["batch_stats"])
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(8), labels]), (logits, upd)

    def grads_of(eval_mode):
        for p in pm.parameters():
            p.grad = None
        logits = pm(torch.from_numpy(x), use_running_average=eval_mode)
        loss = torch.nn.functional.cross_entropy(logits,
                                                 torch.from_numpy(labels))
        loss.backward()
        return logits.detach(), loss.detach(), module_to_flax(
            {n: p.grad for n, p in pm.named_parameters()}, pm)

    (jl, (jlogits, jupd)), jg = jax.value_and_grad(jloss, has_aux=True)(
        var["params"], var, False)
    logits, loss, grads = grads_of(False)
    _close(logits, jlogits, atol=LOGIT_ATOL[which])
    _close(loss, jl, atol=LOGIT_ATOL[which])
    if which == "resnet18":
        _close_tree(grads, _np(jg), scale_tol=1e-4, what="grad")
    stats = module_to_flax(dict(pm.named_buffers()), pm)
    _close_tree(stats, _np(jupd["batch_stats"]), scale_tol=STATS_TOL[which],
                what="batch_stats")
    var = {**var, **jupd}
    (jl, (jlogits, _)), jg = jax.value_and_grad(jloss, has_aux=True)(
        var["params"], var, True)
    module_from_numpy(_np(var), pm)   # JAX's running statistics
    logits, loss, grads = grads_of(True)
    _close(logits, jlogits, atol=LOGIT_ATOL[which])
    if which == "resnet50":
        _close_tree(grads, _np(jg), scale_tol=1e-4, what="eval grad")


def test_o2_keeps_the_same_bn_leaves_fp32_as_jax():
    """amp O2 over the ResNet's param tree: the leaves kept fp32 (the
    norm predicate on flax's paths) are JAX's, the rest bf16."""
    jm, var, pm, _ = _resnet_pair(ResNet50, JResNet50)
    jstate, jpol = jamp.initialize(var["params"], "O2")
    jcast = jamp.cast_params(jstate.master_params, jpol,
                             jstate.is_norm_param)
    state, _ = amp.initialize(param_tree(pm), "O2")
    cast = amp.model_params(state)
    jflat = jax.tree_util.tree_flatten_with_path(jcast)[0]
    kept = 0
    for path, leaf in jflat:
        node = cast
        for k in path:
            node = node[k.key]
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert node.dtype == want, jax.tree_util.keystr(path)
        kept += want == torch.float32
    assert 0 < kept < len(jflat)


# ---------------------------------------------------------------------------
# DCGAN


@pytest.mark.parametrize("isize", [16, 32])
def test_dcgan_matches_jax(isize):
    """Generator and Discriminator (flax's BatchNorm: decay 0.99, biased
    running var) at isize 16 and 32, ngf = ndf = 8, nz 12: the image and
    the logits, every gradient leaf of a loss through both, and each
    module's updated batch statistics as JAX's."""
    rng = np.random.default_rng(isize)
    jg = JGen(isize=isize, nz=12, ngf=8)
    jd = JDisc(isize=isize, ndf=8)
    z = rng.standard_normal((3, 1, 1, 12)).astype(np.float32)
    real = rng.uniform(-1, 1, (3, isize, isize, 3)).astype(np.float32)
    gv = jg.init(jax.random.PRNGKey(0), z)
    dv = jd.init(jax.random.PRNGKey(1), real)
    pg = Generator(isize=isize, nz=12, ngf=8, device=CPU)
    pd = Discriminator(isize=isize, ndf=8, device=CPU)
    module_from_numpy(_np(gv), pg)
    module_from_numpy(_np(dv), pd)

    def jloss(gp, dp):
        fake, gu = jg.apply({**gv, "params": gp}, z, mutable=["batch_stats"])
        lf, du = jd.apply({**dv, "params": dp}, fake,
                          mutable=["batch_stats"])
        return jnp.mean(jax.nn.softplus(-lf)), (fake, lf, gu, du)

    (jl, (jfake, jlf, jgu, jdu)), (jgg, jdg) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(gv["params"], dv["params"])
    fake = pg(torch.from_numpy(z))
    lf = pd(fake)
    loss = torch.nn.functional.softplus(-lf).mean()
    loss.backward()
    _close(fake.detach(), jfake)
    _close(lf.detach(), jlf)
    _close(loss.detach(), jl)
    for mod, jgrad, jstats, what in ((pg, jgg, jgu, "G"), (pd, jdg, jdu, "D")):
        grads = module_to_flax({n: p.grad for n, p in mod.named_parameters()},
                               mod)
        _close_tree(grads, _np(jgrad), scale_tol=1e-4, what=f"{what} grad")
        _close_tree(module_to_flax(dict(mod.named_buffers()), mod),
                    _np(jstats["batch_stats"]), what=f"{what} stats")
    # eval: the running statistics
    gv = {**gv, **jgu}
    _close(pg(torch.from_numpy(z), train=False).detach(),
           jg.apply(gv, z, train=False))
