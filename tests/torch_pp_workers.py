"""Rank functions of the port's pipeline-parallel tests
(``tests/test_torch_pipeline_{parallel,gpt,dropout}.py``,
``tests/test_torch_enc_dec_pipeline.py``).

Each runs in a process that ``apex_tpu_torch.parallel.multiproc.spawn``
started, as one rank of a ``gloo`` group, and returns host tensors; the
test compares them with JAX in the pytest process. This module imports
torch, numpy and the port only (a spawned rank never imports JAX); every
result of :func:`several` carries ``jax_loaded``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

HID = 8
KEEP = 0.8


def several(rank, world, calls):
    """Each ``(function name, args)`` of this module in turn, in one group
    (one spawn for a file's cases at a world size) -> their results by
    name, and ``jax_loaded``."""
    mod = sys.modules[__name__]
    out = {name: getattr(mod, fn)(rank, world, *args)
           for name, (fn, args) in calls.items()}
    out["jax_loaded"] = any(m in sys.modules for m in
                            ("jax", "jaxlib", "flax", "apex_tpu"))
    return out


def _t(a, requires_grad=False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(requires_grad)


def _mesh(tp=1, pp=1, sp=1, vp=None, split=None):
    from apex_tpu_torch.transformer import parallel_state

    parallel_state.destroy_model_parallel()
    return parallel_state.initialize_model_parallel(tp, pp, vp, sp, split)


def _host(tree):
    from apex_tpu_torch.optimizers._common import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


# ---------------------------------------------------------------------------
# the toy specs of JAX's tests (HID 8)


def toy_spec(aux: bool = False, dropout: bool = False):
    """JAX's toy ``PipelineSpec``: a linear embedding, ``tanh(h @ w +
    b)`` stages, a squared-error head. ``aux``: the stage also returns
    ``mean(out**2)``; ``dropout``: the embedding and stage drop with
    ``bernoulli(fold_in(key, 1 | 2), KEEP)`` (JAX's threefry bits)."""
    from apex_tpu_torch.transformer.pipeline_parallel import PipelineSpec
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        bernoulli,
        fold_in,
    )

    def keep(key, salt, shape):
        return torch.from_numpy(bernoulli(fold_in(key, salt), KEEP, shape))

    def loss_fn(hp, h, tgt):
        return ((h @ hp["w"] - tgt) ** 2).mean()

    if dropout:
        def embed_fn(ep, x, key):
            return (x * keep(key, 1, tuple(x.shape))) @ ep["w"]

        def stage_fn(sp, h, key):
            return torch.tanh((h * keep(key, 2, tuple(h.shape))) @ sp["w"]
                              + sp["b"])

        return PipelineSpec(embed_fn, stage_fn, loss_fn,
                            takes_dropout_key=True)

    def embed_fn(ep, x):
        return x @ ep["w"]

    def stage_fn(sp, h):
        out = torch.tanh(h @ sp["w"] + sp["b"])
        return (out, (out ** 2).mean()) if aux else out

    return PipelineSpec(embed_fn, stage_fn, loss_fn, stage_aux=aux)


def toy_enc_dec_spec():
    """JAX's toy ``EncDecPipelineSpec``: the decoder stage cross-attends
    to the encoder memory with one head."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        EncDecPipelineSpec,
    )

    def enc_embed_fn(ep, x):
        return x @ ep["we"]

    def enc_stage_fn(sp, h):
        return torch.tanh(h @ sp["w"] + sp["b"])

    def dec_embed_fn(ep, x):
        return x @ ep["wd"]

    def dec_stage_fn(sp, h, mem):
        att = torch.softmax((h @ sp["wq"]) @ (mem @ sp["wk"]).transpose(1, 2)
                            / np.sqrt(np.float32(HID)), dim=-1)
        return torch.tanh(h @ sp["w"] + att @ (mem @ sp["wv"]) + sp["b"])

    def loss_fn(hp, h, tgt):
        return ((h @ hp["w"] - tgt) ** 2).mean()

    return EncDecPipelineSpec(enc_embed_fn, enc_stage_fn, dec_embed_fn,
                              dec_stage_fn, loss_fn)


def _driver(kind):
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as s

    return {"1f1b": s.forward_backward_pipelining_without_interleaving,
            "interleaved": s.forward_backward_pipelining_with_interleaving,
            "enc_dec": s.forward_backward_pipelining_enc_dec}[kind]


def schedules(rank, world, cases):
    """Each case ``name: dict(spec, kind, pp, vp, tp, sp, M, params,
    batch, loss_scale, key, data_spec, specs)`` (``spec`` a name of this
    module's spec builders or a GPT / T5 config, ``params`` JAX's global
    tree as numpy) through the port's driver on this rank's local tree:
    ``(loss, grads, coords)``, the grads this rank's local tree, coords
    its mesh coordinates."""
    from apex_tpu_torch.convert import pipeline_params_from_numpy
    from apex_tpu_torch.transformer.tensor_parallel.utils import P

    out = {}
    for name, c in cases.items():
        mesh = _mesh(tp=c.get("tp", 1), pp=c["pp"], sp=c.get("sp", 1),
                     vp=c.get("vp"))
        spec, specs = _spec_of(c)
        params = pipeline_params_from_numpy(c["params"], "cpu", specs=specs)
        kw = dict(num_microbatches=c["M"])
        if c.get("vp"):
            kw["virtual_pipeline_size"] = c["vp"]
        if c.get("loss_scale") is not None:
            kw["loss_scale"] = torch.tensor(c["loss_scale"])
        if c.get("key") is not None:
            kw["dropout_key"] = c["key"]
        if c.get("data_spec") is not None:
            kw["data_spec"] = P(*c["data_spec"])
        if c.get("remat") is not None:
            kw["remat"] = c["remat"]
        batch = tuple(_t(a) for a in c["batch"])
        loss, grads = _driver(c["kind"])(spec, params, batch, **kw)
        coords = {a: mesh.index(a) for a in mesh.axis_names}
        out[name] = (loss.detach(), _host(grads), coords)
    return out


def head_calls(rank, world, cases):
    """Each case (as :func:`schedules` takes them) run again with its
    ``loss_fn`` counted: ``(calls on this rank, its pp index, pp)``."""
    import dataclasses

    from apex_tpu_torch.convert import pipeline_params_from_numpy

    out = {}
    for name, c in cases.items():
        mesh = _mesh(tp=c.get("tp", 1), pp=c["pp"], sp=c.get("sp", 1),
                     vp=c.get("vp"))
        spec, specs = _spec_of(c)
        calls = []

        def counted(*args, _loss=spec.loss_fn):
            calls.append(1)
            return _loss(*args)
        spec = dataclasses.replace(spec, loss_fn=counted)
        params = pipeline_params_from_numpy(c["params"], "cpu", specs=specs)
        kw = dict(num_microbatches=c["M"])
        if c.get("vp"):
            kw["virtual_pipeline_size"] = c["vp"]
        _driver(c["kind"])(spec, params, tuple(_t(a) for a in c["batch"]),
                           **kw)
        out[name] = (len(calls), mesh.index("pp"), c["pp"])
    return out


def _toy_specs(params, vp):
    """A toy tree's specs: None (the stage axis only) unless interleaved,
    then the stage groups' ``[vp, pp, ...]`` axes."""
    from apex_tpu_torch.optimizers._common import tree_map
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        stage_params_spec,
    )
    from apex_tpu_torch.transformer.tensor_parallel.utils import P

    if not vp:
        return None
    return {k: stage_params_spec(v, interleaved=True) if k.endswith("stages")
            else tree_map(lambda _: P(), v) for k, v in params.items()}


def _spec_of(c):
    """The case's spec and its params' specs tree (None: the stage axis
    only)."""
    from apex_tpu_torch.transformer import testing as tt

    spec = c["spec"]
    toys = {"toy": toy_spec, "toy_aux": lambda: toy_spec(aux=True),
            "toy_dropout": lambda: toy_spec(dropout=True),
            "toy_enc_dec": toy_enc_dec_spec}
    if isinstance(spec, str):
        return toys[spec](), _toy_specs(c["params"], c.get("vp"))
    model, fields = spec
    if model == "gpt":
        cfg = tt.GPTConfig(dtype=torch.float32, **fields)
        return (tt.gpt_pipeline_spec(cfg, dropout=c.get("key") is not None),
                tt.gpt_pipeline_specs_tree(cfg, interleaved=bool(c.get("vp"))))
    cfg = tt.T5Config(dtype=torch.float32, **fields)
    return (tt.t5_enc_dec_spec(cfg, dropout=c.get("key") is not None),
            tt.t5_pipeline_specs_tree(cfg))


# ---------------------------------------------------------------------------
# p2p, keys, dispatch, split ranks


P2P_NAMES = ("send_forward_recv_forward", "send_backward_recv_backward",
             "send_forward", "recv_forward", "send_backward",
             "recv_backward", "send_forward_recv_backward",
             "send_backward_recv_forward")


def p2p(rank, world, pp, tp, x, xs, cot):
    """The eight p2p names on this rank's block of ``x`` (a ``[pp·r,
    tp·c]`` grid, rank (p, t) holding block (p, t)) and
    ``scatter_gather=True`` on its pp row of ``xs`` ([pp, n], replicated
    over tp): each result, and the gradient of ``send_forward_recv_
    forward`` (and of the scatter-gather shift) under ``cot``'s block."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p_mod,
    )

    mesh = _mesh(tp=tp, pp=pp)
    p, t = mesh.index("pp"), mesh.index("tp")
    r, c = x.shape[0] // pp, x.shape[1] // tp
    mine = _t(x[p * r:(p + 1) * r, t * c:(t + 1) * c], True)
    out = {"coords": (p, t)}
    for name in P2P_NAMES:
        fn = getattr(p2p_mod, name)
        res = fn(mine, mine) if name in ("send_forward_recv_backward",
                                         "send_backward_recv_forward") \
            else fn(mine)
        out[name] = _host(res)
    y = p2p_mod.send_forward_recv_forward(mine)
    (out["grad_forward"],) = torch.autograd.grad(
        y, mine, _t(cot[p * r:(p + 1) * r, t * c:(t + 1) * c]))
    row = _t(xs[p:p + 1], True)
    sg = p2p_mod.send_forward_recv_forward(row, scatter_gather=True)
    out["scatter_gather"] = sg.detach()
    (out["grad_scatter_gather"],) = torch.autograd.grad(
        sg, row, _t(cot[p:p + 1, :xs.shape[1]]))
    return out


def stage_keys(rank, world, pp, seeds):
    """``pipeline_stage_key(prng_key(s))`` on this rank of a pp mesh."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        pipeline_stage_key,
        prng_key,
    )

    _mesh(pp=pp)
    return [torch.from_numpy(pipeline_stage_key(prng_key(s)).astype(
        np.int64)) for s in seeds]


def dispatch(rank, world):
    """``get_forward_backward_func`` under pp = world, with vp = 2, and
    at pp = 1, by name; and an explicit pp that keeps the installed vp."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_forward_backward_func,
    )

    names = []
    for pp, vp in ((world, None), (world, 2), (1, None)):
        _mesh(pp=pp, vp=vp)
        names.append(get_forward_backward_func().__name__)
    _mesh(pp=world, vp=2)
    names.append(get_forward_backward_func(
        pipeline_model_parallel_size=world).__name__)
    return names


def split_ranks(rank, world):
    """The split-rank bookkeeping at pp = world: accessors, the setter,
    the predicates with and without a split rank, and the refusals."""
    from apex_tpu_torch.transformer import parallel_state as ps

    _mesh(pp=world, split=world // 2)
    out = {"split": ps.get_pipeline_model_parallel_split_rank(),
           "predicates": (ps.is_pipeline_stage_before_split(),
                          ps.is_pipeline_stage_after_split(),
                          ps.is_pipeline_stage_at_split())}
    ps.set_pipeline_model_parallel_split_rank(world + 1)
    out["set"] = ps.get_pipeline_model_parallel_split_rank()
    _mesh(pp=world)
    out["default"] = (ps.is_pipeline_stage_before_split(),
                      ps.is_pipeline_stage_after_split(),
                      ps.is_pipeline_stage_at_split())
    out["refused"] = []
    for split in (world, world + 3):
        try:
            _mesh(pp=world, split=split)
            out["refused"].append(False)
        except ValueError:
            out["refused"].append(True)
    return out


def interleaved_refusal(rank, world, params, batch):
    """The interleaved driver given an encoder-decoder spec: its
    message."""
    from apex_tpu_torch.convert import pipeline_params_from_numpy
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_with_interleaving,
    )

    _mesh(pp=world)
    try:
        forward_backward_pipelining_with_interleaving(
            toy_enc_dec_spec(), pipeline_params_from_numpy(params, "cpu"),
            tuple(_t(a) for a in batch), num_microbatches=4,
            virtual_pipeline_size=2)
    except ValueError as e:
        return str(e)
    return None
