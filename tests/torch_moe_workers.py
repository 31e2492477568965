"""Rank functions of the port's mixture-of-experts tests
(``tests/test_torch_moe.py``).

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


def several(rank, world, calls):
    """Each ``(function name, args)`` of this module in turn, in one group
    -> their results by name, and ``jax_loaded``."""
    mod = sys.modules[__name__]
    out = {name: getattr(mod, fn)(rank, world, *args)
           for name, (fn, args) in calls.items()}
    out["jax_loaded"] = any(m in sys.modules for m in
                            ("jax", "jaxlib", "flax", "apex_tpu"))
    return out


def _t(a, requires_grad=False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(requires_grad)


def _mesh(tp=1, pp=1, sp=1):
    from apex_tpu_torch.transformer import parallel_state

    parallel_state.destroy_model_parallel()
    return parallel_state.initialize_model_parallel(tp, pp, None, sp)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree)


def _rows(a, axis="dp"):
    """This rank's rows of a global batch (dim 0 over ``axis``)."""
    from apex_tpu_torch.parallel.mesh import axis_info

    _, n, i = axis_info(axis)
    rows = a.shape[0] // n
    return a[i * rows:(i + 1) * rows]


def moe_layer(rank, world, cfg_fields, params, x):
    """``moe_mlp`` with experts over dp (ep = world): this rank's rows of
    ``x`` and its expert shard. Returns the gathered output, the dp mean
    of ``aux["loss"]``, and the global gradient tree of ``mean_dp(sum(out
    ** 2) + aux["loss"])`` (experts gathered along E, the router summed
    over dp)."""
    from apex_tpu_torch.transformer import moe
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        all_gather_dim,
        all_reduce,
    )
    from apex_tpu_torch.transformer.testing import gather_grads, shard_params

    _mesh()
    cfg = moe.MoEConfig(dtype=torch.float32, **cfg_fields)
    specs = moe.moe_param_specs("dp")
    local = shard_params({k: _t(v) for k, v in params.items()}, specs)
    names = sorted(local)
    for k in names:
        local[k].requires_grad_(True)
    out, aux = moe.moe_mlp(local, _t(_rows(x)), cfg, ep_axis="dp")
    obj = ((out * out).sum() + aux["loss"]) / world
    grads = torch.autograd.grad(obj, [local[k] for k in names])
    g = gather_grads(dict(zip(names, grads)), specs)
    loss = all_reduce(aux["loss"].detach(), "dp") / world
    return (all_gather_dim(out.detach(), 0, "dp"), loss, g)


def gpt(rank, world, cases):
    """For each ``name: (model, cfg fields, tp, params, batch, steps)``: the
    loss (the mean over the dp ranks) and the global gradient tree from
    this rank's shards, its rows of the batch (dp); with ``steps`` that
    many ``FusedAdam(lr=1e-3)`` steps after, each step's loss."""
    from apex_tpu_torch.convert import params_from_numpy
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers._common import tree_unflatten
    from apex_tpu_torch.transformer import testing as tt
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        all_reduce,
        axis_info,
    )
    from apex_tpu_torch.transformer.testing.standalone_bert import (
        bert_param_specs,
    )
    from apex_tpu_torch.transformer.testing.train import param_leaves

    out = {}
    for name, (model, fields, tp, params, batch, steps) in cases.items():
        _mesh(tp=tp)
        _, dp, _ = axis_info("dp")
        if model == "bert":
            cfg = tt.BertConfig(**fields)
            specs = bert_param_specs(cfg)

            def loss_of(p):
                tok, tgt, lm = (_t(_rows(a)) for a in batch)
                return tt.bert_mlm_loss(p, tok, tgt, lm, cfg)
        else:
            cfg = tt.GPTConfig(**fields)
            specs = tt.gpt_param_specs(cfg)

            def loss_of(p):
                tok, tgt = (_t(_rows(a)) for a in batch)
                return tt.gpt_loss(p, tok, tgt, cfg)
        # a copy: on the CPU the tensors share the arrays' memory, and the
        # optimizer steps must not reach the next case's weights
        local = tt.shard_params(params_from_numpy(_copy(params), "cpu"),
                                specs)
        leaves = param_leaves(local)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_of(local)
        grads = torch.autograd.grad(loss / dp, leaves, allow_unused=True)
        # BERT without token types leaves its type table unused: zero
        grads = [torch.zeros_like(p) if gi is None else gi
                 for p, gi in zip(leaves, grads)]
        g = tt.gather_grads(tree_unflatten(local, list(grads)), specs)
        total = all_reduce(loss.detach(), "dp") / dp
        losses = []
        if steps:
            opt = FusedAdam(leaves, lr=1e-3)
            spec_leaves = param_leaves(specs)
            for _ in range(steps):
                loss = loss_of(local)
                losses.append(float(all_reduce(loss.detach(), "dp") / dp))
                gs = torch.autograd.grad(loss / dp, leaves,
                                         allow_unused=True)
                for p, gi, spec in zip(leaves, gs, spec_leaves):
                    if gi is None:
                        continue
                    # this rank's slice of the global gradient: summed over
                    # dp where the leaf is replicated over it
                    p.grad = gi if "dp" in tuple(spec) else all_reduce(
                        gi, "dp")
                opt.step()
            loss = loss_of(local)
            losses.append(float(all_reduce(loss.detach(), "dp") / dp))
        out[name] = (total, g, losses)
    return out


def pipeline(rank, world, fields, params, batch, M):
    """GPT with experts through 1F1B at pp 2 × dp 2 (``params_specs`` =
    ``gpt_pipeline_specs_tree``), and the sequential ``gpt_loss`` on the
    same weights flattened back to one stack at dp 4, each rank's rows
    the pipeline's microbatch rows. Returns ``(pipeline loss, sequential
    loss, pipeline grads, sequential grads)``: the pipeline's gradient
    tree on this rank (its stage, its dp shard of the experts), and the
    same leaves cut from the sequential global gradient (``gather_grads``
    of the dp-4 rank gradients: experts gathered along E, the rest
    summed)."""
    from apex_tpu_torch.convert import (
        named_leaves,
        params_from_numpy,
        pipeline_params_from_numpy,
    )
    from apex_tpu_torch.optimizers._common import tree_unflatten
    from apex_tpu_torch.parallel.mesh import axis_info
    from apex_tpu_torch.transformer import testing as tt
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving,
    )
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        all_reduce,
    )
    from apex_tpu_torch.transformer.tensor_parallel.utils import P
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        gpt_pipeline_spec,
        gpt_pipeline_specs_tree,
    )
    from apex_tpu_torch.transformer.testing.train import param_leaves

    cfg = tt.GPTConfig(**fields)
    specs = gpt_pipeline_specs_tree(cfg)
    _mesh(pp=2)
    stage, dp_rank = axis_info("pp")[2], axis_info("dp")[2]
    local = pipeline_params_from_numpy(params, "cpu", specs=specs)
    tok, tgt = (_t(a) for a in batch)
    loss, grads = forward_backward_pipelining_without_interleaving(
        gpt_pipeline_spec(cfg), local, (tok, tgt), num_microbatches=M,
        data_spec=P(None, "dp"), remat=False, params_specs=specs)

    # the sequential reference: dp 4, rank r holding microbatch r // 2's
    # dp-slice r % 2 (the pipeline's grouping of rows)
    _mesh()
    flat = {"embed": params["embed"], "head": params["head"],
            "layers": {k: v.reshape((-1,) + v.shape[2:])
                       for k, v in params["stages"].items()}}
    seq_specs = tt.gpt_param_specs(cfg)
    seq = tt.shard_params(params_from_numpy(flat, "cpu"), seq_specs)
    leaves = [p.requires_grad_() for p in param_leaves(seq)]
    b = tok.shape[0]
    per = b // (M * 2)
    m, d = divmod(rank, 2)
    rows = slice(m * (b // M) + d * per, m * (b // M) + (d + 1) * per)
    ref = tt.gpt_loss(seq, tok[rows], tgt[rows], cfg) / world
    gs = torch.autograd.grad(ref, leaves)
    ref = all_reduce(ref.detach(), "dp")
    full = tt.gather_grads(tree_unflatten(seq, list(gs)), seq_specs)

    # this rank's pipeline leaves cut from the global gradient: its
    # stage's layers, and its dp shard of the experts
    lps = params["stages"]["router"].shape[1]
    want = {"embed": full["embed"], "head": full["head"], "stages": {}}
    for k, g in full["layers"].items():
        g = g[stage * lps:(stage + 1) * lps]
        if "dp" in tuple(specs["stages"][k]):
            e = g.shape[1] // 2
            g = g[:, dp_rank * e:(dp_rank + 1) * e]
        want["stages"][k] = g
    got = {k: g.detach() for k, g in named_leaves(grads)}
    return float(loss), float(ref), got, dict(named_leaves(want))

