"""Rank functions of the port's tensor- and sequence-parallel tests
(``tests/test_torch_{parallel_state,tensor_parallel,overlap,
sequence_parallel,tp_gpt,tp_t5}.py``).

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


def _mesh(tp=1, pp=1, sp=1):
    from apex_tpu_torch.transformer import parallel_state

    parallel_state.destroy_model_parallel()
    return parallel_state.initialize_model_parallel(tp, pp, None, sp)


# ---------------------------------------------------------------------------
# parallel_state


def state_grid(rank, world, tp, pp, sp, split_rank):
    """This rank's accessors under initialize_model_parallel(tp, pp, sp)."""
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.destroy_model_parallel()
    before = ps.model_parallel_is_initialized()
    mesh = ps.initialize_model_parallel(tp, pp, 2 if pp > 1 else None, sp,
                                        split_rank)
    out = {
        "before": before,
        "devices": torch.from_numpy(np.asarray(mesh.devices)),
        "sizes": (ps.get_data_parallel_world_size(),
                  ps.get_pipeline_model_parallel_world_size(),
                  ps.get_sequence_parallel_world_size(),
                  ps.get_tensor_model_parallel_world_size(),
                  ps.get_model_parallel_world_size()),
        "ranks": (ps.get_data_parallel_rank(),
                  ps.get_pipeline_model_parallel_rank(),
                  ps.get_sequence_parallel_rank(),
                  ps.get_tensor_model_parallel_rank()),
        "first_last": (ps.is_pipeline_first_stage(),
                       ps.is_pipeline_last_stage(),
                       ps.is_pipeline_first_stage(ignore_virtual=True),
                       ps.is_pipeline_last_stage(ignore_virtual=True)),
        "split": (ps.is_pipeline_stage_before_split(),
                  ps.is_pipeline_stage_after_split(),
                  ps.is_pipeline_stage_at_split()),
        "axes": ps.get_model_parallel_axes(),
        "info": ps.get_rank_info(),
        "vpp": (ps.get_virtual_pipeline_model_parallel_world_size(),
                ps.get_virtual_pipeline_model_parallel_rank()),
    }
    ps.set_virtual_pipeline_model_parallel_rank(1)
    out["first_last_v1"] = (ps.is_pipeline_first_stage(),
                            ps.is_pipeline_last_stage())
    ps.destroy_model_parallel()
    out["after"] = (ps.model_parallel_is_initialized(), ps.get_rank_info())
    return out


def bad_grid(rank, world):
    """The messages of a tp that does not divide the ranks and of a split
    rank outside (0, pp)."""
    from apex_tpu_torch.transformer import parallel_state as ps

    msgs = []
    for kw in (dict(tensor_model_parallel_size_=3),
               dict(pipeline_model_parallel_size_=2,
                    pipeline_model_parallel_split_rank_=2)):
        try:
            ps.initialize_model_parallel(**kw)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


# ---------------------------------------------------------------------------
# tensor_parallel


def mappings(rank, world, cases):
    """Each mapping ``name: (x, cot)`` (per-rank rows: rank r's input and
    output cotangent) -> this rank's output and input gradient."""
    from apex_tpu_torch.transformer.tensor_parallel import mappings as m

    _mesh(tp=world)
    out = {}
    for name, (x, cot) in cases.items():
        fn = getattr(m, name)
        xi = _t(x[rank], True)
        y = fn(xi)
        (dx,) = torch.autograd.grad(y, xi, _t(cot[rank]))
        out[name] = (y.detach(), dx)
    return out


def layers(rank, world, x, col_k, col_b, row_k, row_b, cot, emb, ids,
           emb_cot, logits, tgt):
    """From the global numpy arrays, this rank's shards through the tp
    layers: the column → row composition (plain and sequence parallel)
    under ``cot`` with its input and parameter gradients, the vocab
    embedding (both exits) and its table's gradient, the vocab
    cross-entropy and its logits' gradient; the modules' tp-invariant
    init, the memory buffer and the data broadcast."""
    from apex_tpu_torch.transformer import tensor_parallel as tpl

    _mesh(tp=world)
    out = {}

    def cut(a, dim):
        n = a.shape[dim] // world
        return np.take(a, range(rank * n, (rank + 1) * n), axis=dim)

    for sp in (False, True):
        xi = _t(cut(x, 1) if sp else x, True)
        ck, cb = _t(cut(col_k, 1), True), _t(cut(col_b, 0), True)
        rk, rb = _t(cut(row_k, 0), True), _t(row_b, True)
        h = tpl.column_parallel_linear(xi, ck, cb, gather_output=False,
                                       sequence_parallel=sp)
        y = tpl.row_parallel_linear(torch.tanh(h), rk, rb,
                                    input_is_parallel=True,
                                    sequence_parallel=sp)
        grads = torch.autograd.grad(y, (xi, ck, cb, rk, rb),
                                    _t(cut(cot, 1) if sp else cot))
        out[f"colrow_sp{int(sp)}"] = (y.detach(),) + tuple(grads)
    xi = _t(x, True)
    y = tpl.column_parallel_linear(xi, _t(cut(col_k, 1)), _t(cut(col_b, 0)),
                                   gather_output=True)
    out["col_gather"] = y.detach()
    y = tpl.row_parallel_linear(torch.tanh(y), _t(cut(row_k, 0)),
                                _t(row_b), input_is_parallel=False)
    out["row_scatter"] = y.detach()
    for sp in (False, True):
        w = _t(cut(emb, 0), True)
        e = tpl.vocab_parallel_embedding(_t(ids), w, sequence_parallel=sp)
        (dw,) = torch.autograd.grad(e, w, _t(cut(emb_cot, 1) if sp
                                              else emb_cot))
        out[f"embed_sp{int(sp)}"] = (e.detach(), dw)
    lg = _t(cut(logits, 2), True)
    loss = tpl.vocab_parallel_cross_entropy(lg, _t(tgt))
    (dl,) = torch.autograd.grad(loss.mean(), lg)
    out["xent"] = (loss.detach(), dl)
    gens = [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    col = tpl.ColumnParallelLinear(8, 4 * world, generator=gens[0])
    row = tpl.RowParallelLinear(4 * world, 8, input_is_parallel=True,
                                generator=gens[1])
    emb_m = tpl.VocabParallelEmbedding(8 * world, 6, generator=gens[2])
    out["modules"] = (col.kernel.detach(), row.kernel.detach(),
                      emb_m.weight.detach(),
                      tpl.param_is_not_tensor_parallel_duplicate(row.bias))
    buf = tpl.MemoryBuffer("b", 10, torch.float32)
    v1, v2 = buf.get((2, 3)), buf.get((4,))
    try:
        buf.get((1,))
        overflow = None
    except RuntimeError as e:
        overflow = str(e)
    v1.fill_(1.0)
    out["memory"] = (tuple(v1.shape), tuple(v2.shape), buf.numel_in_use(),
                     overflow, float(buf.data.sum()))
    data = {"a": torch.full((2, 3), rank, dtype=torch.int64),
            "b": torch.full((4,), 10 + rank, dtype=torch.int64)}
    out["broadcast"] = tpl.broadcast_data(["a", "b"], data)
    return out


def grad_scaler(rank, world, inf_rank):
    """GradScaler over parallel_state's axes (its default) and over named
    axes: rank ``inf_rank`` alone finds an inf; each rank's synced flag
    and its state after ``update_scale``."""
    from apex_tpu_torch.transformer.amp import GradScaler

    _mesh(tp=world)
    flag = torch.tensor(1.0 if rank == inf_rank else 0.0)
    out = {}
    for label, scaler in (("default", GradScaler(init_scale=8.0)),
                          ("tp", GradScaler(init_scale=8.0,
                                            axis_names=("tp",))),
                          ("none", GradScaler(init_scale=8.0,
                                              axis_names=()))):
        st = scaler.init_state(device="cpu")
        st2, skipped = scaler.update_scale(st, flag, synced=False)
        out[label] = (float(scaler.sync_found_inf(flag)),
                      float(st2.loss_scale), float(skipped))
    return out


def lm_head(rank, world, x, w, tgt, dtype):
    """``lm_head_loss(axis_name="tp")`` on this rank's vocab rows: the loss,
    dx (the partial, summed over tp by the copy mapping) and dw."""
    from apex_tpu_torch.ops.lm_head_loss import lm_head_loss
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        copy_to_tensor_model_parallel_region,
    )

    _mesh(tp=world)
    dt = getattr(torch, dtype)
    v_loc = w.shape[0] // world
    xi = _t(x).to(dt).requires_grad_(True)
    wi = _t(w[rank * v_loc:(rank + 1) * v_loc]).to(dt).requires_grad_(True)
    loss = lm_head_loss(copy_to_tensor_model_parallel_region(xi), wi,
                        _t(tgt), axis_name="tp")
    dx, dw = torch.autograd.grad(loss.mean(), (xi, wi))
    return loss.detach(), dx, dw


# ---------------------------------------------------------------------------
# overlap


def overlap(rank, world, cases, linear):
    """Each ring case ``name: (op, axis, kwargs, x, k, dy)`` (per-rank rows)
    on this rank's rows: the output, the input gradients under its
    cotangent, the forward's collective record priced by
    ``collective_report``, the ring records of forward and backward and
    their overlap report; then ``FSDP(bidirectional=True).linear`` on the
    dp ring from ``linear = (x, w, dy)`` (a whole weight, its column shard
    cut here)."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.comm import overlap as ov
    from apex_tpu_torch.fsdp import FSDP
    from apex_tpu_torch.parallel.mesh import build_mesh

    out = {}
    for name, (op, axis, kw, x, k, dy) in cases.items():
        build_mesh(**({"tp": world} if axis == "tp" else {}))
        xi, ki = _t(x[rank], True), _t(k[rank], True)
        with accounting.record_collectives() as rec, \
                accounting.record_overlap() as rings:
            y = getattr(ov, op)(xi, ki, axis_name=axis, **kw)
            fwd = accounting.collective_report(list(rec))
            fwd_rings = list(rings)
            dx, dk = torch.autograd.grad(y, (xi, ki), _t(dy[rank]))
        out[name] = {
            "y": y.detach(), "dx": dx, "dk": dk,
            "fwd_wire": fwd.wire_bytes, "fwd_counts": fwd.counts,
            "fwd_rings": [tuple(r) for r in fwd_rings],
            "rings": [tuple(r) for r in rings],
            "report": dict(vars(accounting.overlap_report(list(rings))))}
    build_mesh()
    x, w, dy = linear
    f = FSDP(bidirectional=True)
    xi = _t(x[rank], True)
    shard = f.shard_linear_weight(_t(w)).requires_grad_(True)
    y = f.linear(xi, shard)
    dx, dw = torch.autograd.grad(y, (xi, shard), _t(dy[rank]))
    out["fsdp_linear"] = (y.detach(), dx, dw)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism


def ring(rank, world, q, k, v, do, bias, seed, cases):
    """Each case (``ring_attention`` keywords, with ``bias`` for the strip
    and ``ulysses`` for ``ulysses_attention``) on this rank's sequence
    shard of the global q, k, v, cotangent and (h, S, S) bias: the output
    and the gradients of q, k, v (and the strip)."""
    from apex_tpu_torch.transformer.sequence_parallel import (
        ring_attention,
        ulysses_attention,
    )

    _mesh(sp=world)
    s = q.shape[2] // world
    sl = slice(rank * s, (rank + 1) * s)
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        leaves = [_t(a[:, :, sl], True) for a in (q, k, v)]
        if kw.pop("bias", False):
            leaves.append(_t(bias[:, sl], True))
            kw["bias_strip"] = leaves[-1]
        fn = ulysses_attention if kw.pop("ulysses", False) else \
            ring_attention
        o = fn(*leaves[:3], **kw)
        grads = torch.autograd.grad(o, leaves, _t(do[:, :, sl]))
        out[name] = (o.detach(),) + tuple(grads)
    return out


def saved_bytes(fn, *args, **kwargs):
    """``fn``'s result, and what autograd saved while it ran: ``(bytes of
    the distinct storages, bytes of those whose tensor's two trailing dims
    are equal (the (s, s) scores), the set of saved shapes)``."""
    seen, out = set(), [0, 0]
    shapes = set()

    def pack(t):
        s = t.untyped_storage()
        shapes.add(tuple(t.shape))
        if s.data_ptr() not in seen:
            seen.add(s.data_ptr())
            out[0] += s.nbytes()
            if t.dim() >= 2 and t.shape[-1] == t.shape[-2] > 1:
                out[1] += s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        res = fn(*args, **kwargs)
    return res, out[0], out[1], shapes


def ring_remat(rank, world, q, k, v, do, long_qkv):
    """C8: the einsum scan with ``remat_steps`` on and off, causal and
    not, on this rank's shards: the outputs and q / k / v gradients of
    both; and on ``long_qkv`` (a long sequence, narrow heads) the saved
    bytes (all, and the square-tailed ones) and shapes of the causal scan
    with it on and off."""
    from apex_tpu_torch.transformer.sequence_parallel import ring_attention

    _mesh(sp=world)
    out = {}

    def shard(a):
        s = a.shape[2] // world
        return a[:, :, rank * s:(rank + 1) * s]

    for causal in (True, False):
        for remat in (True, False):
            leaves = [_t(shard(a), True) for a in (q, k, v)]
            o = ring_attention(*leaves, causal=causal, impl="scan",
                               remat_steps=remat)
            grads = torch.autograd.grad(o, leaves, _t(shard(do)))
            out[(causal, remat)] = (o.detach(),) + tuple(grads)
    for remat in (True, False):
        leaves = [_t(shard(a), True) for a in long_qkv]
        _, total, square, shapes = saved_bytes(
            ring_attention, *leaves, causal=True, impl="scan",
            remat_steps=remat)
        out[("long", remat)] = (total, square, shapes)
    return out


# ---------------------------------------------------------------------------
# GPT and T5


def models(rank, world, cases):
    """For each ``name: (model, cfg fields, tp, sp, dropout key, params,
    batch)`` (``model`` "gpt", "bert" or "t5"; global numpy parameters;
    the batch's rows sharded over dp, its sequence over sp): the loss
    (the mean over every rank's tokens) and the global gradient tree,
    computed from this rank's shards. GPT's batch is whole on every dp
    rank, as JAX's tests feed it (its dropout masks are keyed by the
    row)."""
    from apex_tpu_torch.convert import params_from_numpy
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
    for name, (model, fields, tp, sp, key, params, batch) in cases.items():
        _mesh(tp=tp, sp=sp)
        cfg_cls, loss_fn, specs_of = {
            "gpt": (tt.GPTConfig, tt.gpt_loss, tt.gpt_param_specs),
            "bert": (tt.BertConfig, tt.bert_mlm_loss, bert_param_specs),
            "t5": (tt.T5Config, tt.t5_loss, tt.t5_param_specs)}[model]
        cfg = cfg_cls(**fields)
        specs = specs_of(cfg)
        local = tt.shard_params(params_from_numpy(params, "cpu"), specs)
        leaves = param_leaves(local)
        for p in leaves:
            p.requires_grad_(True)
        _, dp, dp_rank = axis_info("dp")
        _, _, sp_rank = axis_info("sp")

        def cut(a, seq=True):
            if model != "gpt":       # GPT's batch is whole on every dp rank
                rows = a.shape[0] // dp
                a = a[dp_rank * rows:(dp_rank + 1) * rows]
            if seq and a.ndim > 1:
                s = a.shape[1] // sp
                a = a[:, sp_rank * s:(sp_rank + 1) * s]
            return _t(a)

        if model == "bert":
            tok, tgt, lm, types, pad = batch
            loss = loss_fn(local, cut(tok), cut(tgt), cut(lm), cfg,
                           token_types=cut(types), padding_mask=cut(pad))
        elif model == "t5":
            loss = loss_fn(local, *(cut(a) for a in batch), cfg,
                           dropout_key=key)
        else:
            loss = loss_fn(local, *(cut(a) for a in batch), cfg,
                           dropout_key=key)
        n_rep = dp * sp
        grads = torch.autograd.grad(loss / n_rep, leaves)
        g = tt.gather_grads(tree_unflatten(local, list(grads)), specs)
        total = all_reduce(all_reduce(loss.detach(), "sp"), "dp") / n_rep
        out[name] = (total, g)
    return out


def plan_tp(rank, world, steps):
    """``build_train_step(plan=)`` for the ``fsdp+tp`` preset (dp 2 × tp 2:
    ``megatron_sp`` and ``overlap_comm`` spliced in, FSDP over this rank's
    tp shards) beside the ``fsdp`` preset over every rank, the same tiny
    GPT and batch: each one's losses. For ``fsdp+tp`` also the batch and
    the first step's gradient, as its step takes it (the FSDP gather's
    dp-summed shard gradients over dp, as ``FSDPAdam`` averages them),
    gathered over tp into the global tree."""
    import dataclasses

    from apex_tpu_torch.optimizers._common import (tree_leaves,
                                                   tree_unflatten)
    from apex_tpu_torch.parallel.plan import ParallelismPlan
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        all_gather_dim,
    )
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step,
                                                    gpt_loss,
                                                    gpt_param_specs)
    from apex_tpu_torch.transformer.testing.standalone_gpt import _spec_tree

    cfg = GPTConfig(vocab_size=128, max_seq=32, hidden=64, num_layers=2,
                    num_heads=4, dtype=torch.float32)
    out = {}
    for preset in ("fsdp", "fsdp+tp"):
        parallel_state.destroy_model_parallel()
        plan = ParallelismPlan.preset(preset)
        mesh = plan.mesh()
        step, params, opt, tok, tgt = build_train_step(
            cfg, 2, 32, device="cpu", plan=plan)
        out[preset] = {"mesh": dict(mesh.shape),
                       "qkv_shape": tuple(params["layers"]["qkv_kernel"]
                                          .shape)}
        if plan.tp > 1:
            tcfg = dataclasses.replace(cfg, **plan.gpt_overrides())
            st = step.plan_state
            master = st["state"].master
            shards = [m.detach().clone().requires_grad_(True)
                      for m in tree_leaves(master)]
            loss = gpt_loss(opt.fsdp.gather(tree_unflatten(master, shards),
                                            st["meta"]), tok, tgt, tcfg)
            grads = torch.autograd.grad(loss, shards)
            with torch.no_grad():
                local = opt.fsdp.gather(tree_unflatten(
                    master, [g / mesh.size("dp") for g in grads]),
                    st["meta"])

                def assemble(g, spec):
                    for dim, axis in enumerate(spec):
                        if axis is not None:
                            g = all_gather_dim(g, dim, axis)
                    return g

                out[preset].update(
                    tok=tok, tgt=tgt, first_loss=float(loss),
                    grads=_spec_tree(local, gpt_param_specs(tcfg),
                                     assemble))
        out[preset]["losses"] = [float(step()) for _ in range(steps)]
    return out
