"""Rank functions of the port's multi-process tests
(``tests/test_torch_{comm_dist,ddp,syncbn_dist,zero,fsdp}.py``).

Each runs in a process that ``apex_tpu_torch.parallel.multiproc.spawn``
started, as one rank of a ``gloo`` group, and returns host tensors; the
test compares them with JAX in the pytest process. This module imports
torch, numpy and the port only — a spawned rank never imports JAX — and
every result carries ``jax_loaded``, what the rank's ``sys.modules``
says, so the tests can hold that.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def several(rank, world, calls):
    """Each ``(function name, args)`` of this module in turn, in one
    group (one spawn instead of several) -> their results by name."""
    mod = sys.modules[__name__]
    return {name: getattr(mod, name)(rank, world, *args)
            for name, args in calls}


def _loaded() -> bool:
    return any(m in sys.modules for m in ("jax", "jaxlib", "flax", "optax",
                                          "apex_tpu"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# collectives, mesh, found_inf


def collectives(rank, world, bufs, residuals, policies, block, min_elements,
                stochastic_buf):
    """For each policy and buffer: ``compressed_allreduce`` and
    ``compressed_psum_scatter`` of this rank's row (with its residual row
    under EF), pass 1's codes and scales of the padded buffer, pass 1's
    and pass 3's errors measured apart (the telescoping identity), and,
    on ``stochastic_buf``, seeded stochastic runs."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.comm.collectives import (CompressionConfig,
                                                 _pad_to, _pass_seed,
                                                 compressed_allreduce,
                                                 compressed_psum_scatter)
    from apex_tpu_torch.comm.quantize import padded_size
    from apex_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(tp=1, pp=1, sp=1)
    out = {"jax_loaded": _loaded(), "index": mesh.index("dp")}
    for policy in policies:
        cfg = CompressionConfig(policy=policy, block_size=block,
                                min_elements=min_elements)
        for name, rows in bufs.items():
            x = _t(rows[rank])
            r = _t(residuals[name][rank]) if cfg.error_feedback else None
            ar, ar_r = compressed_allreduce(x, "dp", cfg, residual=r)
            ps, ps_r = compressed_psum_scatter(x, "dp", cfg, residual=r,
                                               shard_multiple=block)
            rec = {"allreduce": ar, "allreduce_res": ar_r,
                   "psum_scatter": ps, "psum_scatter_res": ps_r}
            n = x.numel()
            if cfg.compresses(n):
                comp = x if r is None else x + r
                size = padded_size(n, block * world)
                padded = _pad_to(comp, size)
                q, s = cfg.quantize(padded)
                e1 = padded - cfg.dequantize(q, s)
                # this rank's summed shard (the reduce-scatter's, the same
                # padding here) and pass 3's error on it
                shard = ps
                assert shard.numel() == size // world
                q2, s2 = cfg.quantize(shard)
                e2 = shard - cfg.dequantize(q2, s2)
                rec.update(codes=q, scales=s, e1=e1, e2=e2)
            out[(policy, name)] = rec
    # stochastic rounding: one seed twice, another seed, and 32 seeds
    cfg = CompressionConfig(policy="int8", block_size=block,
                            min_elements=min_elements,
                            stochastic_rounding=True)
    x = _t(stochastic_buf[rank])
    runs = [compressed_allreduce(x, "dp", cfg, seed=s)[0]
            for s in [7, 7, 8] + list(range(100, 132))]
    out["stochastic"] = torch.stack(runs)
    out["pass_seeds"] = torch.tensor(
        [[_pass_seed(s, rank, p) for p in (1, 2)]
         for s in (0, 7, -5, 2 ** 31 - 1)])
    # accounting: the issued collectives priced, int8 and none
    big = torch.randn(65536, generator=torch.Generator().manual_seed(rank))
    for policy in ("int8", "int4", "none"):
        cfg = CompressionConfig(policy=policy)
        with accounting.record_collectives() as rec:
            compressed_allreduce(big, "dp", cfg)
        out[("wire", policy)] = torch.tensor(accounting.wire_bytes(rec),
                                             dtype=torch.float64)
        out[("counts", policy)] = accounting.collective_report(rec).counts
    return out


def mesh_and_found_inf(rank, world, shapes, flag_rank):
    """For each ``(tp, pp, sp)``: this rank's coordinates, each axis's
    index and group size; then, on the first mesh, the found_inf MAX over
    named axes and over a group, the flag set on ``flag_rank`` only."""
    import torch.distributed as dist

    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.parallel.mesh import AXIS_ORDER, build_mesh

    out = {"jax_loaded": _loaded(), "meshes": []}
    meshes = [build_mesh(tp=tp, pp=pp, sp=sp) for tp, pp, sp in shapes]
    for mesh in meshes:
        out["meshes"].append({
            "shape": tuple(mesh.shape[a] for a in AXIS_ORDER),
            "coords": mesh.coordinates(),
            "index": {a: mesh.index(a) for a in AXIS_ORDER},
            "group_size": {a: dist.get_world_size(mesh.group(a))
                           for a in AXIS_ORDER},
            "devices": torch.from_numpy(mesh.devices.copy())})
    flag = torch.tensor(1.0 if rank == flag_rank else 0.0)
    with meshes[0] as mesh:
        out["found_inf"] = {
            axes: float(LossScaler.all_reduce_found_inf(flag, axes))
            for axes in FOUND_INF_AXES}
        out["found_inf_group"] = float(LossScaler.all_reduce_found_inf(
            flag, group=mesh.group("tp")))
    out["flag_kept"] = float(flag)
    return out


FOUND_INF_AXES = (("sp", "tp"), ("dp",), ("tp",), "sp",
                  ("dp", "pp", "sp", "tp"))


# ---------------------------------------------------------------------------
# DDP


def ddp_average(rank, world, grads, residuals, cases, bf16):
    """``average_gradients`` of this rank's gradient tree (in bf16 with
    ``bf16``) under each case ``(label, ddp kwargs, policy or None, block,
    with metrics)``; the EF cases thread their residual tree and return
    the new one; the metrics come back as a dict."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.comm.collectives import CompressionConfig
    from apex_tpu_torch.monitor.metrics import Metrics
    from apex_tpu_torch.optimizers._common import tree_map
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.mesh import build_mesh

    build_mesh(tp=1, pp=1, sp=1)
    g = tree_map(lambda a: _t(a[rank]), grads)
    if bf16:
        g = tree_map(lambda t: t.to(torch.bfloat16), g)
    g_before = tree_map(torch.clone, g)
    out = {"jax_loaded": _loaded()}
    for label, kw, policy, block, with_metrics in cases:
        cfg = (None if policy is None else CompressionConfig(
            policy=policy, block_size=block, min_elements=block))
        ddp = DistributedDataParallel(compression=cfg, **kw)
        state = ddp.init_comm_state(g)
        if state is not None:
            state = tree_map(lambda a: _t(a[rank]), residuals)
        with accounting.record_collectives() as rec:
            red = ddp.average_gradients(
                g, comm_state=state,
                metrics=Metrics() if with_metrics else None)
        red = red if isinstance(red, tuple) else (red,)
        res = {"grads": red[0], "wire": accounting.wire_bytes(rec)}
        if state is not None:
            res["state"] = red[1]
        if with_metrics:
            res["metrics"] = red[-1].as_dict()
        out[label] = res
    out["inputs_kept"] = all(
        torch.equal(a, b) for a, b in zip(_leaves(g), _leaves(g_before)))
    return out


def _leaves(tree):
    from apex_tpu_torch.optimizers._common import tree_leaves

    return tree_leaves(tree)


def ddp_accumulate(rank, world, w0, xs, ys):
    """``accumulate_and_average`` of a linear least-squares model over M
    microbatches against ``average_gradients`` of the summed gradients
    (int8_ef and none), ``broadcast_params`` and ``Reducer``."""
    from apex_tpu_torch.comm.collectives import CompressionConfig
    from apex_tpu_torch.optimizers._common import tree_map
    from apex_tpu_torch.parallel import DistributedDataParallel, Reducer
    from apex_tpu_torch.parallel.mesh import build_mesh

    build_mesh(tp=1, pp=1, sp=1)
    params = {"w": _t(w0), "b": torch.zeros(w0.shape[1])}
    mbs = {"x": _t(xs[rank]), "y": _t(ys[rank])}

    def value_and_grad(p, mb):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = ((mb["x"] @ q["w"] + q["b"] - mb["y"]) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, [q["w"], q["b"]])
        return loss.detach(), {"w": gw, "b": gb}

    out = {"jax_loaded": _loaded()}
    for policy in (None, "int8_ef"):
        cfg = None if policy is None else CompressionConfig(
            policy=policy, block_size=128, min_elements=128)
        ddp = DistributedDataParallel(compression=cfg)
        st = ddp.init_comm_state(params)
        got = ddp.accumulate_and_average(value_and_grad, params, mbs,
                                         comm_state=st)
        m = mbs["x"].shape[0]
        loss_sum = torch.zeros(())
        acc = tree_map(torch.zeros_like, params)
        for i in range(m):
            l, gi = value_and_grad(params, {k: v[i] for k, v in mbs.items()})
            loss_sum = loss_sum + l
            acc = tree_map(torch.add, acc, gi)
        want = ddp.average_gradients(acc, comm_state=st)
        want = want if isinstance(want, tuple) else (want,)
        out[str(policy)] = {"got": got, "want": (loss_sum / m,) + want}
    ddp = DistributedDataParallel()
    mine = {"w": params["w"] + rank, "b": params["b"] - rank}
    out["broadcast"] = ddp.broadcast_params(mine)
    out["reduce"] = Reducer().reduce(mine)
    return out


def gpt_ef_training(rank, world, tokens, policies, steps, lr, block,
                    mid_roundtrip):
    """JAX's EF training property on the port's tiny GPT (fp32, 2 layers,
    hidden 64): each rank its slice of ``tokens``, DDP under each policy
    over FusedAdam(lr), the losses averaged over ranks; under EF the
    residual goes through ``comm_state_dict`` / ``load_comm_state_dict``
    once mid-run."""
    import torch.distributed as dist

    from apex_tpu_torch.comm.collectives import CompressionConfig
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.mesh import build_mesh
    from apex_tpu_torch.transformer.testing import (GPTConfig, gpt_loss,
                                                    init_gpt_params)
    from apex_tpu_torch.transformer.testing.train import param_leaves

    build_mesh(tp=1, pp=1, sp=1)
    cfg = GPTConfig(vocab_size=128, max_seq=32, hidden=64, num_layers=2,
                    num_heads=2, dtype=torch.float32)
    per = tokens.shape[0] // world
    tok = _t(tokens[rank * per:(rank + 1) * per]).long()
    out = {"jax_loaded": _loaded()}
    for policy in policies:
        comp = None if policy is None else CompressionConfig(
            policy=policy, block_size=block, min_elements=block)
        ddp = DistributedDataParallel(compression=comp)
        params = init_gpt_params(cfg, seed=0, device="cpu")
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = FusedAdam(leaves, lr=lr)
        state = ddp.init_comm_state(leaves)
        losses = []
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = gpt_loss(params, tok, tok, cfg)
            loss.backward()
            red = ddp.average_gradients([p.grad for p in leaves],
                                        comm_state=state)
            if state is not None:
                red, state = red
            for p, g in zip(leaves, red):
                p.grad = g
            opt.step()
            mean = loss.detach().clone()
            dist.all_reduce(mean)
            losses.append(float(mean) / world)
            if state is not None and i == mid_roundtrip:
                state = ddp.load_comm_state_dict(
                    [torch.zeros_like(r) for r in state],
                    ddp.comm_state_dict(state))
        out[str(policy)] = losses
    return out


# ---------------------------------------------------------------------------
# SyncBatchNorm, groupbn, bottleneck


def syncbn(rank, world, xs, cots, group_size, momentum, scale, bias):
    """``sync_batch_stats`` whole and grouped, and ``SyncBatchNorm``'s
    forward, running statistics and backward (x, scale, bias) on this
    rank's NHWC batch, whole and grouped; ``BatchNorm2d_NHWC(bn_group=
    group_size)``; ``convert_syncbn_model`` of a ``BatchNorm2d`` over the
    axis."""
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel.mesh import build_mesh
    from apex_tpu_torch.parallel.sync_batchnorm import (
        SyncBatchNorm, convert_syncbn_model, create_syncbn_process_group,
        sync_batch_stats)

    build_mesh(tp=1, pp=1, sp=1)
    x = _t(xs[rank])
    cot = _t(cots[rank])
    c = x.shape[-1]
    groups = create_syncbn_process_group(group_size, world)
    out = {"jax_loaded": _loaded()}
    for label, grp in (("whole", None), ("grouped", groups)):
        out[("stats", label)] = sync_batch_stats(x, (0, 1, 2), "dp", grp)
        bn = SyncBatchNorm(c, momentum=momentum, axis_index_groups=grp,
                           device="cpu")
        with torch.no_grad():
            bn.scale.copy_(_t(scale))
            bn.bias.copy_(_t(bias))
        xr = x.clone().requires_grad_(True)
        y = bn(xr)
        y2 = bn(xr * 2.0 + 1.0)
        (gx, gs, gb) = torch.autograd.grad(
            (y * cot).sum() + (y2 * cot).sum(), [xr, bn.scale, bn.bias])
        out[("module", label)] = {
            "y": y.detach(), "y2": y2.detach(), "mean": bn.mean.clone(),
            "var": bn.var.clone(), "gx": gx, "gscale": gs, "gbias": gb,
            "eval": bn(x, use_running_average=True).detach()}
    gbn = BatchNorm2d_NHWC(c, fuse_relu=True, bn_group=group_size,
                           device="cpu")
    xr = x.clone().requires_grad_(True)
    y = gbn(xr)
    out["groupbn"] = {"y": y.detach(),
                      "gx": torch.autograd.grad((y * cot).sum(), xr)[0],
                      "groups": gbn.axis_index_groups}
    net = torch.nn.Sequential(torch.nn.BatchNorm2d(c))
    conv = convert_syncbn_model(net, axis_name="dp")
    xn = x.permute(0, 3, 1, 2).contiguous()
    out["convert"] = {"type": type(conv[0]).__name__,
                      "axis": conv[0].axis_name,
                      "y": conv[0](xn).detach().permute(0, 2, 3, 1)}
    return out


def bottleneck(rank, world, x_full, kernel, cot_full):
    """``spatial_conv3x3`` on this rank's H slice of ``x_full`` over a
    ``sp = world`` mesh: the output rows and the gradients of this rank's
    slice and of the kernel; ``Bottleneck`` is ``BottleneckBlock``."""
    from apex_tpu_torch.contrib.bottleneck import Bottleneck, spatial_conv3x3
    from apex_tpu_torch.models.resnet import BottleneckBlock
    from apex_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(tp=1, pp=1, sp=world)
    h = x_full.shape[1] // world
    i = mesh.index("sp")
    x = _t(x_full[:, i * h:(i + 1) * h]).requires_grad_(True)
    k = _t(kernel).requires_grad_(True)
    y = spatial_conv3x3(x, k)
    cot = _t(cot_full[:, i * h:(i + 1) * h])
    gx, gk = torch.autograd.grad((y * cot).sum(), [x, k])
    return {"jax_loaded": _loaded(), "y": y.detach(), "gx": gx, "gk": gk,
            "index": i, "same_class": Bottleneck is BottleneckBlock}


# ---------------------------------------------------------------------------
# ZeRO-1 (contrib.optimizers) and FSDP


def _codec(spec):
    """A ``CompressionConfig`` from its keyword dict (None stays None)."""
    from apex_tpu_torch.comm import CompressionConfig

    return None if spec is None else CompressionConfig(**spec)


def _tree(d, fn=_t):
    return {k: fn(v) for k, v in d.items()}


def zero_cases(rank, world, params, grads, residuals, cases, steps):
    """For each case ``(label, "adam" | "lamb", optimizer kwargs, codec
    kwargs or None, scale or None, metrics, gradient multiplier)``:
    ``steps`` steps of the ZeRO optimizer from ``params`` with this rank's
    row of ``grads`` times the multiplier (and of ``residuals`` under EF)
    -> the final params, master and moment shards, EF state, metrics and
    shard shapes."""
    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    from apex_tpu_torch.monitor.metrics import Metrics
    from apex_tpu_torch.parallel.mesh import build_mesh

    build_mesh(tp=1, pp=1, sp=1)
    out = {"jax_loaded": _loaded()}
    for label, kind, kw, codec, scale, with_metrics, mult in cases:
        cls = DistributedFusedAdam if kind == "adam" else DistributedFusedLAMB
        opt = cls(compression=_codec(codec), **kw)
        p = _tree(params)
        g = {k: _t(mult * v[rank]) for k, v in grads.items()}
        st = opt.init(p)
        comm = opt.init_comm_state(p)
        if comm is not None:
            comm = {k: _t(v[rank]) for k, v in residuals.items()}
        sc = None if scale is None else torch.tensor(scale)
        metrics = None
        for _ in range(steps):
            res = opt.step(g, st, p, scale=sc, comm_state=comm,
                           metrics=Metrics() if with_metrics else None)
            p, st = res[0], res[1]
            if comm is not None:
                comm = res[2]
            if with_metrics:
                metrics = res[-1].as_dict()
        out[label] = {"params": p, "master": st.master, "mu": st.mu,
                      "nu": st.nu, "count": int(st.count),
                      "comm": comm, "metrics": metrics,
                      "shapes": {k: tuple(v.shape)
                                 for k, v in st.mu.items()}}
    return out


def fsdp_cases(rank, world, params, coefs, curv, cases, steps):
    """For each case ``(label, FSDP codec kwargs {"compression": ...,
    "weight_gather": ...})``: FSDPAdam(lr=1e-2, weight_decay=0.01) over
    ``steps`` steps of the loss Σ_leaves Σ(full · a_rank) + ½ Σ(full² ·
    c) through ``FSDP.gather`` -> the first step's shard gradients, the
    final master shards, the final gather and the last step's metrics
    (with ``meta``)."""
    from apex_tpu_torch.fsdp import FSDP, FSDPAdam
    from apex_tpu_torch.monitor.metrics import Metrics
    from apex_tpu_torch.optimizers._common import (tree_leaves,
                                                   tree_unflatten)
    from apex_tpu_torch.parallel.mesh import build_mesh

    build_mesh(tp=1, pp=1, sp=1)
    out = {"jax_loaded": _loaded()}
    a = {k: _t(v[rank]) for k, v in coefs.items()}
    c = _tree(curv)
    for label, codecs in cases:
        fsdp = FSDP(**{k: _codec(v) for k, v in codecs.items()})
        opt = FSDPAdam(fsdp=fsdp, lr=1e-2, weight_decay=0.01)
        p = _tree(params)
        meta = fsdp.meta(p)
        st = opt.init(p)
        first = metrics = None
        for i in range(steps):
            shards = [m.requires_grad_(True) for m in tree_leaves(st.master)]
            full = fsdp.gather(st.master, meta)
            loss = sum(torch.sum(full[k] * a[k])
                       + 0.5 * torch.sum(full[k] * full[k] * c[k])
                       for k in sorted(full))
            g = tree_unflatten(st.master,
                               list(torch.autograd.grad(loss, shards)))
            if i == 0:
                first = g
            if i == steps - 1:
                st, m = opt.step(g, st, metrics=Metrics(), meta=meta)
                metrics = m.as_dict()
            else:
                st = opt.step(g, st)
        with torch.no_grad():
            gathered = fsdp.gather(st.master, meta)
        out[label] = {"grads": first, "master": st.master,
                      "gathered": gathered, "metrics": metrics,
                      "shard_multiple": fsdp.shard_multiple,
                      "requires_grad": any(m.requires_grad for m in
                                           tree_leaves(st.master))}
    fsdp = FSDP()
    lin = torch.arange(6 * 4 * world, dtype=torch.bfloat16).reshape(6, -1)
    out["linear_shard"] = fsdp.shard_linear_weight(lin)
    refusals = []
    for bad in (torch.zeros(2, 3, 4), torch.zeros(4, 2 * world + 1)):
        try:
            fsdp.shard_linear_weight(bad)
        except ValueError as e:
            refusals.append(str(e))
    out["linear_refusals"] = refusals
    return out


def gpt_ladder(rank, world, tokens, steps, lr, runs):
    """The tiny GPT (fp32) at dp = ``world``, this rank's rows of
    ``tokens`` (targets = tokens, JAX's fixture), ``steps`` steps of each
    run ``(label, "ddp" | "zero1" | "fsdp", FSDP / ZeRO codec kwargs)``
    with lr ``lr``: DDP + FusedAdam, DistributedFusedAdam, FSDP +
    FSDPAdam, each from seed 0 -> per-run local losses and final fp32
    params (the masters unpadded for the sharded runs). Then
    ``build_train_step(plan=)`` for each preset, 3 steps."""
    import torch.distributed as dist

    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.fsdp import FSDP, FSDPAdam
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers._common import (tree_leaves,
                                                   tree_unflatten)
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.mesh import build_mesh
    from apex_tpu_torch.parallel.plan import ParallelismPlan
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step,
                                                    gpt_loss,
                                                    init_gpt_params)

    build_mesh(tp=1, pp=1, sp=1)
    cfg = GPTConfig(vocab_size=128, max_seq=32, hidden=64, num_layers=2,
                    num_heads=2, dtype=torch.float32)
    rows = tokens.shape[0] // world
    tok = _t(tokens[rank * rows:(rank + 1) * rows]).long()
    out = {"jax_loaded": _loaded()}

    def unpad(shards, like):
        full = []
        for s, p in zip(tree_leaves(shards), tree_leaves(like)):
            allg = [torch.empty_like(s) for _ in range(world)]
            dist.all_gather(allg, s.detach())
            full.append(torch.cat(allg)[:p.numel()].reshape(p.shape))
        return full

    for label, kind, kw in runs:
        params = init_gpt_params(cfg, seed=0, device="cpu")
        leaves = tree_leaves(params)
        losses = []
        if kind == "ddp":
            for p in leaves:
                p.requires_grad_(True)
            ddp = DistributedDataParallel()
            opt = FusedAdam(leaves, lr=lr)
            for _ in range(steps):
                loss = gpt_loss(params, tok, tok, cfg)
                grads = torch.autograd.grad(loss, leaves)
                for p, g in zip(leaves, ddp.average_gradients(list(grads))):
                    p.grad = g
                opt.step()
                losses.append(float(loss.detach()))
            final = [p.detach().clone() for p in leaves]
        elif kind == "zero1":
            for p in leaves:
                p.requires_grad_(True)
            opt = DistributedFusedAdam(lr=lr, compression=_codec(
                kw.get("compression")))
            st = opt.init(params)
            for _ in range(steps):
                loss = gpt_loss(params, tok, tok, cfg)
                grads = torch.autograd.grad(loss, leaves)
                new, st = opt.step(tree_unflatten(params, list(grads)), st,
                                   params)
                with torch.no_grad():
                    for p, n in zip(leaves, tree_leaves(new)):
                        p.copy_(n)
                losses.append(float(loss.detach()))
            final = unpad(st.master, params)
        else:
            fsdp = FSDP(**{k: _codec(v) for k, v in kw.items()})
            opt = FSDPAdam(fsdp=fsdp, lr=lr)
            meta = fsdp.meta(params)
            st = opt.init(params)
            for _ in range(steps):
                shards = [m.requires_grad_(True)
                          for m in tree_leaves(st.master)]
                loss = gpt_loss(fsdp.gather(st.master, meta), tok, tok, cfg)
                grads = torch.autograd.grad(loss, shards)
                st = opt.step(tree_unflatten(st.master, list(grads)), st)
                losses.append(float(loss.detach()))
            final = unpad(st.master, params)
        out[label] = {"losses": losses, "final": final}
    trained = {}
    for preset in ("ddp", "zero1", "fsdp"):
        plan = ParallelismPlan.preset(preset)
        mesh = plan.mesh()
        step = build_train_step(cfg, 2, 32, device="cpu", plan=plan)[0]
        trained[preset] = [float(step()) for _ in range(3)]
    out["build_train_step"] = trained
    out["plan_mesh"] = dict(mesh.shape)
    try:
        ParallelismPlan.preset("fsdp", tp=world + 1).mesh()
    except ValueError as e:
        out["plan_mesh_refusal"] = str(e)
    return out


def bert_lamb(rank, world, steps, lr, batch, seq):
    """A 2-layer BERT (fp32) at dp = ``world`` on this rank's rows of a
    numpy-seeded MLM batch: DistributedFusedLAMB (the fused tail) beside
    DDP + FusedLAMB with the same hyperparameters, from seed 0 ->
    losses and final params of both."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.optimizers._common import (tree_leaves,
                                                   tree_unflatten)
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.mesh import build_mesh
    from apex_tpu_torch.transformer.testing import (BertConfig,
                                                    bert_mlm_loss,
                                                    init_bert_params)

    build_mesh(tp=1, pp=1, sp=1)
    cfg = BertConfig(vocab_size=128, max_seq=seq, hidden=64, num_layers=2,
                     num_heads=2, dtype=torch.float32)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq))
    tgt = rng.integers(0, cfg.vocab_size, (batch, seq))
    lm = (rng.random((batch, seq)) < 0.15).astype(np.float32)
    types = (np.arange(seq) >= seq // 2).astype(np.int64)[None].repeat(
        batch, 0)
    rows = batch // world
    mine = slice(rank * rows, (rank + 1) * rows)
    tok, tgt, lm, types = (_t(x[mine]) for x in (tok, tgt, lm, types))
    hyper = dict(lr=lr, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 max_grad_norm=1.0, grad_averaging=True)
    out = {"jax_loaded": _loaded()}
    for label in ("dist_lamb", "fused_lamb"):
        params = init_bert_params(cfg, seed=0, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        losses = []
        if label == "dist_lamb":
            opt = DistributedFusedLAMB(fused_update="on", **hyper)
            st = opt.init(params)
        else:
            opt, ddp = FusedLAMB(leaves, **hyper), DistributedDataParallel()
        for _ in range(steps):
            loss = bert_mlm_loss(params, tok, tgt, lm, cfg,
                                 token_types=types)
            grads = torch.autograd.grad(loss, leaves)
            if label == "dist_lamb":
                new, st = opt.step(tree_unflatten(params, list(grads)), st,
                                   params)
                with torch.no_grad():
                    for p, n in zip(leaves, tree_leaves(new)):
                        p.copy_(n)
            else:
                for p, g in zip(leaves, ddp.average_gradients(list(grads))):
                    p.grad = g
                opt.step()
            losses.append(float(loss.detach()))
        out[label] = {"losses": losses,
                      "final": [p.detach().clone() for p in leaves]}
    return out
