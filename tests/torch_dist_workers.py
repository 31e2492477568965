"""Rank functions of the port's multi-process tests
(``tests/test_torch_{comm_dist,ddp,syncbn_dist}.py``).

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
