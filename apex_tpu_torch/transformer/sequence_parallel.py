"""Sequence (context) parallelism over the ``sp`` mesh axis: ring attention
and Ulysses all-to-all attention (counterpart of
``apex_tpu/transformer/sequence_parallel.py``).

* :func:`ring_attention` — each rank holds a (b, h, s/sp, d) shard of
  q, k and v. The K/V shards travel around the ring (one hop a step,
  posted before the step's chunk of attention, which hides it) while each
  rank's Q shard meets every chunk.
  - ``impl="auto"``: the chunked-flash ring, an ``autograd.Function``
    whose forward merges the chunks' ``(o, lse)`` by log-sum-exp and whose
    backward makes a second ring pass, each chunk's flash backward run
    against the saved global ``lse`` (so its probabilities are the global
    softmax's columns); the dK / dV accumulators ride the ring with their
    chunk and arrive home complete. Causal rings skip wholly-future chunks
    and run the diagonal chunk causal. ``bias_strip`` (this rank's rows
    against every global column, T5's relative bias) is sliced a chunk a
    step and its gradient written back by columns. Dropout is the flash
    kernels' counter hash at the chunk's global offsets (``q_off = rank ·
    s_local``, ``k_off = origin · s_local``): the ring drops exactly the
    entries of a dense call with the same seed. On CUDA tensors the chunks
    run the flash kernels (#5-8, with those offsets) where JAX's gate
    takes them; elsewhere their plain versions.
  - ``impl="scan"``: the einsum online-softmax ring, differentiated by
    autograd through the hops (``comm.overlap.ring_shift``: a hop's
    backward sends its cotangent back the other way); with
    ``remat_steps`` each step's math is recomputed in backward, so no
    step's (s, s) scores are kept.
* :func:`ulysses_attention` — ``all_to_all_single`` re-shards sequence →
  heads, dense flash attention runs over the whole sequence for h/sp
  heads, and a second all-to-all re-shards back; dropout folds the sp rank
  into the seed (``comm.collectives.fold_seed``), as JAX does.

On an sp axis of one rank both are the dense ``flash_attention``'s
results (the ring has no hop; Ulysses calls ``flash_attention``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch.comm import collectives as coll
from apex_tpu_torch.comm.overlap import _Ring, ring_shift
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.ops.attention import (
    NEG_INF,
    _pallas_ok,
    flash_attention,
    flash_attention_bwd_dbias,
    flash_attention_bwd_dbias_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from apex_tpu_torch.parallel.mesh import SP_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import axis_info
from apex_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint_saving,
    saved_output,
)


def ring_attention(q, k, v, axis_name: str = SP_AXIS, causal: bool = False,
                   scale: Optional[float] = None, remat_steps: bool = True,
                   impl: str = "auto", bias_strip=None,
                   dropout_rate: float = 0.0, dropout_seed=None):
    """Exact attention over a sequence sharded on ``axis_name``:
    ``q``/``k``/``v`` are this rank's (b, h, s_local, d) shards (global
    sequence = sp · s_local, shards in rank order); returns this rank's
    shard of the dense result. ``bias_strip``: (h, s_local, sp ·
    sk_local), batch-shared, differentiable. ``dropout_rate`` > 0 needs
    ``dropout_seed`` (an int, the same on every sp rank) and ``impl=
    "auto"``. ``remat_steps`` (JAX's default True) recomputes each step
    of the einsum scan in backward, as JAX's ``jax.checkpoint`` of the
    step (the chunked-flash ring keeps no (s, s) tensor either way)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")
    if impl == "auto":
        b, h, s_loc, d = q.shape
        n = axis_info(axis_name)[1]
        if bias_strip is not None:
            want = (h, s_loc, n * k.shape[2])
            if tuple(bias_strip.shape) != want:
                raise ValueError(
                    f"bias_strip must be (heads, s_local, sp*sk_local) = "
                    f"{want}, got {tuple(bias_strip.shape)}")
        seed = 0 if dropout_seed is None else int(dropout_seed)
        return _RingFlash.apply(q, k, v, bias_strip, axis_name, bool(causal),
                                float(scale), float(dropout_rate), seed)
    if impl != "scan":
        raise ValueError(f"impl must be 'auto' or 'scan', got {impl!r}")
    if bias_strip is not None:
        raise NotImplementedError("bias_strip needs impl='auto'")
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout needs impl='auto'")
    return _ring_scan(q, k, v, axis_name, causal, scale, remat_steps)


# ---------------------------------------------------------------------------
# the chunked-flash ring


def _chunk_fwd(q3, k3, v3, scale, causal, kernel, bias_c, rate, seed, q_off,
               k_off):
    """One Q shard against one K/V chunk: ``(o, lse)``, lse (bh, s, 1)."""
    if kernel:
        return flash_attention_fwd(q3, k3, v3, scale, causal, rate, seed,
                                   bias=bias_c, q_off=q_off, k_off=k_off)
    return flash_attention_fwd_reference(q3, k3, v3, scale, causal, rate,
                                         seed, bias=bias_c, q_off=q_off,
                                         k_off=k_off)


def _chunk_bwd(q3, k3, v3, o3, lse, do3, delta, scale, causal, kernel,
               bias_c, want_dbias, rate, seed, q_off, k_off):
    """The chunk's flash backward against the global lse: ``(dq, dk, dv,
    dbias or None)``, fp32."""
    args = (scale, causal, rate, seed)
    offs = dict(q_off=q_off, k_off=k_off)
    db = None
    if kernel:
        dq = flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, *args,
                                    bias=bias_c, **offs)
        dk, dv = flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, *args,
                                         bias=bias_c, **offs)
        if want_dbias:
            db = flash_attention_bwd_dbias(q3, k3, v3, do3, lse, delta,
                                           *args, bias=bias_c, **offs)
    else:
        dq, dk, dv = flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3,
                                                   *args, bias=bias_c, **offs)
        if want_dbias:
            db = flash_attention_bwd_dbias_reference(
                q3, k3, v3, o3, lse, do3, *args, bias=bias_c, **offs)
    return dq.float(), dk.float(), dv.float(), db


def _branch(origin: int, my: int, causal: bool) -> str:
    if not causal:
        return "full"
    return "diag" if origin == my else ("full" if origin < my else "skip")


class _RingFlash(ku.OpaqueFunction):
    """The chunked-flash ring (JAX's ``_ring_flash`` / ``_ring_flash_biased``
    ``custom_vjp``\\ s). Its forward's ``(o, lse)`` are marked ``"attn"``,
    as the dense flash's: a ``dots_attn`` checkpoint keeps them and the
    backward ring starts from them without replaying the forward ring."""

    @staticmethod
    def forward(ctx, q, k, v, bias_strip, axis_name, causal, scale, rate,
                seed):
        b, h, s, d = q.shape
        sk = k.shape[2]
        q3 = q.reshape(b * h, s, d).contiguous()
        k3 = k.reshape(b * h, sk, d).contiguous()
        v3 = v.reshape(b * h, sk, d).contiguous()
        kernel = ku.use_kernel(q3) and _pallas_ok(s, sk, d, False)
        strip = None if bias_strip is None else bias_strip.float()
        ctx.cfg = (axis_name, causal, scale, rate, seed, kernel, (b, h))
        ctx.strip_dtype = None if bias_strip is None else bias_strip.dtype

        def run():
            ring = _Ring("ring_attention", axis_name)
            n, my = ring.world, ring.index
            o_bar = torch.zeros(b * h, s, d, dtype=torch.float32,
                                device=q.device)
            lse = torch.full((b * h, s, 1), NEG_INF, dtype=torch.float32,
                             device=q.device)
            k_c, v_c = k3, v3
            for t in range(n):
                hop = (ring.post([(k_c, 1), (v_c, 1)]) if t < n - 1
                       else None)
                origin = (my - t) % n
                branch = _branch(origin, my, causal)
                if branch != "skip":
                    bias_c = None if strip is None else strip[
                        :, :, origin * sk:(origin + 1) * sk].contiguous()
                    ring.products += 1
                    o_c, lse_c = _chunk_fwd(
                        q3, k_c, v_c, scale, branch == "diag", kernel,
                        bias_c, rate, seed, my * s, origin * sk)
                    lse_new = torch.logaddexp(lse, lse_c)
                    o_bar = (o_bar * torch.exp(lse - lse_new)
                             + o_c.float() * torch.exp(lse_c - lse_new))
                    lse = lse_new
                if hop is not None:
                    k_c, v_c = hop.wait()
            ring.done()
            return o_bar.to(q.dtype), lse

        o3, lse = saved_output("attn", run)
        ctx.save_for_backward(q3, k3, v3, strip, o3, lse)
        return o3.reshape(b, h, s, d)

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, strip, o3, lse = ctx.saved_tensors
        axis_name, causal, scale, rate, seed, kernel, (b, h) = ctx.cfg
        bh, s, d = q3.shape
        sk = k3.shape[1]
        do3 = do.reshape(bh, s, d).to(q3.dtype).contiguous()
        delta = (do3.float() * o3.float()).sum(dim=-1, keepdim=True)
        want_db = strip is not None and ctx.needs_input_grad[3]
        ring = _Ring("ring_attention.bwd", axis_name)
        n, my = ring.world, ring.index
        dq = torch.zeros(bh, s, d, dtype=torch.float32, device=q3.device)
        dk_acc = torch.zeros(bh, sk, d, dtype=torch.float32, device=q3.device)
        dv_acc = torch.zeros_like(dk_acc)
        db = (torch.zeros_like(strip) if want_db else None)
        k_c, v_c = k3, v3
        for t in range(n):
            hop = ring.post([(k_c, 1), (v_c, 1)]) if t < n - 1 else None
            origin = (my - t) % n
            branch = _branch(origin, my, causal)
            if branch != "skip":
                bias_c = None if strip is None else strip[
                    :, :, origin * sk:(origin + 1) * sk].contiguous()
                ring.products += 1
                g = _chunk_bwd(q3, k_c, v_c, o3, lse, do3, delta, scale,
                               branch == "diag", kernel, bias_c, want_db,
                               rate, seed, my * s, origin * sk)
                dq = dq + g[0]
                dk_acc = dk_acc + g[1]
                dv_acc = dv_acc + g[2]
                if want_db:
                    db[:, :, origin * sk:(origin + 1) * sk] = g[3]
            if hop is not None:
                k_c, v_c = hop.wait()
            if n > 1:
                # the accumulators ride the ring with their chunk: after n
                # hops each is home, complete
                dk_acc, dv_acc = ring.post([(dk_acc, 1),
                                            (dv_acc, 1)]).wait()
        ring.done()
        shape = (b, h, s, d)
        dqo = dq.to(q3.dtype).reshape(shape)
        dko = dk_acc.to(k3.dtype).reshape(b, h, sk, d)
        dvo = dv_acc.to(v3.dtype).reshape(b, h, sk, d)
        if db is not None:
            db = db.to(ctx.strip_dtype)
        return dqo, dko, dvo, db, None, None, None, None, None


# ---------------------------------------------------------------------------
# the einsum scan


def _scan_step(q32, k_c, v_c, m, l, acc, qpos, kpos, scale):
    """One step of the online softmax: this rank's queries against one
    K/V chunk, the carries (m, l, acc) updated. ``kpos`` is None for a
    non-causal ring."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q32, k_c.float()) * scale
    if kpos is not None:
        sc = torch.where(kpos[None, :] > qpos[:, None], NEG_INF, sc)
    m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
    p = torch.exp(sc - m_new)
    p = torch.where(sc <= NEG_INF / 2, 0.0, p)
    corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
    l = corr * l + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, v_c.float())
    return m_new, l, acc


def _ring_scan(q, k, v, axis_name, causal, scale, remat_steps):
    """Online-softmax einsum ring; masked entries are zeroed by value, so
    wholly-future chunks add exactly nothing. With ``remat_steps`` each
    step's math runs under a non-reentrant checkpoint (JAX's per-step
    ``jax.checkpoint``): backward keeps the step's carries and chunk, not
    its (s, s) scores, and recomputes them. The hops stay outside the
    checkpoint, so a recompute issues no collective."""
    _, n, my = axis_info(axis_name)
    b, h, s, d = q.shape
    q32 = q.float()
    qpos = my * s + torch.arange(s, device=q.device)
    m = torch.full((b, h, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    step = _scan_step
    if remat_steps and torch.is_grad_enabled():
        step = checkpoint_saving(_scan_step)
    k_c, v_c = k, v
    for t in range(n):
        origin = (my - t) % n
        kpos = (origin * s + torch.arange(s, device=q.device) if causal
                else None)
        m, l, acc = step(q32, k_c, v_c, m, l, acc, qpos, kpos, scale)
        if t < n - 1:
            k_c = ring_shift(k_c, axis_name, 1, "ring_attention.scan")
            v_c = ring_shift(v_c, axis_name, 1, "ring_attention.scan")
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


# ---------------------------------------------------------------------------
# Ulysses


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all: ``x`` split in W along ``split`` (piece j to rank
    j), the received pieces concatenated along ``concat`` in rank order;
    the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, axis_name, split, concat, tag):
        ctx.args = (axis_name, split, concat, tag)
        return _all_to_all(x, axis_name, split, concat, tag)

    @staticmethod
    def backward(ctx, g):
        axis_name, split, concat, tag = ctx.args
        return (_all_to_all(g, axis_name, concat, split, tag), None, None,
                None, None)


def all_to_all_dims(x, axis_name: str, split: int, concat: int,
                    tag: str = "ulysses"):
    """The differentiable tiled all-to-all over ``axis_name`` (piece j of
    ``x`` along ``split`` to rank j, the received pieces concatenated
    along ``concat``; backward the inverse exchange), entered into the
    ``comm.accounting`` records under ``tag``."""
    return _AllToAll.apply(x, axis_name, split, concat, tag)


def _all_to_all(x, axis_name, split, concat, tag):
    group, world, _ = axis_info(axis_name)
    pieces = torch.stack(x.chunk(world, dim=split)).contiguous()
    out = coll.all_to_all(pieces.reshape(-1), group, world, tag=tag)
    out = out.view(pieces.shape)
    return torch.cat(out.unbind(0), dim=concat)


def ulysses_attention(q, k, v, axis_name: str = SP_AXIS,
                      causal: bool = False, scale: Optional[float] = None,
                      use_pallas: Optional[bool] = None,
                      dropout_rate: float = 0.0, dropout_seed=None):
    """All-to-all sequence parallelism: (b, h, s_local, d) shards → (b,
    h/sp, s, d) head slices, dense flash attention, and back. Needs heads
    % sp == 0. Dropout folds the sp rank into the seed (each rank's heads
    draw their own stream; the masks depend on the layout, unlike the
    ring's). ``use_pallas`` is JAX's knob: ``False`` takes the plain
    attention on every device."""
    _, n, my = axis_info(axis_name)
    b, h, s_loc, d = q.shape
    if h % n != 0:
        raise ValueError(f"ulysses needs heads ({h}) % sp ({n}) == 0")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")

    def attend(q, k, v, seed):
        if use_pallas is False:
            from apex_tpu_torch.ops.attention import (
                attention_dropout_mask,
                attention_reference,
            )

            bq, hq, sq, _ = q.shape
            keep = None
            if dropout_rate > 0.0:
                keep = attention_dropout_mask(
                    seed, dropout_rate, bq * hq, sq, k.shape[2],
                    device=q.device).reshape(bq, hq, sq, k.shape[2])
            return attention_reference(q, k, v, scale=scale, causal=causal,
                                       dropout_rate=dropout_rate,
                                       dropout_keep=keep)
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               dropout_rate=dropout_rate, dropout_seed=seed)

    if n == 1:
        return attend(q, k, v, dropout_seed)
    seed = dropout_seed
    if dropout_rate > 0.0:
        seed = coll.fold_seed(dropout_seed, my)

    def to_heads(x):
        return all_to_all_dims(x, axis_name, 1, 2)

    o = attend(to_heads(q), to_heads(k), to_heads(v), seed)
    return all_to_all_dims(o, axis_name, 2, 1)
