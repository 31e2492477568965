"""RNN-T joint and alpha recursion loss (counterpart of
``apex_tpu/contrib/transducer/transducer.py``).

The joint is a broadcast add (with ReLU and dropout) that PyTorch runs as
elementwise ops; with ``pack_output`` the valid (t, u) cells are gathered
straight into their packed rows. The loss is the log-space alpha
recursion, run over the lattice's anti-diagonals: every cell of diagonal
t + u = d depends only on diagonal d - 1, so T + U steps of a few
(batch, U + 1) device ops compute it, with no value read back to the host
on the way; the gradient comes from autograd through the steps. JAX has
no Pallas kernel here, so this module has none.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.contrib.multihead_attn.modules import bernoulli_keep

NEG = -1e30


def _drop(out, dropout_rate, dropout_rng):
    """JAX's ``where(bernoulli(rng, 1 - rate, shape), out / (1 - rate),
    0)``."""
    keep = bernoulli_keep(dropout_rng, dropout_rate, tuple(out.shape),
                          out.device)
    return torch.where(keep, out / (1.0 - dropout_rate),
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _packed_cell_coords(batch_offset, per_batch_len, packed_batch: int):
    """Packed row r -> (b, local, valid): batch b's cells are rows
    [offset[b] - per_batch_len[b], offset[b])."""
    r = torch.arange(packed_batch, device=batch_offset.device)
    b = torch.searchsorted(batch_offset, r, right=True)
    b = b.clamp(0, batch_offset.shape[0] - 1)
    start = batch_offset[b] - per_batch_len[b]
    return b, r - start, r < batch_offset[-1]


def transducer_joint(f, g, f_len=None, g_len=None, *, relu: bool = False,
                     dropout_rate: float = 0.0, dropout_rng=None,
                     pack_output: bool = False, batch_offset=None,
                     packed_batch: int = 0):
    """``f`` (B, T, H) + ``g`` (B, U, H) -> (B, T, U, H), cells past
    ``f_len`` / ``g_len`` zero. With ``pack_output``: (packed_batch, H),
    batch b's cell (t, u) at row ``batch_offset[b-1] + t * g_len[b] + u``
    (``batch_offset = cumsum(f_len * g_len)``), surplus rows zero.
    Dropout (``dropout_rng``, a threefry key) keeps JAX's bernoulli bits."""
    drop = dropout_rate > 0.0 and dropout_rng is not None
    if pack_output:
        if (batch_offset is None or packed_batch == 0 or f_len is None
                or g_len is None):
            raise ValueError(
                "pack_output needs f_len, g_len, batch_offset "
                "(= cumsum(f_len * g_len)) and a static packed_batch")
        b, local, valid = _packed_cell_coords(batch_offset, f_len * g_len,
                                              packed_batch)
        g_safe = g_len[b].clamp(min=1)
        out = f[b, local // g_safe] + g[b, local % g_safe]
        if relu:
            out = torch.relu(out)
        if drop:
            out = _drop(out, dropout_rate, dropout_rng)
        return out * valid[:, None]
    out = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        out = torch.relu(out)
    if drop:
        out = _drop(out, dropout_rate, dropout_rng)
    if f_len is not None:
        t_mask = (torch.arange(f.shape[1], device=f.device)[None, :]
                  < f_len[:, None])
        out = out * t_mask[:, :, None, None]
    if g_len is not None:
        u_mask = (torch.arange(g.shape[1], device=g.device)[None, :]
                  < g_len[:, None])
        out = out * u_mask[:, None, :, None]
    return out


def unpack_transducer_input(x_packed, f_len, y_len, batch_offset,
                            max_f_len: int, max_u1: int):
    """Packed loss input (packed_batch, V) -> dense (B, max_f_len, max_u1,
    V): batch b's cell (t, u) is row ``batch_offset[b-1] + t * (y_len[b] +
    1) + u``; invalid cells are 0."""
    dev = x_packed.device
    t = torch.arange(max_f_len, device=dev)[None, :, None]
    u = torch.arange(max_u1, device=dev)[None, None, :]
    u1 = (y_len + 1)[:, None, None]
    start = (batch_offset - f_len * (y_len + 1))[:, None, None]
    rows = (start + t * u1 + u).clamp(0, x_packed.shape[0] - 1)
    valid = (t < f_len[:, None, None]) & (u < u1)
    return torch.where(valid[..., None], x_packed[rows],
                       torch.zeros((), dtype=x_packed.dtype, device=dev))


def _skew(lattice, t_of_d_u):
    """``lattice`` (B, T, U1) read along anti-diagonals: (B, D, U1) with
    entry [b, d, u] = lattice[b, t_of_d_u[d, u], u], NEG where that t is
    outside [0, T)."""
    B, T, U1 = lattice.shape
    valid = (t_of_d_u >= 0) & (t_of_d_u < T)
    idx = t_of_d_u.clamp(0, T - 1)
    u = torch.arange(U1, device=lattice.device)[None, :].expand_as(idx)
    out = lattice[:, idx, u]
    return torch.where(valid, out, torch.full((), NEG, dtype=out.dtype,
                                              device=out.device))


def transducer_loss(x, label, f_len, y_len, blank_idx: int = 0):
    """Per-sequence RNN-T negative log-likelihood (JAX's
    ``transducer_loss``): ``x`` (B, T, U+1, V) joint log-probs, ``label``
    (B, U) ints, ``f_len`` / ``y_len`` (B,) valid frames and labels.

    alpha[0, 0] = 0, alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1,
    u], alpha[t, u-1] + emit[t, u-1]) (one term on the lattice's edges);
    nll = -(alpha[f_len-1, y_len] + blank[f_len-1, y_len]). Each cell's
    arithmetic is JAX's; the cells of one anti-diagonal are computed
    together."""
    B, T, U1, V = x.shape
    U = U1 - 1
    dev = x.device
    blank = x[..., blank_idx]                                   # (B, T, U1)
    emit = torch.gather(x[:, :, :U, :], 3,
                        label[:, None, :, None].expand(B, T, U, 1).long()
                        )[..., 0]                               # (B, T, U)
    # emit[t, u - 1] placed at column u (column 0 never emits)
    emit1 = torch.cat([torch.full((B, T, 1), NEG, dtype=x.dtype,
                                  device=dev), emit], dim=2)    # (B, T, U1)
    D = T + U1 - 1
    d = torch.arange(D, device=dev)[:, None]
    u = torch.arange(U1, device=dev)[None, :]
    blank_in = _skew(blank, d - 1 - u)   # blank[t-1, u] into cell (t, u)
    emit_in = _skew(emit1, d - u)        # emit[t, u-1] into cell (t, u)
    live = ((d - u) >= 0) & ((d - u) < T)                       # (D, U1)
    neg = torch.full((), NEG, dtype=x.dtype, device=dev)
    cur = torch.where(u == 0, torch.zeros((), dtype=x.dtype, device=dev),
                      neg).expand(B, U1)
    diags = [cur]
    for k in range(1, D):
        horiz = cur + blank_in[:, k]
        vert = torch.cat([neg.expand(B, 1), cur[:, :-1] + emit_in[:, k, 1:]],
                         dim=1)
        both = torch.logaddexp(horiz, vert)
        # an edge cell takes its one term exactly, as JAX's recursion
        step = torch.where(u == 0, horiz, torch.where(
            (d[k] - u) == 0, vert, both))
        cur = torch.where(live[k], step, neg)
        diags.append(cur)
    alpha = torch.stack(diags, dim=1)                           # (B, D, U1)
    t_end = (f_len - 1).clamp(0, T - 1).long()
    yl = y_len.long()
    bi = torch.arange(B, device=dev)
    final_alpha = alpha[bi, t_end + yl, yl]
    final_blank = blank[bi, t_end, yl]
    return -(final_alpha + final_blank)


class TransducerJoint(nn.Module):
    """JAX's ``TransducerJoint(pack_output, relu, dropout)``: dropout only
    when a ``dropout_rng`` is given."""

    def __init__(self, pack_output: bool = False, relu: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.pack_output, self.relu, self.dropout = pack_output, relu, dropout

    def forward(self, f, g, f_len=None, g_len=None, dropout_rng=None,
                batch_offset=None, packed_batch: int = 0):
        return transducer_joint(
            f, g, f_len, g_len, relu=self.relu,
            dropout_rate=self.dropout if dropout_rng is not None else 0.0,
            dropout_rng=dropout_rng, pack_output=self.pack_output,
            batch_offset=batch_offset, packed_batch=packed_batch)


class TransducerLoss(nn.Module):
    """JAX's ``TransducerLoss``: ``x`` the raw joint activations,
    log-softmax in fp32 here (autograd carries the softmax backward into
    the loss's); with ``packed_input``, ``x`` is the (packed_batch, V)
    lattice of a packing joint (``batch_offset = cumsum(f_len * (y_len +
    1))``, ``max_f_len`` given), unpacked after the log-softmax."""

    def __init__(self, fuse_softmax_backward: bool = True,
                 packed_input: bool = False):
        super().__init__()
        self.fuse_softmax = fuse_softmax_backward
        self.packed_input = packed_input

    def forward(self, x, label, f_len, y_len, blank_idx: int = 0,
                batch_offset=None, max_f_len: Optional[int] = None):
        logp = torch.log_softmax(x.to(torch.float32), dim=-1)
        if self.packed_input:
            if batch_offset is None or max_f_len is None:
                raise ValueError(
                    "packed_input needs batch_offset "
                    "(= cumsum(f_len * (y_len + 1))) and a static max_f_len")
            logp = unpack_transducer_input(logp, f_len, y_len, batch_offset,
                                           max_f_len, label.shape[1] + 1)
        return transducer_loss(logp, label, f_len, y_len, blank_idx)
