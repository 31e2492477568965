"""LayerNorm and RMSNorm: plain PyTorch versions + the CUDA forward and
backward kernels (counterpart of ``apex_tpu/ops/layer_norm.py``).

Dispatch is JAX's: :func:`_pallas_ok` (``_pick_block_rows`` and the VMEM
budget arithmetic, under JAX's names) decides whether a shape takes the
kernels. Inside the gate a CUDA tensor launches the ``csrc/layer_norm.cu``
kernels (:func:`layer_norm_fwd` / :func:`layer_norm_bwd`,
:func:`rms_norm_fwd` / :func:`rms_norm_bwd`) and a CPU tensor runs their
plain versions; outside it, and for the non-affine forms, every device
runs the reference, as JAX does. ``use_pallas=True`` outside the gate
raises ``ValueError`` with JAX's wording; ``use_pallas=False`` is the
reference. Inside the gate a kernel that fails raises: there is no
fallback.

x and the weight each have their own type (:data:`_TYPE_PAIRS`: fp32 or
bf16 beside fp32 or bf16 x, fp16 or fp32 beside fp16 x): everything is
computed in fp32, y and dx come back in x's type and dw/db in the
weight's, as JAX's kernels return them. The affine forms are
differentiable through :class:`LayerNormAffine` and :class:`RMSNormAffine`
(JAX's ``custom_vjp``\\ s, ``layer_norm.py:180-314``): the forward saves x,
the weight and the fp32 row statistics, and the backward is the backward
kernel (or its plain version).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import _kernel_util as ku

_SIGNATURES = {
    "layer_norm_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "layer_norm_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    "rms_norm_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "rms_norm_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}
# x's type -> the weight types the kernels take beside it
# (csrc/layer_norm.cu APEX_NORM_DISPATCH)
_TYPE_PAIRS = {torch.float32: (torch.float32, torch.bfloat16),
               torch.bfloat16: (torch.bfloat16, torch.float32),
               torch.float16: (torch.float16, torch.float32)}


# ---------------------------------------------------------------------------
# the forward's geometry (``csrc/layer_norm.cu``): a function of hidden
# alone, so a row's y, mean and rstd do not depend on the call holding it

_FWD_UNIT = 4            # columns of a chunk (16 B of fp32, 8 B of bf16)
# a team of up to 16 warps holds up to 6 chunks a thread of a row: one warp
# up to 768 columns, eight one-warp teams a block
_FWD_TEAM_CHUNKS = 6
_FWD_TEAM_WARPS = 16
# above 16 warps' 6 chunks (12,288 columns) a team is one block of up to
# 32 warps, up to 12 chunks a thread (49,152 columns, the backward's
# widest too)
_FWD_WIDE_CHUNKS = 12
_FWD_MAX_WARPS = 32
_FWD_BLOCK_WARPS = 8     # narrow teams share a block of up to 8 warps


class FwdPlan(NamedTuple):
    """The forward's launch geometry: a row belongs to a team of
    ``team_warps`` warps, ``teams`` teams a block; thread t of a team owns
    the 4-column chunks ``t + j·32·team_warps``, j < ``chunks``, of every
    row."""
    team_warps: int
    teams: int
    chunks: int


def _fwd_plan(hidden: int) -> FwdPlan:
    """The forward's geometry for a row of ``hidden`` columns (a multiple
    of 4): the fewest warps that hold it at up to 6 chunks a thread (eight
    one-warp teams a block up to 768 columns, up to 16 warps to 12,288),
    past that one team of up to 32 warps at the fewest chunks that hold
    it, at most 12 (49,152 columns)."""
    units = -(-hidden // _FWD_UNIT)
    warps = max(1, -(-units // (32 * _FWD_TEAM_CHUNKS)))
    if warps > _FWD_TEAM_WARPS:
        chunks = -(-units // (32 * _FWD_MAX_WARPS))
        if chunks > _FWD_WIDE_CHUNKS:
            raise ValueError(
                f"norm forward: hidden {hidden} needs {chunks} chunks of "
                f"{_FWD_UNIT} columns a thread of a 1,024-thread block (at "
                f"most {_FWD_WIDE_CHUNKS}: "
                f"{_FWD_WIDE_CHUNKS * 32 * _FWD_MAX_WARPS * _FWD_UNIT} "
                f"columns)")
        warps = -(-units // (32 * chunks))
        return FwdPlan(warps, 1, chunks)
    chunks = -(-units // (32 * warps))
    return FwdPlan(warps, max(1, _FWD_BLOCK_WARPS // warps), chunks)


# ---------------------------------------------------------------------------
# the backward's geometry (``csrc/layer_norm.cu``): a function of (rows,
# hidden) alone, so dx/dw/db repeat bitwise

_BWD_UNIT = 8            # columns of a chunk (16 B of bf16, 32 B of fp32)
# chunks a thread holds in registers, at most (at 4 LayerNorm's pass takes
# 170 registers a thread: one block an SM)
_BWD_MAX_CHUNKS = 3
_BWD_BLOCK_WARPS = 8     # warps of a block, at most
_BWD_MAX_CLUSTER = 8     # blocks of a cluster (the portable limit)
_BWD_TARGET_BLOCKS = 256  # ~2 blocks a streaming multiprocessor
# rows of a part, at least: its fp32 dw and db rows (8 B a column) stay
# under 8/(6·16) = 8.3 % of a bf16 LN backward's bound bytes (6 B a
# column a row: dy, x read, dx written)
_BWD_MIN_ROWS = 16
_BWD_SLICES = 32         # part slices of the final sum


class BwdPlan(NamedTuple):
    """The backward's launch geometry: ``parts`` parts of
    ``rows_per_part`` consecutive rows, each one block or a cluster of
    ``cluster`` blocks (each owning every cluster-th chunk of 8 columns);
    a block holds ``teams`` teams of ``team_warps`` warps, a team walking
    the part's rows ``team, team + teams, ...`` in order; a thread holds
    ``chunks`` chunks of every row."""
    parts: int
    rows_per_part: int
    cluster: int
    team_warps: int
    teams: int
    chunks: int


def _bwd_plan(rows: int, hidden: int) -> BwdPlan:
    """The backward's geometry for (rows, hidden), hidden % 8 == 0: the
    fewest warps that hold a row at up to 3 chunks a thread (one warp up
    to 768 columns), eight to a block, past that a cluster; at least
    :data:`_BWD_MIN_ROWS` rows a part and about
    :data:`_BWD_TARGET_BLOCKS` blocks."""
    units = hidden // _BWD_UNIT
    warps = max(1, -(-units // (32 * _BWD_MAX_CHUNKS)))
    cluster = -(-warps // _BWD_BLOCK_WARPS)
    if cluster > _BWD_MAX_CLUSTER:
        raise ValueError(f"layer-norm backward: hidden {hidden} needs a "
                         f"cluster of {cluster} blocks (at most "
                         f"{_BWD_MAX_CLUSTER})")
    team_warps = -(-warps // cluster)
    chunks = max(1, -(-units // (32 * team_warps * cluster)))
    teams = _BWD_BLOCK_WARPS // team_warps if cluster == 1 else 1
    rows_per_part = max(_BWD_MIN_ROWS,
                        -(-rows // (_BWD_TARGET_BLOCKS // cluster)))
    parts = max(1, -(-rows // rows_per_part))
    return BwdPlan(parts, rows_per_part, cluster, team_warps, teams, chunks)


# ---------------------------------------------------------------------------
# dispatch: JAX's gate (``apex_tpu/ops/layer_norm.py:147-170``), under its
# names

# JAX budgets half a TPU core's VMEM for the backward's ~7 block-sized
# fp32 buffers; the row block shrinks with hidden, and past the budget the
# shape takes the reference
_VMEM_BUDGET_BYTES = 8 * 1024 * 1024
_BWD_LIVE_BUFFERS = 7


def _pick_block_rows(rows: int, hidden: int) -> Optional[int]:
    for cand in (256, 128, 64, 32, 16, 8):
        if (rows % cand == 0
                and cand * hidden * 4 * _BWD_LIVE_BUFFERS
                <= _VMEM_BUDGET_BYTES):
            return cand
    return None


def _pallas_ok(rows: int, hidden: int) -> bool:
    """Whether JAX runs its kernels at this shape (``_pallas_ok`` with
    ``allow_interpret=True``): a row block of 8-256 rows divides ``rows``
    and fits the VMEM budget at this hidden, and hidden % 128 == 0."""
    if _pick_block_rows(rows, hidden) is None:
        return False
    return hidden % 128 == 0


def _use_pallas(what: str, x, use_pallas: Optional[bool]) -> bool:
    """JAX's dispatch of ``layer_norm`` / ``rms_norm``: None takes the
    kernels where the gate holds, True raises outside it."""
    hidden = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    if use_pallas is None:
        return _pallas_ok(rows, hidden)
    if use_pallas and not _pallas_ok(rows, hidden):
        raise ValueError(
            f"pallas {what} requires row count divisible by 8, hidden "
            f"% 128 == 0, and a row block fitting VMEM at this hidden size; "
            f"got shape {tuple(x.shape)}")
    return bool(use_pallas)


# ---------------------------------------------------------------------------
# plain versions


def layer_norm_fwd_reference(x2d, weight=None, bias=None, eps: float = 1e-5):
    """Plain version of the forward kernel with its statistics: fp32
    statistics with E[x²]−E[x]² clamped at 0 (the JAX reference's exact
    form), then ``x̂·w + b`` cast back to x2d.dtype. Returns ``(y, mean,
    rstd)``, mean and rstd fp32 of shape (rows,)."""
    x32 = x2d.float()
    mean = x32.mean(dim=-1)
    var = torch.clamp((x32 * x32).mean(dim=-1) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean[:, None]) * rstd[:, None]
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2d.dtype), mean, rstd


def layer_norm_reference(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last axis of any shape: the forward reference's
    ``y`` alone."""
    y, _, _ = layer_norm_fwd_reference(x.reshape(-1, x.shape[-1]), weight,
                                       bias, eps)
    return y.reshape(x.shape)


def layer_norm_bwd_reference(dy, x2d, mean, rstd, weight):
    """Plain version of the backward kernel (the JAX kernel's formula, not
    autograd), all in fp32: ``g = dy·w``, ``dx = rstd·(g − mean(g) −
    x̂·mean(g·x̂))``, ``dw = Σ dy·x̂``, ``db = Σ dy``. Returns ``dx`` in
    x2d's type and ``dw``, ``db`` in the weight's type."""
    dy32, x32 = dy.float(), x2d.float()
    xhat = (x32 - mean[:, None]) * rstd[:, None]
    g = dy32 * weight.float()
    c1 = g.mean(dim=-1, keepdim=True)
    c2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (g - c1 - xhat * c2) * rstd[:, None]
    dw = (dy32 * xhat).sum(dim=0)
    db = dy32.sum(dim=0)
    return dx.to(x2d.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def rms_norm_fwd_reference(x2d, weight=None, eps: float = 1e-5):
    """Plain version of the RMSNorm forward kernel with its statistic:
    ``rstd = rsqrt(mean(x²) + eps)`` in fp32, ``y = (x·rstd)·w`` cast back
    to x2d.dtype. Returns ``(y, rstd)``, rstd fp32 of shape (rows,)."""
    x32 = x2d.float()
    rstd = torch.rsqrt((x32 * x32).mean(dim=-1) + eps)
    y = x32 * rstd[:, None]
    if weight is not None:
        y = y * weight.float()
    return y.to(x2d.dtype), rstd


def rms_norm_reference(x, weight=None, eps: float = 1e-5):
    """RMSNorm over the last axis of any shape (JAX's
    ``rms_norm_reference``): the forward reference's ``y`` alone."""
    y, _ = rms_norm_fwd_reference(x.reshape(-1, x.shape[-1]), weight, eps)
    return y.reshape(x.shape)


def rms_norm_bwd_reference(dy, x2d, rstd, weight):
    """Plain version of the RMSNorm backward kernel (``_rms_bwd_kernel``'s
    formula), all in fp32: ``x̂ = x·rstd``, ``g = dy·w``, ``dx = rstd·(g −
    x̂·mean(g·x̂))``, ``dw = Σ dy·x̂``. Returns ``dx`` in x2d's type and
    ``dw`` in the weight's."""
    dy32 = dy.float()
    xhat = x2d.float() * rstd[:, None]
    g = dy32 * weight.float()
    c2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (g - xhat * c2) * rstd[:, None]
    dw = (dy32 * xhat).sum(dim=0)
    return dx.to(x2d.dtype), dw.to(weight.dtype)


def _ordered_row_sums(v, plan: FwdPlan):
    """The forward kernel's sum of ``v`` (rows, hidden) fp32 over each
    row: each thread's chunks in order (4 columns each in order, zeros past
    the row), the warp's xor tree, then the team's warps in order."""
    rows, hidden = v.shape
    threads = plan.team_warps * 32
    width = plan.chunks * threads * _FWD_UNIT
    # [row, chunk j, thread t, column e] -> column (t + j·threads)·4 + e
    at = torch.nn.functional.pad(v, (0, width - hidden)).view(
        rows, plan.chunks, threads, _FWD_UNIT)
    acc = torch.zeros(rows, threads, dtype=torch.float32, device=v.device)
    for j in range(plan.chunks):
        for e in range(_FWD_UNIT):
            acc = acc + at[:, j, :, e]
    acc = acc.view(rows, plan.team_warps, 32)
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ o]
    total = acc[:, 0, 0]
    for k in range(1, plan.team_warps):
        total = total + acc[:, k, 0]
    return total


def norm_fwd_split_reference(x2d, weight, bias=None, eps: float = 1e-5,
                             rms: bool = False):
    """The plain emulation of the forward kernel's sum order, for the
    tests: the row sums of x (LayerNorm) and x² in :func:`_fwd_plan`'s
    order (:func:`_ordered_row_sums`), then the kernel's statistics and y
    as :func:`layer_norm_fwd_reference` / :func:`rms_norm_fwd_reference`
    form them. Returns ``(y, mean, rstd)``, or ``(y, rstd)`` with
    ``rms``."""
    hidden = x2d.shape[1]
    plan = _fwd_plan(hidden)
    x32 = x2d.float()
    # a true division (torch divides by a Python number through its
    # reciprocal); the kernel divides by hidden
    h = torch.full((x2d.shape[0],), float(hidden), device=x2d.device)
    ss = _ordered_row_sums(x32 * x32, plan)
    if rms:
        rstd = torch.rsqrt(ss / h + eps)
        y = (x32 * rstd[:, None]) * weight.float()
        return y.to(x2d.dtype), rstd
    mean = _ordered_row_sums(x32, plan) / h
    var = torch.clamp(ss / h - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((x32 - mean[:, None]) * rstd[:, None]) * weight.float()
    y = y + bias.float()
    return y.to(x2d.dtype), mean, rstd


def _ordered_part_sums(terms, plan: BwdPlan):
    """The kernels' sum of ``terms`` (rows, hidden) fp32 over the rows:
    per part, each team's rows in order, the teams in team order; then the
    parts in :data:`_BWD_SLICES` slices, each in part order, the slices in
    a fixed tree (slice s += slice s + w, w = 16, 8, 4, 2, 1)."""
    rows, hidden = terms.shape
    p, rpp, teams = plan.parts, plan.rows_per_part, plan.teams
    per_team = -(-rpp // teams)
    # [part, step, team] -> row part·rpp + step·teams + team, or the zero
    # row past the part or the rows (adding an fp32 zero is exact)
    at = (torch.arange(per_team)[:, None] * teams
          + torch.arange(teams)[None, :])
    row = torch.arange(p)[:, None, None] * rpp + at[None]
    row = torch.where((at[None] < rpp) & (row < rows), row, rows)
    by = torch.cat([terms, terms.new_zeros(1, hidden)])[row.to(terms.device)]
    acc = torch.zeros(p, teams, hidden, dtype=torch.float32,
                      device=terms.device)
    for i in range(per_team):
        acc = acc + by[:, i]
    parts = acc[:, 0]
    for k in range(1, teams):
        parts = parts + acc[:, k]
    per = -(-p // _BWD_SLICES)
    sl = []
    for i in range(_BWD_SLICES):
        s = torch.zeros(hidden, dtype=torch.float32, device=terms.device)
        for q in range(i * per, min((i + 1) * per, p)):
            s = s + parts[q]
        sl.append(s)
    w = _BWD_SLICES // 2
    while w:
        sl = [sl[i] + sl[i + w] for i in range(w)]
        w //= 2
    return sl[0]


def norm_bwd_split_reference(dy, x2d, mean, rstd, weight):
    """The plain emulation of the backward kernels' sum order, for the
    tests: dx as :func:`layer_norm_bwd_reference` (RMSNorm's when ``mean``
    is None), dw (and db for LayerNorm) summed over the rows in
    :func:`_bwd_plan`'s parts, teams and slices in the kernels' order
    (:func:`_ordered_part_sums`). Returns ``(dx, dw, db)`` or ``(dx,
    dw)``."""
    rows, hidden = x2d.shape
    plan = _bwd_plan(rows, hidden)
    dy32, x32 = dy.float(), x2d.float()
    if mean is None:
        dx, _ = rms_norm_bwd_reference(dy, x2d, rstd, weight)
        xhat = x32 * rstd[:, None]
    else:
        dx, _, _ = layer_norm_bwd_reference(dy, x2d, mean, rstd, weight)
        xhat = (x32 - mean[:, None]) * rstd[:, None]
    dw = _ordered_part_sums(dy32 * xhat, plan).to(weight.dtype)
    if mean is None:
        return dx, dw
    return dx, dw, _ordered_part_sums(dy32, plan).to(weight.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_rows(what, x2d, *vectors):
    """The kernels' shared input rules: 2-d contiguous CUDA (rows, hidden)
    x in fp32, bf16 or fp16; (hidden,) weight vectors of one type on x's
    device, a pair of :data:`_TYPE_PAIRS`; 16-byte aligned; hidden a
    multiple of x's 16-byte vector width."""
    ku.require(x2d.is_cuda and x2d.dim() == 2,
               f"{what} takes a 2-d CUDA tensor, got {x2d.device} "
               f"{tuple(x2d.shape)}")
    rows, hidden = x2d.shape
    ku.require(x2d.dtype in ku.KERNEL_DTYPES,
               f"{what} takes fp32, bf16 or fp16, got {x2d.dtype}")
    wdtype = vectors[0][1].dtype
    wants = _TYPE_PAIRS[x2d.dtype]
    for name, t in vectors:
        ku.require(t.device == x2d.device and t.dtype == wdtype
                   and wdtype in wants and tuple(t.shape) == (hidden,)
                   and t.is_contiguous(),
                   f"{what}: {name} must be a contiguous ({hidden},) tensor "
                   f"of one of {wants} on {x2d.device} (for {x2d.dtype} "
                   f"x), of the weight's type ({wdtype})")
    vec = 16 // x2d.element_size()
    ku.require(hidden % vec == 0,
               f"{what}: hidden ({hidden}) must be a multiple of {vec} for "
               f"16-byte vector loads")
    ku.require(x2d.is_contiguous(), f"{what}: x must be contiguous")
    ku.require(all(t.data_ptr() % 16 == 0
                   for t in (x2d, *(t for _, t in vectors))),
               f"{what}: tensors must be 16-byte aligned")
    ku.require(rows < 2 ** 31, f"{what}: too many rows")
    return rows, hidden


def _check_grad_in(what, dy, x2d, stats):
    """dy like x2d; each (name, t) of ``stats`` a contiguous (rows,) fp32
    tensor on x's device."""
    rows = x2d.shape[0]
    ku.require(dy.shape == x2d.shape and dy.dtype == x2d.dtype
               and dy.device == x2d.device and dy.is_contiguous()
               and dy.data_ptr() % 16 == 0,
               f"{what}: dy must be a contiguous, aligned "
               f"{tuple(x2d.shape)} {x2d.dtype} tensor like x")
    for name, t in stats:
        ku.require(t.device == x2d.device and t.dtype == torch.float32
                   and tuple(t.shape) == (rows,) and t.is_contiguous(),
                   f"{what}: {name} must be a contiguous ({rows},) "
                   f"fp32 tensor on {x2d.device}")


def _types(x2d, weight):
    return ku.dtype_code(x2d.dtype), ku.dtype_code(weight.dtype)


def _workspace(x2d, vectors: int):
    """(the backward's plan, its fp32 partial rows of ``vectors`` sums)."""
    rows, hidden = x2d.shape
    plan = _bwd_plan(rows, hidden)
    return plan, torch.empty(vectors * plan.parts * hidden,
                             dtype=torch.float32, device=x2d.device)


def _check_bwd_width(what, hidden):
    ku.require(hidden % _BWD_UNIT == 0,
               f"{what}: hidden ({hidden}) must be a multiple of "
               f"{_BWD_UNIT} (the backward's 8-column chunks)")


def layer_norm_fwd(x2d, weight, bias, eps: float = 1e-5, stats: bool = False):
    """Launch the LayerNorm forward kernel on CUDA tensors: ``x2d`` (rows,
    hidden) contiguous in fp32, bf16 or fp16, ``weight``/``bias`` (hidden,)
    of one type of :data:`_TYPE_PAIRS`, hidden up to 49,152
    (:func:`_fwd_plan` raises ``ValueError`` above). Returns y like x2d, or ``(y, mean, rstd)``
    (fp32, (rows,)) with ``stats``; a row's bits do not depend on the
    other rows of the call."""
    rows, hidden = _check_rows("layer_norm_fwd", x2d, ("weight", weight),
                               ("bias", bias))
    y = torch.empty_like(x2d)
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
        rstd = torch.empty_like(mean)
    plan = _fwd_plan(hidden)
    lib = ku.load_kernel("layer_norm", _SIGNATURES)
    status = lib.layer_norm_fwd(
        x2d.device.index, x2d.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), mean.data_ptr() if stats else None,
        rstd.data_ptr() if stats else None, rows, hidden, float(eps), *plan,
        *_types(x2d, weight), ku.stream_handle(x2d))
    ku.count_launch("layer_norm_fwd")
    ku.check_status(lib, status, "layer_norm_fwd")
    return (y, mean, rstd) if stats else y


def layer_norm_bwd(dy, x2d, mean, rstd, weight):
    """Launch the LayerNorm backward on CUDA tensors (one pass over dy and
    x writing dx and the per-part fp32 dw/db rows, then their ordered
    sum; one count): returns ``(dx, dw, db)``, dx like x2d, dw and db in
    the weight's type. dx/dw/db are bitwise the same for the same inputs
    (no atomics; :func:`_bwd_plan` depends on the shape alone)."""
    rows, hidden = _check_rows("layer_norm_bwd", x2d, ("weight", weight))
    _check_bwd_width("layer_norm_bwd", hidden)
    _check_grad_in("layer_norm_bwd", dy, x2d, (("mean", mean),
                                               ("rstd", rstd)))
    dx = torch.empty_like(x2d)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    plan, work = _workspace(x2d, 2)
    lib = ku.load_kernel("layer_norm", _SIGNATURES)
    status = lib.layer_norm_bwd(
        x2d.device.index, dy.data_ptr(), x2d.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), weight.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), work.data_ptr(), rows, hidden, *plan,
        *_types(x2d, weight), ku.stream_handle(x2d))
    ku.count_launch("layer_norm_bwd")
    ku.check_status(lib, status, "layer_norm_bwd")
    return dx, dw, db


def rms_norm_fwd(x2d, weight, eps: float = 1e-5, stats: bool = False):
    """Launch the RMSNorm forward kernel on CUDA tensors: ``x2d`` (rows,
    hidden) contiguous in fp32, bf16 or fp16, ``weight`` (hidden,) of a
    type of :data:`_TYPE_PAIRS`, hidden up to 49,152 as
    :func:`layer_norm_fwd`. Returns y like x2d, or ``(y, rstd)`` (fp32,
    (rows,)) with ``stats``."""
    rows, hidden = _check_rows("rms_norm_fwd", x2d, ("weight", weight))
    y = torch.empty_like(x2d)
    rstd = (torch.empty(rows, dtype=torch.float32, device=x2d.device)
            if stats else None)
    plan = _fwd_plan(hidden)
    lib = ku.load_kernel("layer_norm", _SIGNATURES)
    status = lib.rms_norm_fwd(
        x2d.device.index, x2d.data_ptr(), weight.data_ptr(), y.data_ptr(),
        rstd.data_ptr() if stats else None, rows, hidden, float(eps), *plan,
        *_types(x2d, weight), ku.stream_handle(x2d))
    ku.count_launch("rms_norm_fwd")
    ku.check_status(lib, status, "rms_norm_fwd")
    return (y, rstd) if stats else y


def rms_norm_bwd(dy, x2d, rstd, weight):
    """Launch the RMSNorm backward on CUDA tensors (as
    :func:`layer_norm_bwd`, without db): returns ``(dx, dw)``, dx like
    x2d, dw in the weight's type, bitwise the same for the same inputs."""
    rows, hidden = _check_rows("rms_norm_bwd", x2d, ("weight", weight))
    _check_bwd_width("rms_norm_bwd", hidden)
    _check_grad_in("rms_norm_bwd", dy, x2d, (("rstd", rstd),))
    dx = torch.empty_like(x2d)
    dw = torch.empty_like(weight)
    plan, work = _workspace(x2d, 1)
    lib = ku.load_kernel("layer_norm", _SIGNATURES)
    status = lib.rms_norm_bwd(
        x2d.device.index, dy.data_ptr(), x2d.data_ptr(), rstd.data_ptr(),
        weight.data_ptr(), dx.data_ptr(), dw.data_ptr(), work.data_ptr(),
        rows, hidden, *plan, *_types(x2d, weight), ku.stream_handle(x2d))
    ku.count_launch("rms_norm_bwd")
    ku.check_status(lib, status, "rms_norm_bwd")
    return dx, dw


# ---------------------------------------------------------------------------
# differentiable affine forms


class LayerNormAffine(ku.OpaqueFunction):
    """Differentiable affine LayerNorm over (rows, hidden): the kernels for
    CUDA tensors, their plain versions for CPU tensors (or under
    ``force_plain``)."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps):
        ctx.kernel = ku.use_kernel(x2d)
        if ctx.kernel:
            y, mean, rstd = layer_norm_fwd(x2d, weight, bias, eps, stats=True)
        else:
            y, mean, rstd = layer_norm_fwd_reference(x2d, weight, bias, eps)
        ctx.save_for_backward(x2d, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.kernel:
            dx, dw, db = layer_norm_bwd(dy, x2d, mean, rstd, weight)
        else:
            dx, dw, db = layer_norm_bwd_reference(dy, x2d, mean, rstd,
                                                  weight)
        return dx, dw, db, None


class RMSNormAffine(ku.OpaqueFunction):
    """Differentiable affine RMSNorm over (rows, hidden) (JAX's
    ``_rms_norm_affine``): the kernels for CUDA tensors, their plain
    versions for CPU tensors (or under ``force_plain``)."""

    @staticmethod
    def forward(ctx, x2d, weight, eps):
        ctx.kernel = ku.use_kernel(x2d)
        if ctx.kernel:
            y, rstd = rms_norm_fwd(x2d, weight, eps, stats=True)
        else:
            y, rstd = rms_norm_fwd_reference(x2d, weight, eps)
        ctx.save_for_backward(x2d, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.kernel:
            dx, dw = rms_norm_bwd(dy, x2d, rstd, weight)
        else:
            dx, dw = rms_norm_bwd_reference(dy, x2d, rstd, weight)
        return dx, dw, None


def _affine(x, vectors, autograd_fn, fwd, reference, eps):
    """Run an affine norm inside the gate: through ``autograd_fn`` when
    autograd records, else the forward kernel alone on CUDA (no
    statistics kept) or ``reference`` on the CPU."""
    kernel = ku.use_kernel(x)
    if kernel:
        ku.require(x.is_contiguous(), f"{fwd.__name__}: x must be "
                   f"contiguous")
    x2d = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *vectors)):
        y = autograd_fn.apply(x2d, *vectors, eps)
    elif kernel:
        y = ku.opaque_call(fwd, x2d, *vectors, eps)
    else:
        return ku.opaque_call(reference, x, *vectors, eps)
    return y.reshape(x.shape)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5,
               use_pallas: Optional[bool] = None):
    """LayerNorm over the last axis, with JAX's dispatch: where its gate
    (:func:`_pallas_ok`) holds, the kernels on CUDA (their plain versions
    on the CPU); elsewhere, and for the non-affine form (``weight`` or
    ``bias`` None), :func:`layer_norm_reference` on every device, as JAX
    (``apex_tpu/ops/layer_norm.py:320-347``). ``use_pallas=True`` outside
    the gate raises ``ValueError``; ``False`` takes the reference. x and
    the weight may differ in type (:data:`_TYPE_PAIRS`): y comes back in
    x's. Differentiable: with autograd recording, the gated affine form
    goes through :class:`LayerNormAffine`; without it, the forward alone
    runs and no statistics are kept."""
    if (not _use_pallas("layer_norm", x, use_pallas) or weight is None
            or bias is None):
        return layer_norm_reference(x, weight, bias, eps)
    return _affine(x, (weight, bias), LayerNormAffine, layer_norm_fwd,
                   layer_norm_reference, eps)


def rms_norm(x, weight=None, eps: float = 1e-5,
             use_pallas: Optional[bool] = None):
    """RMSNorm over the last axis, with JAX's dispatch as
    :func:`layer_norm`: the kernels on CUDA where the gate holds, else (and
    without a weight) :func:`rms_norm_reference` on every device, as JAX
    (``apex_tpu/ops/layer_norm.py:350-369``); ``use_pallas`` as there.
    Differentiable through :class:`RMSNormAffine`."""
    if not _use_pallas("rms_norm", x, use_pallas) or weight is None:
        return rms_norm_reference(x, weight, eps)
    return _affine(x, (weight,), RMSNormAffine, rms_norm_fwd,
                   rms_norm_reference, eps)
