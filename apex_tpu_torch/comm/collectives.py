"""Compressed collectives — the quantized all-reduce and reduce-scatter
over ``torch.distributed`` (counterpart of ``apex_tpu/comm/
collectives.py``).

The all-reduce is JAX's two-pass decomposition, every byte on the wire
an int8 code (or a packed int4 pair) or an fp32 block scale:

1. **quantize** the local flat bucket (``comm/quantize.py``'s codec);
2. **exchange** — ``all_to_all_single`` of codes and of scales: rank i
   receives every rank's i-th chunk (JAX: ``lax.all_to_all(tiled=True)``),
   dequantizes the W chunks and sums them in rank order, in fp32;
3. **requantize** the summed shard (fresh scales: its range grew);
4. **broadcast** — ``all_gather_into_tensor`` of the shard's codes and
   scales (JAX: ``lax.all_gather(tiled=True)``), dequantize, unpad.

Below ``min_elements``, and for the policy ``none``, the buffer rides
``all_reduce`` (JAX: ``lax.psum``). :func:`compressed_psum_scatter` is
passes 1-2 alone (the ZeRO gradient leg).

The buffer is padded to a multiple of ``block_size · world``, so each
rank's chunk is whole blocks: the scales split at ``n / (B·W)``, and the
int4 codes, two a byte, at ``n / (2W)`` bytes. Error feedback (policies
``*_ef``): pass 1's error on every rank, pass 3's on the shard owner,
added into its own slice — summed over ranks the residuals hold the whole
lost mass, ``Σ_k r_k = Σ_k e1_k + e2``. The errors are computed only under
EF (an eager program has no dead-code pass to drop them), and pass 3's
reads the owner's slice of the broadcast result instead of dequantizing
the shard again.

The codec: on a CUDA tensor the quantize and dequantize kernels
(``csrc/quantize.cu``) at any row count — JAX's 32-row gate is its TPU
tiling — with ``block_size % 128 == 0`` (else a ``ValueError``); on the
CPU JAX's reference (the scale a true quotient), as JAX runs off a TPU.
``use_pallas=True`` takes the kernels' math on the CPU too (their plain
versions), ``False`` the reference everywhere.

Seeds (``stochastic_rounding``): :func:`fold_seed` is JAX's uint32 hash,
on host ints, bitwise JAX's int32; the draws themselves are the port's
counter hash (ROADMAP §C, "Stochastic rounding's stream").
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch._hash import M32, fmix32
from apex_tpu_torch.comm import accounting
from apex_tpu_torch.comm.quantize import (
    QMAX,
    QMAX4,
    _check_quantize_args,
    _dequantize_on,
    _quantize,
    padded_size,
)
from apex_tpu_torch.ops import _kernel_util as ku
from apex_tpu_torch.parallel.mesh import resolve_axis

POLICIES = ("none", "int8", "int8_ef", "int4", "int4_ef")

# newer torch names all_gather_into_tensor and reduce_scatter_tensor
# deprecated in favour of spellings older releases lack; the port keeps
# the ones both have
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r".*(all_gather_into_tensor|reduce_scatter_tensor).*deprecated")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """One switch for the gradient wire format (JAX's fields and checks).

    ``policy``: ``"none"`` (uncompressed all-reduce), ``"int8"``,
    ``"int8_ef"`` (with error feedback), ``"int4"``, ``"int4_ef"`` (group
    codes nibble-packed two a byte). ``block_size``: elements per fp32
    scale (the int4 group; even). ``stochastic_rounding``: unbiased
    rounding, needs a seed a step. ``min_elements``: smaller buffers ride
    the uncompressed all-reduce (in fp32). ``use_pallas``: the codec's
    route, as the module says (None: the kernels on a CUDA tensor)."""

    policy: str = "int8"
    block_size: int = 256
    stochastic_rounding: bool = False
    min_elements: int = 2048
    use_pallas: Optional[bool] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {self.policy!r}")
        if self.block_size <= 0:
            raise ValueError(f"block_size must be > 0: {self.block_size}")
        if self.bits == 4 and self.block_size % 2:
            raise ValueError(
                f"int4 policies need an even block_size (nibble packing): "
                f"{self.block_size}")

    @property
    def enabled(self) -> bool:
        return self.policy != "none"

    @property
    def error_feedback(self) -> bool:
        return self.policy in ("int8_ef", "int4_ef")

    @property
    def bits(self) -> int:
        """Code width of the quantized wire (8 or 4)."""
        return 4 if self.policy.startswith("int4") else 8

    def payload_bytes(self, n: int) -> float:
        """Wire bytes of one quantized copy of an ``n``-element (padded)
        buffer: the codes at ``bits/8`` B an element and the fp32 scales."""
        return n * (self.bits / 8.0) + 4.0 * n / self.block_size

    def compresses(self, n: int) -> bool:
        """Whether a flat buffer of ``n`` elements takes the quantized
        path."""
        return self.enabled and n >= self.min_elements

    # -- the policy-dispatched codec ---------------------------------------
    def _kernels(self, t: torch.Tensor) -> bool:
        """The kernels' math (True) or JAX's reference (False) for ``t``."""
        if self.use_pallas is False:
            return False
        if ku.use_kernel(t):
            if self.block_size % 128:
                raise ValueError(
                    f"the codec kernels need block_size % 128 == 0 on the "
                    f"card, got {self.block_size}; use_pallas=False takes "
                    f"the reference")
            return True
        return bool(self.use_pallas)

    def quantize(self, flat: torch.Tensor, seed: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode a flat buffer (a multiple of ``block_size``):
        ``(codes, fp32 scales)``; int4 codes come back packed (half the
        element count)."""
        int4 = self.bits == 4
        _check_quantize_args(flat, self.block_size, self.stochastic_rounding,
                             seed, "group_size" if int4 else "block_size")
        return _quantize(flat, self.block_size, self.stochastic_rounding,
                         seed, QMAX4 if int4 else QMAX, self._kernels(flat),
                         packed=int4)

    def dequantize(self, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Decode ``(codes, scales)`` to the fp32 flat buffer."""
        return _dequantize_on(q, s, self.block_size, self._kernels(q),
                              self.bits == 4)


# ---------------------------------------------------------------------------
# wire models (JAX's, op for op)


def allreduce_wire_bytes(n: int, itemsize: int, world: int,
                         config: Optional[CompressionConfig] = None
                         ) -> float:
    """Modeled bytes on the wire per device of one flat-buffer all-reduce
    (the ring model :mod:`accounting` prices the issued collectives
    with): uncompressed ``2·b·(W-1)/W``; compressed two all-to-alls and
    two all-gathers of the padded codes and scales,
    ``2·payload(n')·(W-1)/W``. Sub-``min_elements`` buffers go in fp32."""
    if world <= 1:
        return 0.0
    ring = (world - 1) / world
    if config is None or not config.compresses(n):
        if config is not None and config.enabled:
            itemsize = 4
        return 2.0 * n * itemsize * ring
    size = padded_size(n, config.block_size * world)
    return 2.0 * config.payload_bytes(size) * ring


def psum_scatter_wire_bytes(n: int, itemsize: int, world: int,
                            config: Optional[CompressionConfig] = None,
                            shard_multiple: int = 1) -> float:
    """Modeled wire bytes of one :func:`compressed_psum_scatter`: one
    reduce-scatter (shard bytes × (W-1)), or one all-to-all pass of codes
    and scales."""
    if world <= 1:
        return 0.0
    k = -(-n // world)
    k = -(-k // shard_multiple) * shard_multiple
    if config is None or not config.compresses(n):
        if config is not None and config.enabled:
            itemsize = 4
        return float(k) * itemsize * (world - 1)
    size = max(k * world, padded_size(n, config.block_size * world))
    return config.payload_bytes(size) * (world - 1) / world


def all_gather_wire_bytes(n: int, itemsize: int, world: int) -> float:
    """Modeled wire bytes of one all-gather whose result has ``n``
    elements: ``b·(W-1)/W``."""
    if world <= 1:
        return 0.0
    return float(n) * itemsize * (world - 1) / world


# ---------------------------------------------------------------------------
# the port's collective wrappers: each enters itself into the open
# accounting records


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, world: int, op=None,
               tag: str = "") -> torch.Tensor:
    """In-place ``dist.all_reduce`` (sum unless ``op``) of ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    accounting.note("all-reduce", _nbytes(t), world, tag)
    return t


def all_to_all(t: torch.Tensor, group, world: int,
               tag: str = "") -> torch.Tensor:
    """Tiled all-to-all of a flat tensor: chunk j of every rank's ``t``
    lands, in rank order, on rank j."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    accounting.note("all-to-all", _nbytes(out), world, tag)
    return out


def all_gather(t: torch.Tensor, group, world: int,
               tag: str = "") -> torch.Tensor:
    """Tiled all-gather: every rank's ``t`` along dim 0, in rank order."""
    out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    accounting.note("all-gather", _nbytes(out), world, tag)
    return out


def reduce_scatter(t: torch.Tensor, group, world: int,
                   tag: str = "") -> torch.Tensor:
    """Tiled reduce-scatter (sum): rank i gets the i-th 1/W of the summed
    ``t`` along dim 0."""
    out = t.new_empty((t.shape[0] // world,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    accounting.note("reduce-scatter", _nbytes(out), world, tag)
    return out


# ---------------------------------------------------------------------------
# seeds


def _int32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def fold_seed(seed, salt) -> int:
    """JAX's hash-combine of a stochastic-rounding seed with a salt
    (bucket index, rank, pass), on host ints: the int32
    ``fmix32(seed ^ fmix32(salt + 0x9E3779B9))`` (uint32 arithmetic),
    bitwise JAX's. A seed outside int32 raises, as ``jnp.asarray(seed,
    int32)`` does."""
    seed = int(seed)
    if not -(1 << 31) <= seed < 1 << 31:
        raise OverflowError(f"seed {seed} is out of the int32 range")
    t = (int(salt) + 0x9E3779B9) & M32
    return _int32(fmix32((seed & M32) ^ fmix32(t)))


def _pass_seed(seed, index: int, pass_idx: int) -> Optional[int]:
    """Per-(rank, pass) stream: ``fold_seed(fold_seed(seed, rank),
    pass)``."""
    if seed is None:
        return None
    return fold_seed(fold_seed(seed, index), pass_idx)


# ---------------------------------------------------------------------------
# the collectives


def _pad_to(flat: torch.Tensor, size: int) -> torch.Tensor:
    if flat.numel() == size:
        return flat
    return torch.cat([flat, flat.new_zeros(size - flat.numel())])


def _finite_or_zero(err: torch.Tensor) -> torch.Tensor:
    """Never carry inf / NaN in the EF residual (an overflow step's
    error): the un-measurable entries are dropped."""
    return torch.where(torch.isfinite(err), err, torch.zeros_like(err))


def _exchange_and_sum(padded: torch.Tensor, group, world: int, index: int,
                      cfg: CompressionConfig, seed, with_error: bool,
                      tag: str):
    """Passes 1-2: quantize, all-to-all of codes and scales, the W
    received chunks dequantized and summed in rank order (fp32) -> (the
    summed shard, pass 1's error over the padded buffer under EF, else
    None)."""
    n = padded.numel()
    q, s = cfg.quantize(padded, _pass_seed(seed, index, 1))
    err = padded - cfg.dequantize(q, s) if with_error else None
    rows = cfg.dequantize(all_to_all(q, group, world, tag),
                          all_to_all(s, group, world, tag)
                          ).reshape(world, n // world)
    shard = rows[0]
    for r in range(1, world):
        shard = shard + rows[r]
    return shard, err


def _needs_residual(config: CompressionConfig, residual) -> None:
    if config.error_feedback and residual is None:
        raise ValueError(
            f"policy {config.policy!r} needs the residual carried in: "
            "init with error_feedback.init_error_feedback / "
            "DistributedDataParallel.init_comm_state")


def compressed_allreduce(flat: torch.Tensor, axis, config: CompressionConfig,
                         residual: Optional[torch.Tensor] = None, seed=None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The quantized sum of a flat buffer over ``axis`` (a mesh axis name
    or a process group): ``(sum (fp32), new residual)``. ``residual``
    (fp32, the buffer's shape) is required exactly under EF, and the
    compensated ``flat + residual`` is what is compressed. Uncompressed
    (policy ``none`` or under ``min_elements``), one all-reduce of a
    fresh tensor. Every rank gets the same bits."""
    _needs_residual(config, residual)
    group, world, index = resolve_axis(axis)
    tag = "compressed_allreduce"
    n = flat.numel()
    if not config.compresses(n):
        out = flat.float() if config.enabled else flat
        if out.data_ptr() == flat.data_ptr():
            out = out.clone()
        return all_reduce(out, group, world, tag=tag), residual
    if config.stochastic_rounding and seed is None:
        raise ValueError("stochastic_rounding needs a per-step seed")
    comp = flat.float()
    if residual is not None:
        comp = comp + residual.float().reshape(-1)
    size = padded_size(n, config.block_size * world)
    padded = _pad_to(comp, size)
    ef = config.error_feedback
    shard, err1 = _exchange_and_sum(padded, group, world, index, config,
                                    seed, ef, tag)
    q2, s2 = config.quantize(shard, _pass_seed(seed, index, 2))
    out = config.dequantize(all_gather(q2, group, world, tag),
                            all_gather(s2, group, world, tag))
    new_residual = residual
    if ef:
        # pass 3's error, measurable on the shard owner only: its slice
        # of the broadcast result is dq(q2, s2)
        k = size // world
        mine = slice(index * k, (index + 1) * k)
        err1[mine] += shard - out[mine]
        new_residual = _finite_or_zero(err1[:n]).reshape(
            residual.shape).to(residual.dtype)
    return out[:n], new_residual


def compressed_psum_scatter(flat: torch.Tensor, axis,
                            config: CompressionConfig,
                            residual: Optional[torch.Tensor] = None,
                            seed=None, shard_multiple: int = 1
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The quantized reduce-scatter: passes 1-2 only, each rank its summed
    fp32 shard of ``ceil(n / world)`` rounded up to ``shard_multiple``
    (or a block-aligned chunk, whichever is larger). Returns ``(shard,
    new residual)``; the residual covers the whole ``flat``."""
    _needs_residual(config, residual)
    group, world, index = resolve_axis(axis)
    tag = "compressed_psum_scatter"
    n = flat.numel()
    k = -(-n // world)
    k = -(-k // shard_multiple) * shard_multiple
    if not config.compresses(n):
        comm = _pad_to(flat.float() if config.enabled else flat, k * world)
        return reduce_scatter(comm, group, world, tag), residual
    if config.stochastic_rounding and seed is None:
        raise ValueError("stochastic_rounding needs a per-step seed")
    comp = flat.float()
    if residual is not None:
        comp = comp + residual.float().reshape(-1)
    size = max(k * world, padded_size(n, config.block_size * world))
    padded = _pad_to(comp, size)
    ef = config.error_feedback
    shard, err1 = _exchange_and_sum(padded, group, world, index, config,
                                    seed, ef, tag)
    new_residual = residual
    if ef:
        new_residual = _finite_or_zero(err1[:n]).reshape(
            residual.shape).to(residual.dtype)
    return shard, new_residual
