"""Collective accounting — bytes on the wire of the collectives the port
issued (counterpart of ``apex_tpu/comm/accounting.py``).

JAX prices the collectives it parses out of a compiled program's HLO.
The port has no compiled program: its collective wrappers
(``comm/collectives.py``: all-reduce, all-gather, reduce-scatter,
all-to-all, and the halo's point-to-point sends) write one entry each
into every record that :func:`record_collectives` has open — the op,
its result bytes, its group size and the caller's tag — and
:func:`collective_report` prices a record with JAX's ring model, per
device, for a collective whose result occupies ``b`` bytes in a group of
``W``:

===================  =============================
``all-reduce``       ``2·b·(W-1)/W``
``all-gather``       ``b·(W-1)/W``
``reduce-scatter``   ``b·(W-1)`` (b: one shard)
``all-to-all``       ``b·(W-1)/W``
``collective-permute``  ``b`` (one hop; a halo send)
===================  =============================

No record open costs one list test a collective.

JAX's ``overlap_report`` parses a compiled program's HLO for
``collective-permute`` pairs with a ``dot`` scheduled inside their
window. The port has no compiled program either: ``comm/overlap.py``'s
ring ops enter each op into the records :func:`record_overlap` has open
(:class:`RingOp`: the hops it posted, how many had a product issued while
in flight, its products and its bytes on the wire) and
:func:`overlap_report` sums them into JAX's :class:`OverlapReport`
fields. A posted hop is an async pair; a product issued between its post
and its wait is the proof JAX reads off a schedule.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, NamedTuple

COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


class Collective(NamedTuple):
    """One collective as issued: its kind, result bytes, group size and
    the issuing site's tag (``"ddp"``, ``"sync_batch_stats"`` ...)."""
    kind: str
    result_bytes: int
    group_size: int
    tag: str = ""


_OPEN: List[List[Collective]] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Collective]]:
    """Open a record: every collective the port issues inside the block is
    appended to the yielded list (nested records each get their own)."""
    rec: List[Collective] = []
    _OPEN.append(rec)
    try:
        yield rec
    finally:
        _OPEN.remove(rec)


def note(kind: str, result_bytes: int, group_size: int,
         tag: str = "") -> None:
    """Enter one collective into every open record (the wrappers' hook)."""
    if _OPEN:
        entry = Collective(kind, int(result_bytes), int(group_size), tag)
        for rec in _OPEN:
            rec.append(entry)


@dataclasses.dataclass
class CollectiveReport:
    """Per-kind tallies plus the headline ``wire_bytes`` total."""

    counts: Dict[str, int]
    result_bytes: Dict[str, int]
    wire_bytes_by_kind: Dict[str, float]

    @property
    def wire_bytes(self) -> float:
        return sum(self.wire_bytes_by_kind.values())

    def __repr__(self):
        rows = ", ".join(
            f"{k}: n={self.counts[k]} wire={self.wire_bytes_by_kind[k]:.0f}"
            for k in COLLECTIVE_KINDS if self.counts[k])
        return f"CollectiveReport({rows or 'no collectives'})"


def _wire_cost(kind: str, b: float, w: int) -> float:
    if kind == "collective-permute":
        return float(b)
    if w <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * b * (w - 1) / w
    if kind == "all-gather":
        return b * (w - 1) / w
    if kind == "reduce-scatter":
        return float(b) * (w - 1)
    if kind == "all-to-all":
        return b * (w - 1) / w
    return float(b)


def collective_report(record: List[Collective]) -> CollectiveReport:
    """Price a record from :func:`record_collectives`."""
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    rbytes = {k: 0 for k in COLLECTIVE_KINDS}
    wire = {k: 0.0 for k in COLLECTIVE_KINDS}
    for c in record:
        counts[c.kind] += 1
        rbytes[c.kind] += c.result_bytes
        wire[c.kind] += _wire_cost(c.kind, c.result_bytes, c.group_size)
    return CollectiveReport(counts=counts, result_bytes=rbytes,
                            wire_bytes_by_kind=wire)


def wire_bytes(record: List[Collective]) -> float:
    """Total modeled bytes on the wire per device of a record."""
    return collective_report(record).wire_bytes


# ---------------------------------------------------------------------------
# the rings' overlap record


class RingOp(NamedTuple):
    """One ring op as issued (``comm.overlap``): its name, group size,
    hops posted, hops with a product issued while in flight, products,
    bytes on the wire and the bytes of its hidden hops."""
    name: str
    group_size: int
    hops: int
    hidden_hops: int
    products: int
    wire_bytes: float
    hidden_wire_bytes: float


_OPEN_RINGS: List[List[RingOp]] = []


@contextlib.contextmanager
def record_overlap() -> Iterator[List[RingOp]]:
    """Open a record of the ring ops issued inside the block."""
    rec: List[RingOp] = []
    _OPEN_RINGS.append(rec)
    try:
        yield rec
    finally:
        _OPEN_RINGS.remove(rec)


def note_ring(name: str, group_size: int, hops: int, hidden_hops: int,
              products: int, wire: float, hidden_wire: float) -> None:
    """Enter one ring op into every open overlap record."""
    if _OPEN_RINGS:
        entry = RingOp(name, int(group_size), int(hops), int(hidden_hops),
                       int(products), float(wire), float(hidden_wire))
        for rec in _OPEN_RINGS:
            rec.append(entry)


@dataclasses.dataclass
class OverlapReport:
    """JAX's overlap evidence, read off a ring record: ``async_pairs``
    hops posted, ``async_hidden`` of them with a product issued inside
    their post→wait window, ``dots`` products the rings issued, and the
    hop bytes split into hidden and exposed. The port posts no
    synchronous permute (``sync_*`` stay 0)."""

    async_pairs: int = 0
    async_hidden: int = 0
    sync_permutes: int = 0
    sync_hidden: int = 0
    dots: int = 0
    hidden_wire_bytes: float = 0.0
    exposed_wire_bytes: float = 0.0

    @property
    def permutes(self) -> int:
        return self.async_pairs + self.sync_permutes

    @property
    def hidden(self) -> int:
        return self.async_hidden + self.sync_hidden

    @property
    def hidden_fraction(self) -> float:
        total = self.hidden_wire_bytes + self.exposed_wire_bytes
        return self.hidden_wire_bytes / total if total else 0.0


def overlap_report(record: List[RingOp]) -> OverlapReport:
    """Sum a record from :func:`record_overlap`."""
    rep = OverlapReport()
    for op in record:
        rep.async_pairs += op.hops
        rep.async_hidden += op.hidden_hops
        rep.dots += op.products
        rep.hidden_wire_bytes += op.hidden_wire_bytes
        rep.exposed_wire_bytes += op.wire_bytes - op.hidden_wire_bytes
    return rep
