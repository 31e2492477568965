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

JAX's ``overlap_report`` reads ``comm/overlap.py``'s decomposed matmuls,
which are tensor-parallel: it comes with them (ROADMAP A7c).
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
