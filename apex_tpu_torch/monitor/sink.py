"""Process-0-gated JSONL sink (counterpart of ``apex_tpu/monitor/sink.py``).

One record per step, one JSON object per line, appended to a file, in
JAX's format: a ``"schema"`` stamp on every record (:func:`json_record`),
buffered flushes (``buffer_steps``), crash-safe appends (a truncated final
line is skipped by :func:`read_jsonl`, and a reopened sink terminates it),
an ``atexit`` flush for callers that forget ``close()``, and size-based
rotation (``rotate_bytes``: ``<path>.1``, ``.2``, ... in creation order;
:func:`read_jsonl` reads them in order, :func:`rotated_segments` lists
them). Under ``torch.distributed`` only rank 0 writes; elsewhere the sink
is a no-op. ``log_every=N`` mirrors every Nth record to the
``apex_tpu_torch.monitor.metrics`` logger.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional

SCHEMA_VERSION = 1

# process-wide provenance stamp (tier 4): when set, every json_record
# line carries it under "provenance" — the trend history is useless
# without knowing what changed between points. None (the default) keeps
# records byte-for-byte identical to the pre-provenance format.
_PROVENANCE: Optional[Dict[str, Any]] = None


def collect_provenance(extra: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Best-effort provenance for records: hostname, git sha, the torch
    and CUDA versions and, when CUDA is already initialised in this
    process, the device name. Never raises and never initialises CUDA, so
    a tooling command does not take a card just to stamp a line."""
    prov: Dict[str, Any] = {}
    try:
        import socket

        prov["hostname"] = socket.gethostname()
    except Exception:  # best-effort stamp: no hostname beats no record
        pass
    try:
        import subprocess

        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo,
                             capture_output=True, text=True, timeout=5)
        if out.returncode == 0 and out.stdout.strip():
            prov["git_sha"] = out.stdout.strip()
    except Exception:  # no git / not a checkout — stamp without a sha
        pass
    try:
        import torch

        prov["torch_version"] = torch.__version__
        prov["cuda_version"] = torch.version.cuda
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            prov["device"] = torch.cuda.get_device_name(
                torch.cuda.current_device())
    except Exception:  # the device probe must never kill a record
        pass
    if extra:
        prov.update(extra)
    return prov


def set_provenance(prov: Optional[Mapping[str, Any]]) -> None:
    """Install (or clear, with ``None``) the process-wide provenance
    stamp attached to every subsequent :func:`json_record` line."""
    global _PROVENANCE
    _PROVENANCE = dict(prov) if prov else None


def _is_process_zero() -> bool:
    """Rank 0 of ``torch.distributed`` when a process group is
    initialised, else True (a single process)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except Exception:  # no distributed support: a single process
        pass
    return True


def json_record(**fields: Any) -> str:
    """Render one schema-stamped JSON line (no trailing newline) — the
    shared convention for sink records AND bench one-liners, so every
    emitter in the repo is parseable by the same reader. When a
    process-wide provenance stamp is set (:func:`set_provenance`), it
    rides under ``"provenance"`` (explicit fields win); records emitted
    without one are byte-for-byte the pre-provenance format."""
    rec: Dict[str, Any] = {"schema": SCHEMA_VERSION}
    rec.update(fields)
    if _PROVENANCE is not None and "provenance" not in rec:
        rec["provenance"] = _PROVENANCE
    return json.dumps(rec)


class JsonlSink:
    """Append-only JSONL metrics sink. Typical loop::

        sink = JsonlSink("metrics.jsonl", log_every=100)
        for step in range(n):
            metrics = train_step()                      # a Metrics
            sink.write(step=step, metrics=metrics, **host_side_fields)
        sink.close()                                    # or `with` block

    ``metrics`` may be a :class:`apex_tpu_torch.monitor.Metrics` (read out
    with one device transfer) or a plain dict of floats; ``extra`` fields
    must be JSON-serializable. ``fsync=True`` additionally fsyncs on every flush
    (true crash-safety at the cost of an IO stall per flush).
    """

    def __init__(
        self,
        path: str,
        buffer_steps: int = 16,
        process0_only: bool = True,
        fsync: bool = False,
        log_every: int = 0,
        rotate_bytes: Optional[int] = None,
    ):
        self.path = path
        self.buffer_steps = max(1, int(buffer_steps))
        self.fsync = fsync
        self.log_every = int(log_every)
        if rotate_bytes is not None and rotate_bytes <= 0:
            raise ValueError(
                f"rotate_bytes must be positive, got {rotate_bytes}")
        self.rotate_bytes = rotate_bytes
        self.enabled = _is_process_zero() if process0_only else True
        self._buf: List[str] = []
        self._file = None
        self._logger = None
        # write/flush are lock-guarded: background writers (the resilience
        # CheckpointManager's async worker, the stall watchdog) share one
        # sink with the train loop
        self._iolock = threading.Lock()
        self._atexit_registered = False
        if self.enabled:
            import atexit

            # fallback only: close() unregisters, so the common with-block
            # path never reaches it; a run killed by sys.exit/atexit (the
            # preemption save-and-exit path included) still flushes its tail
            atexit.register(self.close)
            self._atexit_registered = True

    # -- write path --------------------------------------------------------
    def write(self, step: Optional[int] = None, metrics: Any = None,
              **extra: Any) -> None:
        """Buffer one record ``{schema, ts, step, **metrics, **extra}``."""
        if not self.enabled:
            return
        fields: Dict[str, Any] = {"ts": round(time.time(), 3)}
        if step is not None:
            fields["step"] = int(step)
        if metrics is not None:
            vals = metrics.as_dict() if hasattr(metrics, "as_dict") \
                else dict(metrics)
            fields.update(vals)
        fields.update(extra)
        line = json_record(**fields)
        with self._iolock:
            self._buf.append(line)
            if len(self._buf) >= self.buffer_steps:
                self._flush_locked()
        if self.log_every and step is not None and step % self.log_every == 0:
            self._log_line(fields)

    def write_many(self, records: "List[Dict[str, Any]]") -> None:
        """Append a BATCH of records contiguously — one lock scope, one
        flush. The flight-recorder dump path needs this: a ring dumped
        record-by-record from another thread could interleave with the
        step loop's writes and have its records split across a rotation
        boundary mid-batch. Here the whole batch lands in one buffered
        flush, so every record is whole, the batch is contiguous in the
        stream, and rotation (which only ever runs AFTER a whole-line
        flush, under the same lock) can only happen between batches."""
        if not self.enabled or not records:
            return
        ts = round(time.time(), 3)
        lines = [json_record(**{"ts": ts, **r}) for r in records]
        with self._iolock:
            self._buf.extend(lines)
            self._flush_locked()

    def flush(self) -> None:
        """Write buffered records as whole lines and flush the OS buffer."""
        with self._iolock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        if self._file is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            # append-after-crash: a previous writer may have died mid-line;
            # terminate the partial record so new records start on a fresh
            # line (readers skip the malformed fragment)
            dangling = False
            if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
                with open(self.path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    dangling = rf.read(1) != b"\n"
            self._file = open(self.path, "a")
            if dangling:
                self._file.write("\n")
        self._file.write("".join(line + "\n" for line in self._buf))
        self._buf.clear()
        self._file.flush()
        if self.fsync:
            os.fsync(self._file.fileno())
        # size-based rotation: roll AFTER a whole-line flush so segments
        # always end on record boundaries; the next flush reopens path.
        # Roll to max(existing index)+1, NOT the first free slot — if an
        # operator deleted old segments to reclaim disk, reusing a freed
        # low index would file the NEWEST records under the oldest-read
        # name and scramble chronological iteration
        if (self.rotate_bytes is not None
                and self._file.tell() >= self.rotate_bytes):
            self._file.close()
            self._file = None
            indices = _segment_indices(self.path)
            k = (indices[-1] + 1) if indices else 1
            os.replace(self.path, f"{self.path}.{k}")

    def close(self) -> None:
        with self._iolock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None
        if self._atexit_registered:
            import atexit

            atexit.unregister(self.close)
            self._atexit_registered = False

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- human-readable mirror ---------------------------------------------
    def _log_line(self, fields: Dict[str, Any]) -> None:
        if self._logger is None:
            import logging

            self._logger = logging.getLogger("apex_tpu_torch.monitor.metrics")
            # log_every is an explicit opt-in: raise only THIS child to
            # INFO if the hierarchy's default (WARNING) would swallow the
            # lines the caller just asked for
            if not self._logger.isEnabledFor(logging.INFO):
                self._logger.setLevel(logging.INFO)
        parts = [f"step {fields.get('step', '?')}"]
        for k, v in fields.items():
            if k in ("schema", "ts", "step"):
                continue
            parts.append(f"{k}={v:.6g}" if isinstance(v, float) else
                         f"{k}={v}")
        self._logger.info(" ".join(parts))


def _segment_indices(path: str) -> List[int]:
    """Sorted numeric suffixes of a sink's rotated segments on disk
    (gap-tolerant: operators may delete old segments to reclaim space)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path) + "."
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    return sorted(int(f[len(base):]) for f in names
                  if f.startswith(base) and f[len(base):].isdigit())


def rotated_segments(path: str) -> List[str]:
    """The on-disk segments of a possibly-rotated sink, oldest first:
    ``path.1``, ``path.2``, …, then ``path`` itself (segments are numbered
    in creation order, so sort-by-index is chronological even when old
    segments have been deleted)."""
    segs = [f"{path}.{k}" for k in _segment_indices(path)]
    if os.path.exists(path):
        segs.append(path)
    return segs


def read_jsonl(path: str, strict: bool = False,
               rotated: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield records from a JSONL file, streaming (constant memory — the
    file is one line per train step of a possibly very long run). Malformed
    lines — the truncated final line of a crashed writer, or an interior
    fragment such a writer left behind before a restart terminated it — are
    skipped; pass ``strict=True`` to raise on any malformed INTERIOR line
    instead (a trailing partial line is always tolerated: it is the
    expected crash artifact, not corruption). A rotated sink's segments
    (``path.1``, ``.2``, …) are iterated in order before ``path`` unless
    ``rotated=False``."""
    paths = rotated_segments(path) if rotated else [path]
    if not paths:
        paths = [path]  # surface the FileNotFoundError the caller expects
    for p in paths:
        with open(p) as f:
            for raw in f:
                # a line still carrying its newline is complete wherever it
                # sits; only a newline-less final read is a crash tail
                interior = raw.endswith("\n")
                line = raw.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    if strict and interior:
                        raise
