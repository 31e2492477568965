"""Fixed log-spaced-bucket streaming histograms — mergeable, constant
memory, bounded-relative-error quantiles (the port's copy of
``apex_tpu/monitor/hist.py``, numpy on the host, torch for the in-graph
count vector).

A long engine run retires millions of requests, and "TTFT p99" must come
out of O(1) state, not a per-request list. :class:`Histogram` over a
:class:`HistSpec`: ``add`` is one ``bincount``, ``merge`` adds count
vectors (associative and commutative), and :meth:`Histogram.quantile`
returns the geometric midpoint of the rank's bucket — relative error <=
``spec.rel_error`` (= sqrt(growth) - 1) for values inside ``[lo, hi)``.
:func:`bucket_indices` / :func:`hist_counts` compute the bucket of each
value and the count vector of a batch with torch ops on the tensor's
device. ``to_dict`` / ``from_dict`` round-trip through ``json``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "DEFAULT_LATENCY_SPEC",
    "HistSpec",
    "Histogram",
    "bucket_indices",
    "hist_counts",
]


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """Log-spaced bucket ladder: bucket 0 is the underflow ``(-inf, lo)``
    (zeros and negatives land here), buckets ``1..n`` cover
    ``[lo·g^(i-1), lo·g^i)``, and the last bucket is the overflow
    ``[~hi, inf)``. ``rel_error`` (= √growth − 1) bounds the quantile
    estimate's relative error for values inside the ladder."""

    lo: float = 0.01      # smallest resolvable value (ms scale: 10 µs)
    hi: float = 6.0e5     # largest (ms scale: 10 minutes)
    growth: float = 1.1   # bucket edge ratio -> ~4.9 % relative error

    def __post_init__(self):
        if not (self.lo > 0 and self.hi > self.lo):
            raise ValueError(f"need 0 < lo < hi, got ({self.lo}, {self.hi})")
        if not self.growth > 1.0:
            raise ValueError(f"growth must be > 1, got {self.growth}")

    @property
    def num_log_buckets(self) -> int:
        return int(math.ceil(math.log(self.hi / self.lo)
                             / math.log(self.growth)))

    @property
    def num_buckets(self) -> int:
        """underflow + log ladder + overflow."""
        return self.num_log_buckets + 2

    @property
    def rel_error(self) -> float:
        return math.sqrt(self.growth) - 1.0

    def edges(self) -> np.ndarray:
        """The ``num_log_buckets + 1`` finite edges (bucket i in 1..n spans
        ``[edges[i-1], edges[i])``)."""
        return self.lo * self.growth ** np.arange(self.num_log_buckets + 1)

    def bucket_of(self, values: np.ndarray) -> np.ndarray:
        """Host-side bucket index per value (vectorized)."""
        v = np.asarray(values, np.float64)
        out = np.zeros(v.shape, np.int64)
        pos = v >= self.lo
        idx = 1 + np.floor(np.log(np.where(pos, v, self.lo) / self.lo)
                           / math.log(self.growth)).astype(np.int64)
        np.copyto(out, np.clip(idx, 1, self.num_buckets - 1), where=pos)
        return out

    def estimate_of(self, bucket: int) -> float:
        """Representative value of a bucket: the geometric midpoint (the
        point minimizing worst-case relative error). Underflow reports
        ``lo``, overflow ``hi`` — callers holding exact min/max (the host
        Histogram does) clamp further."""
        if bucket <= 0:
            return self.lo
        if bucket >= self.num_buckets - 1:
            return self.hi
        return float(self.lo * self.growth ** (bucket - 1)
                     * math.sqrt(self.growth))

    def to_dict(self) -> Dict[str, float]:
        return {"lo": self.lo, "hi": self.hi, "growth": self.growth}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "HistSpec":
        return cls(lo=float(d["lo"]), hi=float(d["hi"]),
                   growth=float(d["growth"]))


# the serving-latency default: 10 µs .. 10 min at ~4.9 % relative error
DEFAULT_LATENCY_SPEC = HistSpec()


class Histogram:
    """Streaming histogram over a :class:`HistSpec`: constant memory
    (one int64 count vector + exact count/sum/min/max), mergeable, with
    nearest-rank quantile estimates whose relative error is bounded by
    ``spec.rel_error`` inside the ladder."""

    __slots__ = ("spec", "counts", "total", "sum", "min", "max")

    def __init__(self, spec: Optional[HistSpec] = None):
        self.spec = spec or DEFAULT_LATENCY_SPEC
        self.counts = np.zeros((self.spec.num_buckets,), np.int64)
        self.total = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- ingest ------------------------------------------------------------
    def add(self, values: Iterable[float]) -> "Histogram":
        """Fold values in (in place; returns self for chaining)."""
        v = np.atleast_1d(np.asarray(values, np.float64))
        if v.size == 0:
            return self
        self.counts += np.bincount(self.spec.bucket_of(v),
                                   minlength=self.spec.num_buckets)
        self.total += int(v.size)
        self.sum += float(v.sum())
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))
        return self

    def add_counts(self, counts: np.ndarray) -> "Histogram":
        """Fold a raw count vector in (the ``hist_counts`` path — no exact
        sum/min/max available, so those stay whatever exact observations
        contributed)."""
        c = np.asarray(counts)
        if c.shape != self.counts.shape:
            raise ValueError(
                f"count vector shape {c.shape} != {self.counts.shape}")
        c = c.astype(np.int64)
        if (c < 0).any():
            raise ValueError("negative bucket counts")
        self.counts += c
        self.total += int(c.sum())
        return self

    # -- merge (associative + commutative) ---------------------------------
    def merge(self, other: "Histogram") -> "Histogram":
        """New histogram = self ⊎ other (specs must match)."""
        if self.spec != other.spec:
            raise ValueError(f"spec mismatch: {self.spec} vs {other.spec}")
        out = Histogram(self.spec)
        out.counts = self.counts + other.counts
        out.total = self.total + other.total
        out.sum = self.sum + other.sum
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def __add__(self, other: "Histogram") -> "Histogram":
        return self.merge(other)

    # -- readout -----------------------------------------------------------
    def mean(self) -> Optional[float]:
        # honest only when every observation arrived through add(); pure
        # add_counts histograms report the bucket-estimate mean instead
        if self.total == 0:
            return None
        if math.isfinite(self.min):
            return self.sum / self.total
        est = sum(int(c) * self.spec.estimate_of(i)
                  for i, c in enumerate(self.counts) if c)
        return est / self.total

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile estimate (``q`` in [0, 1]); ``None`` when
        empty. Exact min/max clamp the under/overflow buckets when known."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.total == 0:
            return None
        # the extremes are tracked exactly — report them exactly
        if q == 0.0 and math.isfinite(self.min):
            return self.min
        if q == 1.0 and math.isfinite(self.max):
            return self.max
        rank = max(1, int(math.ceil(q * self.total)))  # 1-based
        cum = np.cumsum(self.counts)
        bucket = int(np.searchsorted(cum, rank))
        est = self.spec.estimate_of(bucket)
        if bucket == 0 and math.isfinite(self.min):
            return self.min
        if bucket == self.spec.num_buckets - 1 and math.isfinite(self.max):
            return self.max
        if math.isfinite(self.min):
            est = min(max(est, self.min), self.max)
        return est

    def quantiles(self, qs: Sequence[float]) -> List[Optional[float]]:
        return [self.quantile(q) for q in qs]

    # -- serialization (JSONL / bench-record friendly) ---------------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable snapshot; sparse (bucket -> count) so ~200
        mostly-empty buckets don't bloat the record."""
        return {
            "spec": self.spec.to_dict(),
            "count": self.total,
            "sum": round(self.sum, 6),
            "min": self.min if math.isfinite(self.min) else None,
            "max": self.max if math.isfinite(self.max) else None,
            "buckets": {str(i): int(c)
                        for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Histogram":
        h = cls(HistSpec.from_dict(d["spec"]))
        for i, c in d["buckets"].items():
            h.counts[int(i)] = int(c)
        h.total = int(d["count"])
        h.sum = float(d.get("sum", 0.0))
        h.min = float(d["min"]) if d.get("min") is not None else math.inf
        h.max = float(d["max"]) if d.get("max") is not None else -math.inf
        return h

    def __repr__(self):
        return (f"Histogram(n={self.total}, p50={self.quantile(0.5)}, "
                f"p99={self.quantile(0.99)})")


# ---------------------------------------------------------------------------
# count vectors with torch ops


def bucket_indices(values, spec: HistSpec):
    """Bucket index per value (int64), with torch ops on the values'
    device — the same ladder as :meth:`HistSpec.bucket_of`, in fp32."""
    import torch

    v = torch.as_tensor(values, dtype=torch.float32)
    pos = v >= spec.lo
    idx = 1 + torch.floor(
        torch.log(torch.where(pos, v, spec.lo) / spec.lo)
        / math.log(spec.growth)).long()
    return torch.where(pos, idx.clamp(1, spec.num_buckets - 1), 0)


def hist_counts(values, spec: HistSpec, valid=None):
    """Count vector (fp32, length ``spec.num_buckets``) of a batch of
    values; ``valid`` (bool, same shape) masks entries out."""
    import torch

    idx = bucket_indices(values, spec).reshape(-1)
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if valid is None else
         torch.as_tensor(valid, device=idx.device).reshape(-1).float())
    return torch.zeros(spec.num_buckets, dtype=torch.float32,
                       device=idx.device).index_add_(0, idx, w)
