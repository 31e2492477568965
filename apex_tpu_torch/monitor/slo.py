"""Declarative SLOs → goodput / violation accounting over rolling windows
(the port's copy of ``apex_tpu/monitor/slo.py``, over the port's
``monitor.hist``).

The serving currency is **goodput-under-SLO**: requests per second
that met EVERY latency budget, not raw throughput (a saturated engine can
post great tokens/s while every request blows its TTFT budget — MLPerf
inference draws the same line between "offered" and "completed within
bound"). This module is the accounting side:

* :class:`SloSpec` — the declarative budget set: TTFT (ms), per-output-
  token latency (TPOT, ms), max queue wait (ms), end-to-end (ms). ``None``
  budgets don't constrain. :meth:`SloSpec.check` classifies one retired
  request's measurements.
* :class:`SloTracker` — per-retirement :meth:`~SloTracker.observe` feeds
  lifetime counters, per-budget violation counts, per-metric
  :class:`~apex_tpu_torch.monitor.hist.Histogram`\\ s (p50/p99 come from the
  bounded-error buckets, not a per-request list — O(1) memory over
  millions of requests) and a rolling window (default 60 s, monotonic
  timestamps) over which goodput/throughput rates are reported.
* :meth:`SloTracker.report` — one JSON-serializable dict (goodput req/s,
  violation counts, quantiles) that drops straight into a
  ``json_record`` line.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from apex_tpu_torch.monitor.hist import (DEFAULT_LATENCY_SPEC, HistSpec,
                                         Histogram)

__all__ = ["SloSpec", "SloTracker"]

# the measured dimensions a retirement reports, in report order
DIMENSIONS = ("ttft_ms", "tpot_ms", "queue_ms", "e2e_ms")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """Latency budgets, all in ms; ``None`` leaves a dimension
    unconstrained. A request is GOOD iff every constrained dimension is
    within budget (inclusive)."""

    ttft_ms: Optional[float] = None    # time to first token
    tpot_ms: Optional[float] = None    # mean per-output-token latency
    queue_ms: Optional[float] = None   # submit -> admitted wait
    e2e_ms: Optional[float] = None     # submit -> retired

    def validate(self) -> None:
        for dim in DIMENSIONS:
            v = getattr(self, dim)
            if v is not None and v <= 0:
                raise ValueError(f"{dim} budget must be positive, got {v}")

    def budgets(self) -> Dict[str, float]:
        return {d: getattr(self, d) for d in DIMENSIONS
                if getattr(self, d) is not None}

    def check(self, **measured: Optional[float]) -> Dict[str, bool]:
        """Violation flags per CONSTRAINED dimension (True = violated).
        A missing/None measurement never violates (e.g. tpot of a
        single-token request is undefined)."""
        out = {}
        for dim, budget in self.budgets().items():
            v = measured.get(dim)
            out[dim] = v is not None and v > budget
        return out

    def to_dict(self) -> Dict[str, float]:
        return self.budgets()


class SloTracker:
    """Rolling goodput/violation accounting against one :class:`SloSpec`.

    ``observe`` once per retired request with whatever dimensions were
    measured; ``report`` at any time. ``window_s`` bounds the rate
    window; counters and histograms are lifetime. The clock defaults to
    ``time.perf_counter`` — share the :class:`~apex_tpu_torch.monitor.events.
    EventLog`'s clock (pass ``clock=log.now_ms`` scaled) only if you need
    the two aligned; rates only ever subtract this tracker's own stamps.
    """

    def __init__(self, spec: SloSpec, window_s: float = 60.0,
                 hist_spec: Optional[HistSpec] = None,
                 hists: Optional[Dict[str, Histogram]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        spec.validate()
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.spec = spec
        self.window_s = float(window_s)
        self._clock = clock
        self._t0 = clock()
        self.completed = 0
        self.good = 0
        self.violations: Dict[str, int] = {d: 0 for d in spec.budgets()}
        # hists= shares a caller's Histogram instances (the serve engine
        # passes its own, so one retirement folds each latency exactly
        # once and engine.stats + slo_report read one source of truth)
        if hists is not None and set(hists) != set(DIMENSIONS):
            raise ValueError(
                f"hists must cover exactly {DIMENSIONS}, "
                f"got {tuple(sorted(hists))}")
        self.hists: Dict[str, Histogram] = hists if hists is not None else {
            d: Histogram(hist_spec or DEFAULT_LATENCY_SPEC)
            for d in DIMENSIONS}
        # rolling (t, good) pairs, pruned to window_s on observe/report
        self._window: collections.deque = collections.deque()

    def observe(self, t: Optional[float] = None,
                **measured: Optional[float]) -> bool:
        """Account one retired request (dimensions from
        :data:`DIMENSIONS`, ms). Returns whether it met the SLO."""
        now = self._clock() if t is None else t
        for dim, v in measured.items():
            if dim not in self.hists:
                raise ValueError(f"unknown dimension {dim!r}; "
                                 f"expected one of {DIMENSIONS}")
            if v is not None:
                self.hists[dim].add([float(v)])
        flags = self.spec.check(**measured)
        ok = not any(flags.values())
        self.completed += 1
        self.good += ok
        for dim, bad in flags.items():
            self.violations[dim] += bad
        self._window.append((now, ok))
        self._prune(now)
        return ok

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        w = self._window
        while w and w[0][0] < cutoff:
            w.popleft()

    def report(self, quantiles=(0.5, 0.99)) -> Dict[str, Any]:
        """Goodput/violation snapshot, JSON-serializable. Rates are over
        ``min(window_s, elapsed)`` so short runs aren't diluted by the
        empty part of the window."""
        now = self._clock()
        self._prune(now)
        elapsed = max(now - self._t0, 1e-9)
        span = min(self.window_s, elapsed)
        in_window = len(self._window)
        good_in_window = sum(ok for _, ok in self._window)
        rep: Dict[str, Any] = {
            "completed": self.completed,
            "good": self.good,
            "goodput_rps": round(good_in_window / span, 4),
            "throughput_rps": round(in_window / span, 4),
            "good_fraction": (round(self.good / self.completed, 4)
                              if self.completed else None),
            "window_s": round(span, 3),
            "slo": self.spec.to_dict(),
            "violations": dict(self.violations),
        }
        for dim in DIMENSIONS:
            h = self.hists[dim]
            if h.total == 0:
                continue
            for q in quantiles:
                v = h.quantile(q)
                rep[f"{dim}_p{int(q * 100)}"] = (round(v, 3)
                                                 if v is not None else None)
        return rep
