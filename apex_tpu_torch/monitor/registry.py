"""Cardinality-bounded metrics registry + exposition/aggregation plane
(the port's copy of ``apex_tpu/monitor/registry.py``, over the port's
``monitor.hist``).

Monitor tier 3's first piece. Tiers 1/2 left the repo with excellent
*instruments* (the ``Metrics`` pytree, streaming ``Histogram``\\ s, the
engine/router/membership counters) but no *naming plane*: every consumer
reads a different ad-hoc ``stats()`` dict, and nothing merges live state
across workers mid-run. This module is the naming plane:

* :class:`MetricsRegistry` — counters, gauges and histograms addressed by
  ``(name, sorted label set)``. The label space is **cardinality-bounded**
  (``max_series``): series past the bound fold into one
  ``{name}{overflow="true"}`` bucket and ``series_dropped_total`` counts
  them — a tenant-id explosion degrades one registry, never the host
  (the Prometheus operational lesson, enforced in-process).
* **exposition** — :meth:`MetricsRegistry.expose_text` renders the
  Prometheus text format (``# TYPE`` headers, ``name{label="v"} value``
  lines, cumulative ``_bucket``/``_sum``/``_count`` for histograms over
  the :class:`~apex_tpu_torch.monitor.hist.HistSpec` edges), so any standard
  scraper can read a worker; :meth:`MetricsRegistry.snapshot` is the
  same state as one JSON-serializable dict (the in-repo wire format).
* **aggregation** — :func:`merge_snapshots` folds worker snapshots into
  one fleet view: counters sum, histograms merge (the
  :class:`~apex_tpu_torch.monitor.hist.Histogram` associativity this was built
  for), gauges keep the freshest stamp. Because workers label their
  series (``worker="decode0"``, ``tenant="t1"``), the merged
  :class:`FleetView` holds per-worker, per-tenant AND rolled-up series
  at once — :meth:`FleetView.value` reads one, :meth:`FleetView.total`
  sums a name across labels.
* :class:`FleetScraper` — pulls every target's snapshot on the cluster
  clock, timing each pull (``scrape_ms``) and tracking **coverage** (the
  fraction of targets that answered — a dead worker is a scrape miss,
  which is itself a signal the alert engine consumes). The scraper is
  the cluster's live signal source: the
  alert engine (JAX's ``monitor.alerts``) evaluates rules over its
  :class:`FleetView`, and the autoscaler acts on the firings.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

from apex_tpu_torch.monitor.hist import (DEFAULT_LATENCY_SPEC, HistSpec,
                                         Histogram)

__all__ = [
    "FleetScraper",
    "FleetView",
    "MetricsRegistry",
    "merge_snapshots",
]

_TYPES = ("counter", "gauge", "histogram")


def _label_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class _Series:
    name: str
    kind: str                       # counter | gauge | histogram
    labels: Tuple[Tuple[str, str], ...]
    value: float = 0.0              # counter/gauge
    hist: Optional[Histogram] = None
    t_ms: float = 0.0               # last-update stamp (gauge freshness)


class MetricsRegistry:
    """One worker's named-series table. All mutators take ``**labels``;
    a series is ``(name, sorted labels)``. ``max_series`` bounds the
    table: past it, NEW label sets fold into the per-name overflow
    series (``overflow="true"``) and ``series_dropped_total`` counts the
    fold — bounded memory under label-cardinality attacks, loudly."""

    def __init__(self, max_series: int = 1024,
                 hist_spec: Optional[HistSpec] = None):
        if max_series < 1:
            raise ValueError(f"max_series must be >= 1, got {max_series}")
        self.max_series = int(max_series)
        self.hist_spec = hist_spec or DEFAULT_LATENCY_SPEC
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           _Series] = {}
        self.series_dropped_total = 0

    # -- series resolution -------------------------------------------------
    def _get(self, name: str, kind: str,
             labels: Mapping[str, Any]) -> _Series:
        if kind not in _TYPES:
            raise ValueError(f"kind must be one of {_TYPES}, got {kind!r}")
        key = (name, _label_key(labels))
        s = self._series.get(key)
        if s is not None:
            if s.kind != kind:
                raise ValueError(
                    f"{name}: registered as {s.kind}, used as {kind}")
            return s
        if len(self._series) >= self.max_series:
            # cardinality bound: fold into the per-name overflow series
            # (which may itself need creating — allow it one slot past
            # the bound so the fold target always exists).
            # series_dropped_total counts folded WRITES; scrape-style
            # registries are rebuilt per scrape, so per-scrape it equals
            # the dropped-series count and never grows unboundedly
            self.series_dropped_total += 1
            okey = (name, (("overflow", "true"),))
            s = self._series.get(okey)
            if s is not None:
                if s.kind != kind:
                    # the overflow series enforces the same name/kind
                    # contract as the normal path
                    raise ValueError(
                        f"{name}: registered as {s.kind}, used as {kind}")
                return s
            key = okey
        s = _Series(name=name, kind=kind, labels=key[1],
                    hist=(Histogram(self.hist_spec)
                          if kind == "histogram" else None))
        self._series[key] = s
        return s

    # -- instruments -------------------------------------------------------
    def counter(self, name: str, inc: float = 1.0, **labels: Any) -> None:
        """Monotonic add (merge rule: sum)."""
        if inc < 0:
            raise ValueError(f"{name}: counters only go up, got {inc}")
        self._get(name, "counter", labels).value += float(inc)

    def gauge(self, name: str, value: float, t_ms: Optional[float] = None,
              **labels: Any) -> None:
        """Point-in-time set (merge rule: freshest ``t_ms`` wins)."""
        s = self._get(name, "gauge", labels)
        s.value = float(value)
        if t_ms is not None:
            s.t_ms = float(t_ms)

    def observe(self, name: str, values: Any, **labels: Any) -> None:
        """Fold observations into the series' streaming histogram."""
        s = self._get(name, "histogram", labels)
        assert s.hist is not None
        s.hist.add(values)

    def set_histogram(self, name: str, hist: Histogram,
                      **labels: Any) -> None:
        """Install a COPY-free snapshot reference of an existing
        histogram (the serve engine's hists are already streaming —
        re-ingesting them would double-count). Snapshot() serializes
        whatever the histogram holds at snapshot time."""
        s = self._get(name, "histogram", labels)
        s.hist = hist

    # -- readout -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._series)

    def snapshot(self, t_ms: Optional[float] = None) -> Dict[str, Any]:
        """JSON-serializable state: the in-repo scrape wire format."""
        series = []
        for s in self._series.values():
            rec: Dict[str, Any] = {"name": s.name, "kind": s.kind,
                                   "labels": dict(s.labels)}
            if s.kind == "histogram":
                assert s.hist is not None
                rec["hist"] = s.hist.to_dict()
            else:
                rec["value"] = s.value
                if s.t_ms:
                    rec["t_ms"] = round(s.t_ms, 3)
            series.append(rec)
        return {"t_ms": (round(float(t_ms), 3) if t_ms is not None
                         else None),
                "series_dropped_total": self.series_dropped_total,
                "series": series}

    def expose_text(self) -> str:
        """Prometheus text exposition of the whole registry (one ``#
        TYPE`` header per name, histograms as cumulative ``_bucket``
        lines over the spec's finite edges plus ``_sum``/``_count``)."""
        by_name: Dict[str, List[_Series]] = {}
        for s in self._series.values():
            by_name.setdefault(s.name, []).append(s)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            lines.append(f"# TYPE {name} {group[0].kind}")
            for s in sorted(group, key=lambda s: s.labels):
                lbl = _fmt_labels(dict(s.labels))
                if s.kind != "histogram":
                    lines.append(f"{name}{lbl} {_fmt_value(s.value)}")
                    continue
                assert s.hist is not None
                cum = 0
                edges = s.hist.spec.edges()
                for i, c in enumerate(s.hist.counts):
                    cum += int(c)
                    le = ("+Inf" if i >= len(edges)
                          else _fmt_value(float(edges[i])))
                    lines.append(
                        f"{name}_bucket{_fmt_labels(dict(s.labels), le=le)}"
                        f" {cum}")
                lines.append(f"{name}_sum{lbl} {_fmt_value(s.hist.sum)}")
                lines.append(f"{name}_count{lbl} {s.hist.total}")
        return "\n".join(lines) + ("\n" if lines else "")


def _escape_label(v: str) -> str:
    """Prometheus text-format label escaping (backslash, quote,
    newline) — tenant ids are client-supplied, and one `"` in a label
    would invalidate the WHOLE scrape, not just its line."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str], **extra: str) -> str:
    merged = dict(labels)
    merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


# ---------------------------------------------------------------------------
# Fleet aggregation


class FleetView:
    """A merged set of worker snapshots. Selectors:

    * :meth:`value` — one series by exact ``(name, labels)``;
    * :meth:`series` — every ``(labels, value)`` pair under a name;
    * :meth:`total` — counters/gauges under a name summed across label
      sets (the roll-up);
    * :meth:`hist` — the merged histogram under ``(name, labels)``.

    ``sources`` is the list of worker names that contributed (coverage
    accounting); a name the view has never seen reads as ``None`` —
    exactly what an absence alert rule matches on.
    """

    def __init__(self, t_ms: float, sources: List[str],
                 missed: List[str]):
        self.t_ms = float(t_ms)
        self.sources = list(sources)
        self.missed = list(missed)
        self._scalars: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            Tuple[float, float]] = {}  # (value, stamp)
        self._hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                          Histogram] = {}
        self.series_dropped_total = 0

    # -- construction (merge_snapshots fills these) ------------------------
    def _fold_scalar(self, name: str, labels: Mapping[str, str],
                     value: float, kind: str, t_ms: float) -> None:
        key = (name, _label_key(labels))
        cur = self._scalars.get(key)
        if cur is None:
            self._scalars[key] = (float(value), t_ms)
        elif kind == "counter":
            self._scalars[key] = (cur[0] + float(value), max(cur[1], t_ms))
        else:  # gauge: freshest stamp wins, ties keep the later snapshot
            if t_ms >= cur[1]:
                self._scalars[key] = (float(value), t_ms)

    def _fold_hist(self, name: str, labels: Mapping[str, str],
                   h: Histogram) -> None:
        key = (name, _label_key(labels))
        cur = self._hists.get(key)
        self._hists[key] = h if cur is None else cur.merge(h)

    # -- selectors ---------------------------------------------------------
    def value(self, name: str, **labels: Any) -> Optional[float]:
        v = self._scalars.get((name, _label_key(labels)))
        return v[0] if v is not None else None

    def series(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        return [(dict(k[1]), v[0]) for k, v in self._scalars.items()
                if k[0] == name]

    def total(self, name: str) -> Optional[float]:
        vals = [v[0] for k, v in self._scalars.items() if k[0] == name]
        return sum(vals) if vals else None

    def hist(self, name: str, **labels: Any) -> Optional[Histogram]:
        if labels:
            return self._hists.get((name, _label_key(labels)))
        merged: Optional[Histogram] = None
        for k, h in self._hists.items():
            if k[0] == name:
                merged = h if merged is None else merged.merge(h)
        return merged

    def names(self) -> List[str]:
        return sorted({k[0] for k in self._scalars}
                      | {k[0] for k in self._hists})

    def as_dict(self) -> Dict[str, Any]:
        """Flat JSON-serializable roll-up (scalar totals per name +
        hist quantiles) — the shape ``json_record``/regress consume."""
        out: Dict[str, Any] = {"sources": self.sources,
                               "missed": self.missed}
        for name in sorted({k[0] for k in self._scalars}):
            out[name] = self.total(name)
        for name in sorted({k[0] for k in self._hists}):
            h = self.hist(name)
            if h is not None and h.total:
                out[f"{name}_p50"] = round(h.quantile(0.5), 4)
                out[f"{name}_p99"] = round(h.quantile(0.99), 4)
        return out


def merge_snapshots(snapshots: Iterable[Tuple[str, Mapping[str, Any]]],
                    t_ms: float = 0.0,
                    missed: Optional[List[str]] = None) -> FleetView:
    """Fold ``(worker, snapshot)`` pairs into one :class:`FleetView`.
    Counters with identical ``(name, labels)`` sum, histograms merge
    (associative — order-independent by construction), gauges keep the
    freshest ``t_ms``. Workers normally label their series with their
    own name, so cross-worker collisions only happen where summing is
    the right semantics (the roll-up series)."""
    pairs = list(snapshots)
    view = FleetView(t_ms, sources=[w for w, _ in pairs],
                     missed=list(missed or []))
    for _, snap in pairs:
        view.series_dropped_total += int(
            snap.get("series_dropped_total", 0))
        stamp = float(snap.get("t_ms") or 0.0)
        for rec in snap.get("series", []):
            labels = rec.get("labels", {})
            if rec["kind"] == "histogram":
                view._fold_hist(rec["name"], labels,
                                Histogram.from_dict(rec["hist"]))
            else:
                view._fold_scalar(rec["name"], labels,
                                  float(rec["value"]), rec["kind"],
                                  float(rec.get("t_ms") or stamp))
    return view


# ---------------------------------------------------------------------------
# FleetScraper — pull worker snapshots on the cluster clock


class FleetScraper:
    """Scrapes a dynamic target set into one :class:`FleetView`.

    ``targets``: zero-arg callable returning the LIVE ``[(name,
    scrape_fn)]`` list (the cluster passes its alive-worker view, so the
    dispatch set and the scrape set stay one thing). A target whose
    ``scrape_fn`` raises (or returns None) is a MISS — it stays out of
    the view, drags ``scrape_coverage`` below 1.0, and its name lands in
    ``view.missed`` (what a heartbeat-absence rule reads). Each pull is
    wall-timed into the ``scrape_ms`` histogram — the observability
    plane measures itself."""

    def __init__(self, targets: Callable[[], List[Tuple[str, Callable]]],
                 clock: Optional[Callable[[], float]] = None):
        self._targets = targets
        self._clock = clock
        self.scrapes_total = 0
        self.scrape_misses_total = 0
        self.scrape_ms_hist = Histogram(DEFAULT_LATENCY_SPEC)
        self.last_view: Optional[FleetView] = None
        self.last_coverage: Optional[float] = None

    def scrape(self, t_ms: Optional[float] = None) -> FleetView:
        if t_ms is None:
            t_ms = self._clock() if self._clock is not None else 0.0
        got: List[Tuple[str, Mapping[str, Any]]] = []
        missed: List[str] = []
        t0 = time.perf_counter()
        for name, fn in self._targets():
            try:
                snap = fn()
            # a scrape must never take the scraper down: ANY failing
            # target is a miss (that is the coverage signal)
            except Exception:
                snap = None
            if snap is None:
                missed.append(name)
                self.scrape_misses_total += 1
            else:
                got.append((name, snap))
        self.scrape_ms_hist.add([(time.perf_counter() - t0) * 1e3])
        self.scrapes_total += 1
        view = merge_snapshots(got, t_ms=t_ms, missed=missed)
        n = len(got) + len(missed)
        self.last_coverage = (len(got) / n) if n else None
        self.last_view = view
        return view

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "scrapes_total": self.scrapes_total,
            "scrape_misses_total": self.scrape_misses_total,
            "scrape_coverage": self.last_coverage,
        }
        h = self.scrape_ms_hist
        if h.total:
            out["scrape_ms_p50"] = round(h.quantile(0.5), 4)
            out["scrape_ms_p99"] = round(h.quantile(0.99), 4)
        return out
