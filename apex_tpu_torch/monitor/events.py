"""Per-request lifecycle events on one monotonic clock — JSONL + Perfetto
(the port's copy of ``apex_tpu/monitor/events.py``, which imports no JAX).

The tier-2 attribution question ("which phase of which request blew the
TTFT budget?") needs *events*, not step aggregates. This module is the
event half of the serve telemetry:

* :class:`EventLog` — stamps every event from ONE anchored monotonic clock
  (``time.perf_counter`` relative to the log's creation, in ms — wall
  clocks step; a latency pipeline must never subtract two of them) and
  streams each record through the existing
  :class:`~apex_tpu_torch.monitor.sink.JsonlSink` (``kind: "event"`` /
  ``"gauge"`` records alongside the engine's step records). Memory is
  O(1) unless ``keep=True`` opts into in-process retention (tests, short
  runs); long runs read events back with ``read_jsonl``.
* the canonical request lifecycle is :data:`LIFECYCLE`:
  ``submitted → admitted → prefill_start → prefill_end → first_token →
  decode_chunk* → retired``, plus ``queue_depth`` / ``occupancy`` gauges.
* :func:`chrome_trace` — the same event records rendered as Chrome
  trace-event JSON (viewable in Perfetto / ``chrome://tracing``): one
  track per decode **slot** (what the hardware grid was doing) and one per
  **request** (where an individual request's time went: ``queued`` /
  ``prefill`` / ``decode`` spans + per-chunk slices), with gauges as
  counter tracks. :func:`write_chrome_trace` dumps it to a file.

The span set in the exported trace is a pure function of the event log —
``tests/test_torch_monitor.py`` holds the trace to JAX's on the same JSONL
request-for-request, so either artifact can be trusted alone.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "EventLog",
    "GAUGES",
    "LIFECYCLE",
    "SPAN_PAIRS",
    "chrome_trace",
    "dedupe_events",
    "request_spans",
    "stitch_traces",
    "write_chrome_trace",
]

# canonical request lifecycle, in order; decode_chunk repeats. The
# disaggregated-cluster path (serve.cluster) inserts a transfer span
# between prefill and decode — ``prefill_end → transfer_start →
# transfer_end → admitted`` — and ``shed`` is the router's terminal
# state for a request that was never admitted (load shedding: recorded,
# never an exception). The elastic tier adds migration: when a decode
# worker dies or drains, an in-flight request's blocks hop hosts
# (``migrate_start → migrate_end``) and its last unacked token is
# re-emitted (``replay``); ``worker_join`` / ``worker_leave`` are the
# membership events (no uid — they describe a host, not a request).
LIFECYCLE = ("submitted", "admitted", "prefill_start", "prefill_end",
             "first_token", "transfer_start", "transfer_end",
             "decode_chunk", "migrate_start", "migrate_end", "replay",
             "retired", "shed", "worker_join", "worker_leave",
             # the fleet-observability (tier 3) events: alert-engine
             # transitions (``rule=``/``severity=``, no uid — they
             # describe the fleet) and flight-recorder dumps
             # (``worker=``/``reason=``/``path=``)
             "alert_fire", "alert_resolve", "flight_dump")
GAUGES = ("queue_depth", "occupancy")


class EventLog:
    """Monotonic-clock event recorder. ``sink`` is a
    :class:`~apex_tpu_torch.monitor.sink.JsonlSink` (or anything with a
    ``write(**fields)`` method); ``keep=True`` additionally retains records
    in ``self.records`` (unbounded — opt-in only)."""

    def __init__(self, sink=None, keep: bool = False,
                 clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._sink = sink
        self.records: Optional[List[Dict[str, Any]]] = [] if keep else None
        # per-uid default fields (trace id, tenant, current host) applied
        # to every emit for that uid — how the cluster threads ONE trace
        # id through producers (engine, workers, router) that never see
        # it; explicit emit fields always win
        self._bound: Dict[str, Dict[str, Any]] = {}
        # side observers of every record (the flight-recorder rings);
        # taps see the same dicts the sink does, in emit order
        self._taps: List[Callable[[Dict[str, Any]], None]] = []

    def now_ms(self) -> float:
        """Milliseconds since log creation, from the one monotonic clock
        every event in this log is stamped with."""
        return (self._clock() - self._t0) * 1e3

    # -- per-uid bound fields (distributed tracing) ------------------------
    def bind(self, uid: str, **fields: Any) -> None:
        """Attach default fields to every future event carrying ``uid``
        (``trace=`` minted at router submission, ``tenant=``, and the
        uid's CURRENT ``host=`` — rebound on migration). Explicit emit
        fields override; :meth:`unbind` at the terminal event keeps the
        table O(in-flight requests)."""
        self._bound.setdefault(uid, {}).update(fields)

    def unbind(self, uid: str) -> None:
        self._bound.pop(uid, None)

    def bound(self, uid: str) -> Dict[str, Any]:
        return dict(self._bound.get(uid, {}))

    def tap(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Register a record observer (flight rings, routers)."""
        self._taps.append(fn)

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._sink is not None:
            self._sink.write(**rec)
        if self.records is not None:
            self.records.append(rec)
        for tap in self._taps:
            tap(rec)

    def emit(self, event: str, uid: Optional[str] = None,
             t_ms: Optional[float] = None, **fields: Any) -> float:
        """Record one lifecycle event; returns its timestamp (ms). Extra
        ``fields`` ride the record (``slot=``, ``n_tokens=``,
        ``start_ms=`` for span-shaped events)."""
        t = self.now_ms() if t_ms is None else float(t_ms)
        rec: Dict[str, Any] = {"kind": "event", "event": event,
                               "t_ms": round(t, 3)}
        if uid is not None:
            rec["uid"] = uid
        rec.update(fields)
        if uid is not None and uid in self._bound:
            for k, v in self._bound[uid].items():
                rec.setdefault(k, v)
        self._write(rec)
        return t

    def gauge(self, name: str, value: float,
              t_ms: Optional[float] = None) -> float:
        """Record one gauge sample (queue depth, occupancy, ...)."""
        t = self.now_ms() if t_ms is None else float(t_ms)
        self._write({"kind": "gauge", "gauge": name, "t_ms": round(t, 3),
                     "value": float(value)})
        return t


# ---------------------------------------------------------------------------
# Chrome trace-event rendering (Perfetto / chrome://tracing)

_PID_REQUESTS = 1
_PID_SLOTS = 2
_PID_HOSTS = 3   # host tracks (fleet tier) start here, one pid per host

# request-track spans derived from lifecycle event pairs: name -> (start
# event, end event). decode_chunk spans carry their own start_ms instead.
# transfer renders the cluster's KV-block hop between hosts — in Perfetto
# a disaggregated request visibly leaves its prefill host and lands on
# its decode host.
_SPAN_PAIRS = {
    "queued": ("submitted", "admitted"),
    "prefill": ("prefill_start", "prefill_end"),
    "transfer": ("transfer_start", "transfer_end"),
    "migrate": ("migrate_start", "migrate_end"),
    "decode": ("first_token", "retired"),
}


def _meta(pid: int, tid: int, name: str, kind: str) -> Dict[str, Any]:
    return {"ph": "M", "pid": pid, "tid": tid, "name": kind,
            "args": {"name": name}}


def _span(name: str, pid: int, tid: int, t0_ms: float, t1_ms: float,
          args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return {"ph": "X", "name": name, "pid": pid, "tid": tid,
            "ts": round(t0_ms * 1e3, 1),          # trace ts is µs
            "dur": round(max(0.0, t1_ms - t0_ms) * 1e3, 1),
            "cat": "serve", "args": args or {}}


def _dedupe_events(records: Iterable[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Drop exact duplicates of uid-carrying events — the merged-logs
    artifact. Two workers' flight rings (or a worker log plus the
    cluster log) both hold the shared records of a request that hopped
    hosts; naively concatenating them replays the same ``decode_chunk``
    or ``admitted`` twice. Identity = (uid, event, t_ms, start_ms) on
    the one shared clock — distinct real events can never collide."""
    out: List[Dict[str, Any]] = []
    seen = set()
    for r in records:
        if "flight_worker" in r:
            # an in-log flight dump's record is a marked COPY of a live
            # record in the same stream — readers must never count both
            continue
        if r.get("kind") != "event":
            out.append(r)
            continue
        uid = r.get("uid")
        if uid is None:
            out.append(r)
            continue
        key = (uid, r["event"], r.get("t_ms"), r.get("start_ms"))
        if key in seen:
            continue
        seen.add(key)
        out.append(r)
    return out


# the public names tier-4 consumers (monitor.attrib, external tooling)
# build on: the span-pair table and the merged-log dedupe pass share one
# definition with the Chrome-trace renderer above
SPAN_PAIRS = _SPAN_PAIRS
dedupe_events = _dedupe_events


def request_spans(records: Iterable[Dict[str, Any]], *,
                  deduped: bool = False
                  ) -> Dict[str, List[Dict[str, Any]]]:
    """Per-request span list derived from an event log: the lifecycle
    pairs of :data:`_SPAN_PAIRS` plus one span per ``decode_chunk``
    event. This is the SAME derivation :func:`chrome_trace` renders,
    exposed so tests can pin trace == JSONL request-for-request.

    Reconstruction is per TRACE, not per (uid, log): records merged from
    several workers' logs are deduplicated first (a migrated request's
    events live in two logs that may share the cluster-global records),
    span pairs anchor on the FIRST occurrence of each side (the second
    ``admitted`` a migration emits never moves the queued span), and
    each ``decode_chunk`` renders exactly once however many dumps held
    it. Keys stay the request uid — uid and trace id are 1:1; the trace
    id rides the span records when present."""
    by_uid: Dict[str, Dict[str, float]] = {}
    spans: Dict[str, List[Dict[str, Any]]] = {}
    traces: Dict[str, str] = {}
    for r in (records if deduped else _dedupe_events(records)):
        if r.get("kind") != "event" or "uid" not in r:
            continue
        uid, ev, t = r["uid"], r["event"], float(r["t_ms"])
        if "trace" in r:
            traces.setdefault(uid, r["trace"])
        seen = by_uid.setdefault(uid, {})
        # the EARLIEST occurrence anchors (min by timestamp, not stream
        # position — merged logs derive the same spans in any order)
        seen[ev] = min(seen.get(ev, t), t)
        out = spans.setdefault(uid, [])
        if ev == "decode_chunk" and "start_ms" in r:
            chunk = {"name": "decode_chunk",
                     "t0_ms": float(r["start_ms"]), "t1_ms": t,
                     "n_tokens": r.get("n_tokens")}
            if "trace" in r:
                chunk["trace"] = r["trace"]
            out.append(chunk)
    for uid, seen in by_uid.items():
        out = spans.setdefault(uid, [])
        for name, (a, b) in _SPAN_PAIRS.items():
            if a in seen and b in seen:
                span = {"name": name, "t0_ms": seen[a], "t1_ms": seen[b]}
                if uid in traces:
                    span["trace"] = traces[uid]
                out.append(span)
    return spans


# cross-host span-pair kinds whose two sides may land in DIFFERENT
# workers' logs — the stitching targets. A trace that reached a terminal
# event but shows an unmatched side of one of these is a stitch failure.
_STITCH_PAIRS = ("transfer", "migrate")
_TERMINALS = ("retired", "shed")


def stitch_traces(records: Iterable[Dict[str, Any]], *,
                  deduped: bool = False) -> Dict[str, Any]:
    """Assemble per-TRACE cross-host structure from a (possibly merged)
    event stream: for every trace id (falling back to uid when no trace
    was minted), the per-host segments — [first event on that host, last
    event on that host] in first-touch order — and the causal verdict.

    ``stitch_failures`` counts traces that are structurally broken:

    * a terminal trace with a ``transfer_start``/``migrate_start`` whose
      matching end never appears anywhere in the stream (the two logs
      did not stitch), or
    * host segments that OVERLAP out of causal order on the shared
      clock (a request cannot be on two hosts at once — overlapping
      segments mean the logs disagree about the timeline).

    This is the acceptance currency of the chaos trace gate: a migrated
    request must reconstruct as ONE trace across ≥ 2 host segments with
    zero failures."""
    traces: Dict[str, Dict[str, Any]] = {}
    for r in (records if deduped else _dedupe_events(records)):
        if r.get("kind") != "event" or "uid" not in r:
            continue
        uid, ev, t = r["uid"], r["event"], float(r["t_ms"])
        key = r.get("trace", uid)
        tr = traces.setdefault(key, {
            "uid": uid, "trace": r.get("trace"),
            "segments": {}, "host_order": [],
            "pair_open": {k: 0 for k in _STITCH_PAIRS},
            "terminal": None, "events": 0})
        tr["events"] += 1
        host = r.get("host")
        if host is not None:
            seg = tr["segments"].get(host)
            if seg is None:
                tr["segments"][host] = [t, t]
                tr["host_order"].append(host)
            else:
                seg[0] = min(seg[0], t)
                seg[1] = max(seg[1], t)
        for kind in _STITCH_PAIRS:
            a, b = _SPAN_PAIRS[kind]
            if ev == a:
                # a transfer RETRY re-emits the start with attempt > 1;
                # only first attempts open a logical pair (retries share
                # the original's one end)
                if int(r.get("attempt", 1) or 1) <= 1:
                    tr["pair_open"][kind] += 1
            elif ev == b:
                tr["pair_open"][kind] -= 1
        if ev in _TERMINALS:
            tr["terminal"] = ev
    failures = 0
    out: Dict[str, Any] = {}
    for key, tr in traces.items():
        segs = [{"host": h, "t0_ms": tr["segments"][h][0],
                 "t1_ms": tr["segments"][h][1]}
                for h in tr["host_order"]]
        segs.sort(key=lambda s: (s["t0_ms"], s["t1_ms"]))
        ordered = all(segs[i + 1]["t0_ms"] >= segs[i]["t1_ms"] - 1e-6
                      for i in range(len(segs) - 1))
        unmatched = {k: n for k, n in tr["pair_open"].items() if n != 0}
        # a RETIRED trace must have every cross-host pair matched and
        # its segments causally ordered; a shed trace may legitimately
        # end mid-pair (transfer_failed died on the wire) but its
        # segments must still order
        failed = ((tr["terminal"] == "retired" and bool(unmatched))
                  or (tr["terminal"] is not None and not ordered))
        failures += failed
        out[key] = {"uid": tr["uid"], "trace": tr["trace"],
                    "hosts": [s["host"] for s in segs],
                    "segments": segs, "ordered": ordered,
                    "unmatched_pairs": unmatched,
                    "terminal": tr["terminal"], "failed": failed}
    return {"traces": out, "stitch_failures": failures}


def chrome_trace(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Render an event log (dicts from :class:`EventLog` / ``read_jsonl``)
    as a Chrome trace-event object: request tracks (one tid per uid, spans
    from :func:`request_spans`), slot tracks (one tid per slot, one span
    per residency ``admitted → retired`` named by the uid), gauge counter
    tracks.

    When events carry ``host=`` (the fleet/cluster path), one additional
    process appears PER HOST: each request renders one span per host it
    touched — named by its trace id, stamped with uid/trace args — so a
    request that hops hosts (disaggregated prefill→decode, chaos
    migration) is visibly ONE trace id across several host tracks, in
    causal order on the one shared clock. ``worker_join``/``worker_leave``
    and ``alert_fire`` render as instant markers. The stitch verdict
    (:func:`stitch_traces`) rides the returned object under ``"stitch"``
    (Perfetto ignores unknown top-level keys)."""
    records = list(records)
    events = [r for r in _dedupe_events(records)
              if r.get("kind") == "event"]
    gauges = [r for r in records if r.get("kind") == "gauge"
              and "flight_worker" not in r]

    trace: List[Dict[str, Any]] = [
        _meta(_PID_REQUESTS, 0, "requests", "process_name"),
        _meta(_PID_SLOTS, 0, "slots", "process_name"),
    ]

    # request tracks: stable tid per uid in first-seen order
    uid_tid: Dict[str, int] = {}
    for r in events:
        uid = r.get("uid")
        if uid is not None and uid not in uid_tid:
            uid_tid[uid] = len(uid_tid)
            trace.append(_meta(_PID_REQUESTS, uid_tid[uid], uid,
                               "thread_name"))
    for uid, spans in request_spans(events, deduped=True).items():
        for s in spans:
            args = {k: v for k, v in s.items()
                    if k not in ("name", "t0_ms", "t1_ms") and v is not None}
            trace.append(_span(s["name"], _PID_REQUESTS, uid_tid[uid],
                               s["t0_ms"], s["t1_ms"], args))

    # slot tracks: residency spans named by uid (admitted -> retired)
    admitted: Dict[str, Dict[str, Any]] = {}
    slot_tids = set()
    for r in events:
        uid = r.get("uid")
        if r["event"] == "admitted" and "slot" in r:
            admitted[uid] = r
        elif r["event"] == "retired" and uid in admitted:
            a = admitted.pop(uid)
            slot = int(a["slot"])
            slot_tids.add(slot)
            trace.append(_span(uid, _PID_SLOTS, slot, float(a["t_ms"]),
                               float(r["t_ms"])))
    for slot in sorted(slot_tids):
        trace.append(_meta(_PID_SLOTS, slot, f"slot {slot}", "thread_name"))

    # gauges as counter tracks
    for g in gauges:
        trace.append({"ph": "C", "name": g["gauge"], "pid": _PID_REQUESTS,
                      "tid": 0, "ts": round(float(g["t_ms"]) * 1e3, 1),
                      "args": {g["gauge"]: g["value"]}})

    # host tracks (fleet tier): one process per host named in the
    # stream, one span per (trace, host) segment — a migrated request is
    # ONE trace id across >= 2 host tracks, causally ordered
    stitch = stitch_traces(events, deduped=True)
    hosts: List[str] = []
    for r in events:
        # request events name their current host; membership events name
        # a REAL host via worker= — but other worker= carriers
        # (flight_dump's "cluster" ring, alert contexts) are not hosts
        # and must not mint phantom tracks
        h = r.get("host")
        if h is None and r["event"] in ("worker_join", "worker_leave"):
            h = r.get("worker")
        if h is not None and h not in hosts:
            hosts.append(h)
    if hosts:
        host_pid = {h: _PID_HOSTS + i for i, h in enumerate(sorted(hosts))}
        for h, pid in sorted(host_pid.items()):
            trace.append(_meta(pid, 0, f"host {h}", "process_name"))
        # stable per-host request lanes in first-seen order
        lanes: Dict[str, Dict[str, int]] = {h: {} for h in host_pid}
        for key, tr in stitch["traces"].items():
            for seg in tr["segments"]:
                lane = lanes[seg["host"]].setdefault(
                    key, len(lanes[seg["host"]]))
                trace.append(_span(
                    key, host_pid[seg["host"]], lane,
                    seg["t0_ms"], seg["t1_ms"],
                    {"uid": tr["uid"], "trace": tr["trace"]}))
        # membership churn + alert transitions as instant markers on the
        # host track (join/leave) or the fleet lane (alerts)
        for r in events:
            if r["event"] in ("worker_join", "worker_leave"):
                trace.append({
                    "ph": "i", "s": "p", "name": r["event"],
                    "pid": host_pid[r["worker"]], "tid": 0,
                    "ts": round(float(r["t_ms"]) * 1e3, 1),
                    "args": {k: v for k, v in r.items()
                             if k not in ("kind", "t_ms")}})
    for r in events:
        if r["event"] in ("alert_fire", "alert_resolve"):
            trace.append({
                "ph": "i", "s": "g", "name": f"{r['event']}:{r['rule']}",
                "pid": _PID_REQUESTS, "tid": 0,
                "ts": round(float(r["t_ms"]) * 1e3, 1),
                "args": {k: v for k, v in r.items()
                         if k not in ("kind", "t_ms")}})
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "stitch": {"stitch_failures": stitch["stitch_failures"]}}


def write_chrome_trace(path: str,
                       records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Dump :func:`chrome_trace` to ``path`` (open the file in Perfetto /
    ``chrome://tracing``); returns the trace object."""
    trace = chrome_trace(records)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace
