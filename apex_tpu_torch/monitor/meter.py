"""Per-request / per-tenant resource metering under a declarative
CostModel (the port's copy of ``apex_tpu/monitor/meter.py``).

"Who pays for what": every retired request is charged ONCE — at final
retirement, by whichever engine retired it — for the modeled resources it
consumed, and the charges roll up per tenant:

* ``flops``           — modeled forward flops (the closed-form sum of
  ``serve.engine.decode_flops_per_token`` over the request's prefill
  positions and decode contexts — :func:`modeled_request_flops`),
* ``kv_block_s``      — KV-pool block-seconds of occupancy
  (blocks held × admitted→retired wall seconds),
* ``adapter_s``       — LoRA adapter residency-seconds pinned by the
  request's slot,
* ``adapter_load_ms`` — pool install time (charged at ``load_adapter``,
  to the ``_fleet`` pseudo-tenant when no tenant is attributable),
* ``wire_bytes``      — KV-transfer bytes the cluster moved for the
  request (handoffs and migrations).

Charging at retirement is what makes the fleet ledger double-count-proof
across migration and replay: the source engine of a migrated request
evicts without retiring (no charge), the destination retires once
(one charge covering the whole request), and replayed tokens appear in
the token count once however many times they decoded.

:class:`CostModel` is a declarative ``resource → weight`` map; ``cost
units = Σ weight_r × usage_r``. Tenancy is cardinality-bounded exactly
like the router's WFQ ledger and the MetricsRegistry: past
``max_tenants`` distinct ids, new tenants fold into the ``_overflow``
pseudo-tenant and ``overflow_charges_total`` counts every folded charge —
a tenant-id explosion degrades LOUDLY (visible counters, bounded memory),
never silently.

The per-worker view (``worker_cost_rate``) is the routing signal of JAX's
serving cluster: each decode worker's accrued cost units per second,
advertised on the membership heartbeat next to its adapter residency and
quant mode, so an SLO-vs-cost router can prefer the cheapest worker that
still meets the deadline.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

__all__ = [
    "DEFAULT_WEIGHTS",
    "OVERFLOW_TENANT",
    "CostModel",
    "Meter",
    "modeled_request_flops",
]

RESOURCES = ("flops", "kv_block_s", "adapter_s", "adapter_load_ms",
             "wire_bytes")
_COUNTS = ("tokens", "requests", "shed")

OVERFLOW_TENANT = "_overflow"

# default weights: one cost unit ≈ one Tflop of modeled compute; the
# other resources are scaled to be same-order for the pinned bench model
# (operators override with their own CostModel — the POINT is that the
# weights are declarative, not baked into call sites)
DEFAULT_WEIGHTS: Dict[str, float] = {
    "flops": 1e-12,
    "kv_block_s": 1e-2,
    "adapter_s": 1e-2,
    "adapter_load_ms": 1e-3,
    "wire_bytes": 1e-9,
}


def modeled_request_flops(n_params: int, num_layers: int, hidden: int,
                          prompt_len: int, n_generated: int,
                          cached_tokens: int = 0) -> float:
    """Modeled forward flops for one whole request: the closed-form sum
    of the serve engine's per-token model (``2N + 4·L·hidden·context``)
    over the prefill positions actually computed (``cached_tokens``
    skipped via the prefix cache are NOT billed — cache hits are the
    tenant's discount) and the decode contexts ``p .. p+g-2`` (the first
    generated token falls out of the prefill's last chunk)."""
    def span(a: int, b: int) -> float:
        n = max(0, b - a)
        return (n * 2.0 * n_params
                + 4.0 * num_layers * hidden * (a + b - 1) * n / 2.0)

    prefill = span(cached_tokens, prompt_len)
    decode = span(prompt_len, prompt_len + max(0, n_generated - 1))
    return prefill + decode


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Declarative resource → cost-unit weights. Unknown resources weigh
    zero (forward-compatible: an old model prices a new resource at 0
    rather than raising mid-serve)."""

    weights: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_WEIGHTS))

    def cost(self, usage: Mapping[str, Any]) -> float:
        return sum(w * float(usage.get(r, 0.0) or 0.0)
                   for r, w in self.weights.items())

    def to_dict(self) -> Dict[str, float]:
        return dict(self.weights)

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "CostModel":
        return cls(weights={k: float(v) for k, v in d.items()})


def _new_ledger() -> Dict[str, float]:
    led: Dict[str, float] = {r: 0.0 for r in RESOURCES}
    led.update({c: 0 for c in _COUNTS})
    return led


class Meter:
    """The shared fleet ledger. One instance per cluster (engines of all
    workers charge into it — one charge per request means Σ tenants ==
    fleet totals to the unit), or one per standalone engine."""

    def __init__(self, model: Optional[CostModel] = None,
                 max_tenants: int = 1024):
        if max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
        self.model = model or CostModel()
        self.max_tenants = max_tenants
        self._tenants: Dict[str, Dict[str, float]] = {}
        # per-worker accrual for the heartbeat-advertised cost rate:
        # bounded by fleet size, never by tenant count
        self._workers: Dict[str, Dict[str, float]] = {}
        self.overflow_charges_total = 0

    # -- charging ----------------------------------------------------------
    def _ledger(self, tenant: str) -> Dict[str, float]:
        led = self._tenants.get(tenant)
        if led is None:
            if (len(self._tenants) >= self.max_tenants
                    and tenant != OVERFLOW_TENANT):
                # cardinality bound: fold, count, stay loud
                self.overflow_charges_total += 1
                return self._ledger(OVERFLOW_TENANT)
            led = self._tenants[tenant] = _new_ledger()
        return led

    def charge(self, tenant: Optional[str], *, worker: Optional[str] = None,
               t_ms: Optional[float] = None, tokens: int = 0,
               requests: int = 0, shed: int = 0,
               **usage: float) -> float:
        """Fold one charge into the tenant's ledger; returns the cost in
        units. ``worker``/``t_ms`` additionally accrue the worker's cost
        rate (pass the one shared event clock's ms)."""
        for k in usage:
            if k not in RESOURCES:
                raise ValueError(
                    f"unknown resource {k!r} (known: {RESOURCES})")
        led = self._ledger(tenant or "default")
        for k, v in usage.items():
            led[k] += float(v)
        led["tokens"] += int(tokens)
        led["requests"] += int(requests)
        led["shed"] += int(shed)
        cost = self.model.cost(usage)
        if worker is not None:
            w = self._workers.setdefault(
                worker, {"cost": 0.0, "t0_ms": None, "t1_ms": None})
            w["cost"] += cost
            if t_ms is not None:
                if w["t0_ms"] is None:
                    w["t0_ms"] = float(t_ms)
                w["t1_ms"] = float(t_ms)
        return cost

    # -- rollups -----------------------------------------------------------
    def _roll(self, led: Mapping[str, float]) -> Dict[str, Any]:
        cost = self.model.cost(led)
        toks, reqs = int(led["tokens"]), int(led["requests"])
        out: Dict[str, Any] = {r: round(float(led[r]), 6)
                               for r in RESOURCES}
        out.update({c: int(led[c]) for c in _COUNTS})
        out["cost_units"] = round(cost, 6)
        out["cost_per_token"] = round(cost / toks, 9) if toks else None
        out["cost_per_request"] = round(cost / reqs, 9) if reqs else None
        return out

    def tenant_rollup(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant usage + cost (``cost_per_token`` /
        ``cost_per_request`` included — the regress-gated billing view)."""
        return {t: self._roll(led)
                for t, led in sorted(self._tenants.items())}

    def totals(self) -> Dict[str, Any]:
        """The whole-fleet ledger: by construction the exact field-wise
        sum of every tenant's rollup (one charge, one ledger — the
        no-double-count acceptance pin)."""
        tot = _new_ledger()
        for led in self._tenants.values():
            for k, v in led.items():
                tot[k] += v
        return self._roll(tot)

    def worker_cost_rate(self, worker: str,
                         t_ms: Optional[float] = None) -> float:
        """Accrued cost units per second for one worker (0.0 before its
        first charge) — the heartbeat advertisement."""
        w = self._workers.get(worker)
        if w is None or w["t0_ms"] is None:
            return 0.0
        t1 = float(t_ms) if t_ms is not None else w["t1_ms"]
        dt_s = max((t1 - w["t0_ms"]) / 1e3, 1e-9)
        return w["cost"] / dt_s

    def worker_rates(self, t_ms: Optional[float] = None
                     ) -> Dict[str, float]:
        return {name: round(self.worker_cost_rate(name, t_ms), 6)
                for name in sorted(self._workers)}

    # -- exposition --------------------------------------------------------
    def stats(self, completed: Optional[int] = None) -> Dict[str, Any]:
        """One JSON-serializable meter snapshot. ``completed`` (the
        engine/cluster retirement count) yields ``meter_coverage`` —
        metered requests / completed requests, the health of the plane
        itself (higher-better under regress)."""
        tot = self.totals()
        out: Dict[str, Any] = {
            "totals": tot,
            "tenants": self.tenant_rollup(),
            "n_tenants": len(self._tenants),
            "max_tenants": self.max_tenants,
            "overflow_charges_total": self.overflow_charges_total,
            "cost_per_token": tot["cost_per_token"],
            "cost_per_request": tot["cost_per_request"],
            "cost_model": self.model.to_dict(),
        }
        if completed is not None:
            out["meter_coverage"] = (
                round(min(1.0, tot["requests"] / completed), 4)
                if completed else None)
        return out

    def collect_registry(self, reg, t_ms: Optional[float] = None) -> None:
        """Fold the ledger into a MetricsRegistry (``tenant=`` labels).
        Cardinality is pre-bounded by ``max_tenants``, so this composes
        with the registry's own ``max_series`` bound instead of fighting
        it."""
        for tname, led in self._tenants.items():
            cost = self.model.cost(led)
            reg.counter("meter_cost_units_total", cost, tenant=tname)
            reg.counter("meter_tokens_total", int(led["tokens"]),
                        tenant=tname)
            reg.counter("meter_requests_total", int(led["requests"]),
                        tenant=tname)
        reg.counter("meter_overflow_charges_total",
                    self.overflow_charges_total)
        reg.gauge("meter_tenants", float(len(self._tenants)),
                  t_ms=0.0 if t_ms is None else t_ms)
