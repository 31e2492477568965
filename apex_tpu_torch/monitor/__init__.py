"""Host-side monitoring of the port (counterpart of ``apex_tpu/monitor``).

* :mod:`~apex_tpu_torch.monitor.hist` — streaming histograms (JAX's
  buckets, bit for bit);
* :mod:`~apex_tpu_torch.monitor.metrics` — :class:`Metrics`, named fp32
  scalars of one step, :func:`global_norm`, :func:`train_metrics`;
* :mod:`~apex_tpu_torch.monitor.trace` — :func:`span` ranges in the torch
  profiler and NVTX, :func:`step_annotation`;
* :mod:`~apex_tpu_torch.monitor.sink` — :class:`JsonlSink`, the rank-0,
  buffered, rotating JSONL writer, and :func:`json_record`;
* :mod:`~apex_tpu_torch.monitor.events` — :class:`EventLog` request
  lifecycles on one clock, :func:`chrome_trace` / :func:`request_spans` /
  :func:`stitch_traces`;
* :mod:`~apex_tpu_torch.monitor.slo` — :class:`SloSpec` budgets and the
  :class:`SloTracker` goodput accounting;
* :mod:`~apex_tpu_torch.monitor.meter` — :class:`CostModel` /
  :class:`Meter` per-tenant charges;
* :mod:`~apex_tpu_torch.monitor.registry` — :class:`MetricsRegistry`
  (Prometheus text, snapshots), :func:`merge_snapshots`,
  :class:`FleetView`, :class:`FleetScraper`.
"""

from apex_tpu_torch.monitor.events import (  # noqa: F401
    EventLog,
    chrome_trace,
    dedupe_events,
    request_spans,
    stitch_traces,
    write_chrome_trace,
)
from apex_tpu_torch.monitor.hist import (  # noqa: F401
    DEFAULT_LATENCY_SPEC,
    HistSpec,
    Histogram,
    bucket_indices,
    hist_counts,
)
from apex_tpu_torch.monitor.meter import (  # noqa: F401
    CostModel,
    Meter,
    modeled_request_flops,
)
from apex_tpu_torch.monitor.metrics import (  # noqa: F401
    Metrics,
    global_norm,
    train_metrics,
)
from apex_tpu_torch.monitor.registry import (  # noqa: F401
    FleetScraper,
    FleetView,
    MetricsRegistry,
    merge_snapshots,
)
from apex_tpu_torch.monitor.sink import (  # noqa: F401
    SCHEMA_VERSION,
    JsonlSink,
    collect_provenance,
    json_record,
    read_jsonl,
    rotated_segments,
    set_provenance,
)
from apex_tpu_torch.monitor.slo import SloSpec, SloTracker  # noqa: F401
from apex_tpu_torch.monitor.trace import (  # noqa: F401
    PHASES,
    span,
    span_function,
    step_annotation,
)
