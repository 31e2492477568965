"""Host-side monitoring of the port (counterpart of ``apex_tpu/monitor``):
so far the streaming histograms the serving engine keeps its latencies
in."""

from apex_tpu_torch.monitor.hist import (  # noqa: F401
    DEFAULT_LATENCY_SPEC,
    HistSpec,
    Histogram,
    bucket_indices,
    hist_counts,
)
