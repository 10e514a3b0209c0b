"""Tracing, histograms and the metrics plane of the PyTorch port, the
port of elasticdl_tpu/observability/ (no torch anywhere in it).

* tracing    trace and span ids, `Span`, the `SpanRecorder` with
             tail-based retention, the process recorder, Chrome trace
* histogram  `LogLinearHistogram` (exemplars included), `percentiles()`
* metrics    `TimeSeriesRing`, the Prometheus exposition
             (`render_prometheus`, `MetricsServer` behind --metrics_port /
             EDL_METRICS_PORT)
* slo        declared objectives as multi-window burn rates
* promparse  the independent text-format parser
* dump       ``python -m elasticdl_tpu_torch.observability.dump``: span
             exports merged into one trace, drops by service
* forensics  `attribute()`: a span tree to a latency breakdown and a
             dominant cause of `CAUSES`
* collector  ``python -m elasticdl_tpu_torch.observability.collector``:
             scrape, re-evaluate, join exemplars to traces, report
* runtime_health  the runtime's self-report: `tracked_call` and
             `RecompileSentry` (compiles per named site, steady-boundary
             anomalies), `DeviceMemoryAccountant` (the byte ledger against
             the allocator, a leak watermark), `ProgressWatchdog` and
             `FlightRecorder` (stalls seen off the scheduler thread,
             diagnostic bundles), `install_sigusr2_dump`

The exports are the JAX package's list (runtime_health is imported by
its module path there too).
"""

from elasticdl_tpu_torch.observability.forensics import (  # noqa: F401
    CAUSES,
    attribute,
    cause_histogram,
)
from elasticdl_tpu_torch.observability.histogram import (  # noqa: F401
    LogLinearHistogram,
    percentiles,
)
from elasticdl_tpu_torch.observability.metrics import (  # noqa: F401
    MetricsServer,
    TimeSeriesRing,
    merge_window_deltas,
    metrics_port_default,
    render_prometheus,
)
from elasticdl_tpu_torch.observability.slo import (  # noqa: F401
    BurnRateEngine,
    SloSpec,
    default_router_slos,
)
from elasticdl_tpu_torch.observability.tracing import (  # noqa: F401
    Span,
    SpanRecorder,
    chrome_trace,
    configure,
    new_span_id,
    new_trace_id,
    recorder,
)
