"""repro_torch.obs: metrics on the device, span tracing, export sinks.

The port of ``repro.obs``: engine-side accumulators on tensors
(``Collector``, ``PhaseStats``, ``StreamingHistogram``), a Chrome-trace
span tracer on the host clock (``SpanTracer``) and JSONL/CSV/JSON export
(``EventLog``, ``MetricsReport``). Everything is opt-in: the entry
points of ``net``, ``fl`` and ``launch`` take ``collector=None`` (or
``log_jsonl=None``), and that default is bitwise the run without this
package.
"""
from repro_torch.obs.export import (  # noqa: F401
    EventLog,
    JsonlSink,
    MetricsReport,
    write_summary_csv,
    write_summary_json,
)
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_DELAY_EDGES,
    DEFAULT_UTIL_EDGES,
    Collector,
    CounterArray,
    GaugeArray,
    PhaseStats,
    StreamingHistogram,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    SpanTracer,
    load_trace,
    maybe_span,
    validate_trace,
)
