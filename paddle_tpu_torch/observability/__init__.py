"""Unified telemetry of the port (port of paddle_tpu/observability/):

- `registry`: typed metrics (Counter, Gauge, Histogram, labels) with
  ``render_prometheus()`` / ``dump_json()``; `utils.monitor` is its
  flat-dict shim;
- `exporter`: a thread appending JSON snapshots to
  ``FLAGS_metrics_export_path`` (nothing while the flag is empty);
- `step_metrics`: ``StepMetrics``, the step time (CUDA events on the
  card), examples and tokens per second, MFU from the analytic FLOPs
  (`ops.flops`), memory watermarks; ``hapi.Model.fit`` runs under it;
- `flight_recorder`: a bounded ring of recent events dumped on an
  unhandled exception and on SIGTERM;
- `tracing`: request tracing with tail-based sampling (``TraceContext``,
  ``Span``), spooled under ``FLAGS_trace_dir`` (nothing while it is
  empty) and merged and exported as chrome traces."""
from . import registry  # noqa: F401
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
    counter, gauge, histogram, log_buckets,
    render_prometheus, dump_json,
)
from . import exporter  # noqa: F401
from .exporter import (  # noqa: F401
    MetricsExporter, maybe_start_exporter, stop_exporter, get_exporter,
)
from . import step_metrics  # noqa: F401
from .step_metrics import StepMetrics, sample_memory_watermarks  # noqa: F401
from . import flight_recorder  # noqa: F401
from .flight_recorder import FlightRecorder  # noqa: F401
from . import tracing  # noqa: F401
from .tracing import TraceContext, Span  # noqa: F401
