"""Profiler of the port (paddle_tpu/profiler): so far only the shared
chrome-trace writer, `write_chrome_trace`, that request tracing's export
(`observability.tracing.export_chrome`) writes through.  The `Profiler`
and `RecordEvent` wait for ROADMAP A9."""
from .profiler import write_chrome_trace

__all__ = ["write_chrome_trace"]
