"""Observability of the port's serving engine: spans, metrics, exporters,
delay attribution and the roofline join (the counterpart of ``repro.obs``),
and the port's own host spans (``HostSpans``: the host's wall at the
engine's and stage programs' boundaries, never synchronizing the device)."""
from repro_torch.obs.attribution import attribution_report, decompose
from repro_torch.obs.export import chrome_trace, validate_chrome_trace, write_chrome_trace
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsCollector,
    MetricsRegistry,
)
from repro_torch.obs.roofline_hook import roofline_utilization
from repro_torch.obs.stream import HOOKS, InstrumentationStream, build_stream
from repro_torch.obs.trace import (
    HOST_SPANS,
    SPAN_KINDS,
    HostSpan,
    HostSpans,
    NullTracer,
    SimClock,
    Span,
    SpanTracer,
)

__all__ = [
    "attribution_report",
    "decompose",
    "chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsCollector",
    "MetricsRegistry",
    "roofline_utilization",
    "HOOKS",
    "InstrumentationStream",
    "build_stream",
    "SPAN_KINDS",
    "NullTracer",
    "SimClock",
    "Span",
    "SpanTracer",
    "HOST_SPANS",
    "HostSpan",
    "HostSpans",
]
