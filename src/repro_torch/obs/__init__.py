"""Observability of the port: the instrumentation stream only so far; the
tracer, metrics and exporters of ``repro.obs`` are not ported yet (ROADMAP)."""
from repro_torch.obs.stream import HOOKS, InstrumentationStream, build_stream

__all__ = ["HOOKS", "InstrumentationStream", "build_stream"]
