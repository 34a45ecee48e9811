"""The program's host spans (``repro_torch.obs.HostSpans``) as the benchmark
reads them: over the window, the host's time a stage batch by what the host
is doing; over the traced span, joined to the device trace on one clock.

``run.py`` does not turn the spans on: ``perfbench/host_split.py`` runs a
cell as ``run.py`` does with them on, and adds these readings to its result.

Over the window (no profiler running), ``window_split``:

* ``stage_host_ms``: time in ``stage.*`` spans (nested ones once) over the
  window's stage batches: the host's cost of launching a stage;
* ``engine_host_ms``: the engine's self time (``engine.*`` spans less the
  ``stage.*`` and ``engine.head_pull`` spans inside them) over the same
  batches: scheduling, batch formation, input assembly, handoff, routing,
  the DTO-EE configuration phase;
* ``head_pull_ms``: time in ``engine.head_pull`` over the window's head
  batches: how long the host waits for the card when it needs an answer.
  A faster host raises it, since the card is then further behind;
* ``coverage``: the share of the window's wall those three cover.

Over the traced span, ``MarkedSpan`` (the traced span of ``trace.py`` with
a clock marker, a ``perfbench.clock`` profiler range around two
``perf_counter_ns`` readings, as the profiler starts and before it stops)
maps the program's clock onto the profiler's (``ClockMap``: offset and
drift from the two markers), and ``program_join`` labels each idle gap of
the device by the innermost program span open at its middle (or ``between
serves``) and each kernel launch (the CUDA runtime or driver API call
matched to a device event by correlation id) by the span open at its host
timestamp.
"""
from __future__ import annotations

from collections import Counter
from time import perf_counter_ns

import torch

from perfbench.harness.trace import TraceSpan

CLOCK = "perfbench.clock"
BETWEEN = "between serves"


def _per(ns: float, n: int) -> float | None:
    return ns / n / 1e6 if n else None


def window_split(hs, lo: int, hi: int) -> dict:
    """The window ``[lo, hi]`` (``perf_counter_ns``) of ``hs``'s spans."""
    own = hs.self_ns(lo, hi)
    stage = sum(v for k, v in own.items() if k.startswith("stage."))
    pull = own["engine.head_pull"]
    engine = sum(v for k, v in own.items() if k.startswith("engine.")) - pull
    spans = hs.spans
    batches = sum(1 for s in spans if s.name == "engine.batch" and lo <= s.t1 <= hi)
    pulls = sum(1 for s in spans if s.name == "engine.head_pull" and lo <= s.t1 <= hi)
    decode = sum(1 for s in spans if s.name == "engine.batch" and lo <= s.t1 <= hi
                 and s.attrs is not None and s.attrs[4])
    return {
        "stage_host_ms": _per(stage, batches),
        "engine_host_ms": _per(engine, batches),
        "head_pull_ms": _per(pull, pulls),
        "coverage": (stage + engine + pull) / (hi - lo),
        "batches": batches,
        "head_batches": pulls,
        "decode_batches": decode,
        "batches_per_s": batches / ((hi - lo) / 1e9),
        "self_ms_per_batch": {k: _per(v, batches) for k, v in own.items() if v},
    }


# -- one clock ---------------------------------------------------------------
def clock_marker() -> tuple[int, int]:
    """Two ``perf_counter_ns`` readings inside a ``perfbench.clock`` range.
    A range of another name goes first: the first range after the profiler
    starts pays a set-up on entering it, which would move its middle."""
    with torch.profiler.record_function(CLOCK + ".warm"):
        pass
    with torch.profiler.record_function(CLOCK):
        a = perf_counter_ns()
        b = perf_counter_ns()
    return a, b


class ClockMap:
    """``perf_counter_ns`` on the profiler's clock, through the first and the
    last of (program time, profiler time) pairs; ``drift_ns`` is how far the
    two clocks' offset moved between them."""

    def __init__(self, pairs):
        (p0, q0), (p1, q1) = pairs[0], pairs[-1]
        self.p0, self.q0 = p0, q0
        self.slope = (q1 - q0) / (p1 - p0) if p1 != p0 else 1.0
        self.drift_ns = (q1 - p1) - (q0 - p0)

    def __call__(self, t: float) -> float:
        return self.q0 + (t - self.p0) * self.slope


def clock_map(ranges, readings) -> ClockMap:
    """``ranges``: the (start, end) of each ``perfbench.clock`` range on the
    profiler's clock; ``readings``: each marker's two readings, in order.
    A marker stands at the middle of its range and of its readings."""
    if len(ranges) != len(readings) or len(ranges) < 2:
        raise RuntimeError(f"{len(ranges)} clock ranges in the trace for {len(readings)} markers")
    return ClockMap([((a + b) / 2, (s + e) / 2)
                     for (s, e), (a, b) in zip(sorted(ranges), readings)])


def device_activity(events):
    """(the device's intervals: kernels, copies, memsets; the host time of
    each kernel launch that ran on the device; the clock ranges), all on
    the profiler's clock, from its kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type() == cuda and e.duration_ns() > 0
           and not e.name().startswith("perfbench.")]
    host = [e for e in events if e.device_type() != cuda]
    # the CUDA runtime or driver API call that launched a kernel (``cu...``);
    # the host's ops number their own events from 1 too, so they are left out
    launch_at = {e.correlation_id(): e.start_ns() for e in host
                 if e.name().startswith("cu") and "Launch" in e.name()}
    launches = [launch_at[e.correlation_id()] for e in dev if e.correlation_id() in launch_at]
    busy = [(e.start_ns(), e.end_ns()) for e in dev]
    clocks = [(e.start_ns(), e.end_ns()) for e in host if e.name() == CLOCK]
    return busy, launches, clocks


def innermost(spans, points) -> list[str]:
    """The name of the innermost span open at each point (ascending), or
    ``between serves``; ``spans`` (start, end, name) nest, sorted by start
    and, among those starting together, outer first."""
    out, stack, j = [], [], 0
    for t in points:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else BETWEEN)
    return out


def program_join(spans, cmap, busy, launches, lo: float, hi: float) -> dict:
    """The traced span ``[lo, hi]`` (profiler clock): its idle gaps and
    kernel launches by program span (``spans``: ``HostSpan`` on the
    program's clock, mapped through ``cmap``)."""
    merged: list[list] = []
    for s, e in sorted(busy):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [lo] + [t for iv in merged for t in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    # outer spans first where two start together
    mapped = sorted(((cmap(s.t0), cmap(s.t1), s.name) for s in spans),
                    key=lambda m: (m[0], -m[1]))
    idle: dict[str, float] = {}
    for (a, b), label in zip(gaps, innermost(mapped, [(a + b) / 2 for a, b in gaps])):
        idle[label] = idle.get(label, 0.0) + (b - a)
    inside = sorted(t for t in launches if lo <= t <= hi)
    by_span = Counter(innermost(mapped, inside))
    in_stage = sum(n for k, n in by_span.items() if k.startswith("stage."))
    batches = sum(1 for s in spans if s.name == "engine.batch" and lo <= cmap(s.t1) <= hi)
    idle_ns = sum(idle.values())
    in_engine = sum(v for k, v in idle.items() if k.startswith("engine.") or k == BETWEEN)
    return {
        "idle_in_engine": 100.0 * in_engine / idle_ns if idle_ns else None,
        "launches_per_batch": in_stage / batches if batches else None,
        "launches_in_stage_or_input": ((in_stage + by_span["engine.input"]) / len(inside)
                                       if inside else None),
        "idle_s": idle_ns / 1e9,
        "batches": batches,
        "launches": len(inside),
        "launches_by_span": dict(by_span),
        "idle_gaps_program": sorted(((k, v / 1e9) for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:10],
    }


class MarkedSpan(TraceSpan):
    """``trace.TraceSpan`` with a clock marker as the profiler starts and one
    before it stops; its summary also joins ``host_spans`` to the trace
    (``join``)."""

    def __init__(self, seconds: float, device, host_spans):
        super().__init__(seconds, device)
        self.host_spans = host_spans
        self.readings: list[tuple[int, int]] = []
        self.join = None

    def tick(self, now: float, window_end: float) -> None:
        starting = self.t_start is None
        if not starting and self.t_stop is None and now >= self.t_start + self.seconds:
            self.readings.append(clock_marker())
        super().tick(now, window_end)
        if starting and self.t_start is not None:
            self.readings.append(clock_marker())

    def summary(self) -> dict | None:
        out = super().summary()
        if out is None:
            return None
        busy, launches, clocks = device_activity(self.prof.profiler.kineto_results.events())
        cmap = clock_map(clocks, self.readings)
        lo, hi = cmap(round(self.t_start * 1e9)), cmap(round(self.t_stop * 1e9))
        self.join = program_join(self.host_spans.spans, cmap, busy, launches, lo, hi)
        self.join["clock_drift_ms"] = cmap.drift_ns / 1e6
        self.join["profiler_idle_s"] = out["window_s"] - out["busy_s"]
        return out
