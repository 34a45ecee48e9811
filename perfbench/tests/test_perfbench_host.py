"""The program's host spans as the benchmark reads them (``harness/host.py``,
``host_split.py``): the clock map under a CPU profiler, the idle and launch
join on synthetic events, the window's readings on a tiny cell, and the
traced span's join on a tiny cell with the CPU's matmuls standing in for
the device's kernels."""
from __future__ import annotations

import time

import pytest
import torch
from perfbench_tiny import tiny_cell

from perfbench import host_split
from perfbench.harness import host, runner, serve, trace
from repro_torch.obs import HostSpan, HostSpans


def test_clock_map_places_a_program_span_inside_its_profiler_range():
    hs = HostSpans()
    readings = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        readings.append(host.clock_marker())
        time.sleep(0.01)
        with torch.profiler.record_function("outer"):
            i = hs.begin("engine.serve")
            time.sleep(0.02)
            hs.end(i)
        time.sleep(0.03)
        readings.append(host.clock_marker())
    events = prof.profiler.kineto_results.events()
    _, _, clocks = host.device_activity(events)
    cmap = host.clock_map(clocks, readings)
    (outer,) = [e for e in events if e.name() == "outer"]
    (s,) = hs.spans
    ms = 1e6
    assert outer.start_ns() - ms <= cmap(s.t0) <= cmap(s.t1) <= outer.end_ns() + ms
    assert abs((cmap(s.t1) - cmap(s.t0)) - (s.t1 - s.t0)) < ms
    assert abs(cmap.drift_ns) < ms


def test_clock_map_takes_offset_and_drift_from_two_markers():
    # program readings (a, b), profiler ranges (start, end): the profiler's
    # clock 4000 ns ahead at the first marker, 4010 ns at the second
    cmap = host.clock_map([(5000, 5010), (6010, 6020)], [(1000, 1010), (2000, 2010)])
    assert cmap.drift_ns == 10
    assert cmap(1005) == 5005 and cmap(2005) == 6015
    assert cmap(1505) == pytest.approx(5510)
    with pytest.raises(RuntimeError):
        host.clock_map([(5000, 5010)], [(1000, 1010), (2000, 2010)])


def _S(name, t0, t1, parent=-1, attrs=None):
    return HostSpan(name, t0, t1, parent, attrs)


# one serve of two batches on an identity clock; the second batch's decode
# parts follow one another (``HostSpans.switch``: one ends where the next starts)
SPANS = [
    _S("engine.configuration", 0, 8),
    _S("engine.serve", 10, 200),
    _S("engine.batch", 20, 70, 1, (1, 4, 2, 2, 0)),
    _S("engine.input", 21, 30, 2),
    _S("stage.embed", 23, 28, 3),
    _S("stage.forward", 31, 50, 2),
    _S("stage.heads", 51, 55, 2),
    _S("engine.head_pull", 56, 68, 2),
    _S("engine.batch", 100, 150, 1, (2, 5, 2, 2, 1)),
    _S("engine.input", 101, 105, 8),
    _S("stage.decode", 106, 140, 8),
    _S("stage.gather", 107, 110, 10),
    _S("stage.layers", 110, 130, 10),
    _S("stage.scatter", 130, 139, 10),
]
IDENTITY = host.ClockMap([(0, 0), (1, 1)])


def test_join_labels_each_idle_gap_by_the_innermost_program_span():
    busy = [(24, 26), (40, 45), (44, 47), (57, 66), (112, 128), (135, 137), (205, 230)]
    j = host.program_join(SPANS, IDENTITY, busy, [], 5, 210)
    gaps = dict(j["idle_gaps_program"])
    # gaps: 5-24 (mid 14.5: serve), 26-40 (33: forward), 47-57 (52: heads),
    # 66-112 (89: serve), 128-135 (131.5: scatter), 137-205 (171: serve)
    assert gaps == pytest.approx({"engine.serve": (19 + 46 + 68) / 1e9,
                                  "stage.forward": 14 / 1e9, "stage.heads": 10 / 1e9,
                                  "stage.scatter": 7 / 1e9})
    busy_ns = 2 + 7 + 9 + 16 + 2 + 5  # clipped to the span, overlaps merged
    assert j["idle_s"] == pytest.approx((205 - busy_ns) / 1e9)
    assert j["idle_in_engine"] == pytest.approx(100 * 133 / 164)
    # before the first serve, between serves
    j = host.program_join(SPANS, IDENTITY, [(2, 4), (5, 7), (11, 12)], [], 0, 14)
    assert dict(j["idle_gaps_program"]) == pytest.approx(
        {"engine.configuration": 3e-9, "between serves": 4e-9, "engine.serve": 2e-9})


def test_join_places_each_launch_in_the_span_open_at_its_host_time():
    launches = [24, 29, 35, 49, 52, 60, 69, 104, 108, 110, 120, 131, 145, 300]
    j = host.program_join(SPANS, IDENTITY, [(0, 1)], launches, 0, 250)
    assert j["launches_by_span"] == {
        "stage.embed": 1, "engine.input": 2, "stage.forward": 2, "stage.heads": 1,
        "engine.head_pull": 1, "engine.batch": 2, "stage.gather": 1, "stage.layers": 2,
        "stage.scatter": 1}
    assert j["launches"] == 13 and j["batches"] == 2
    assert j["launches_per_batch"] == pytest.approx(8 / 2)
    assert j["launches_in_stage_or_input"] == pytest.approx(10 / 13)


def test_window_split_divides_the_hosts_time():
    hs = HostSpans()
    hs._spans = [list(s) for s in SPANS]
    w = host.window_split(hs, 0, 200)
    # stage: 5 + 19 + 4 + 34 = 62; head pull 12; engine: configuration 8 +
    # serve 190 less stage and pull
    assert w["batches"] == 2 and w["head_batches"] == 1 and w["decode_batches"] == 1
    assert w["stage_host_ms"] == pytest.approx(62 / 2 / 1e6)
    assert w["head_pull_ms"] == pytest.approx(12 / 1e6)
    assert w["engine_host_ms"] == pytest.approx((8 + 190 - 62 - 12) / 2 / 1e6)
    assert w["coverage"] == pytest.approx(198 / 200)
    assert w["self_ms_per_batch"]["stage.layers"] == pytest.approx(20 / 2 / 1e6)


@pytest.mark.parametrize("name", ["stablelm-1.6b.generate", "stablelm-1.6b.single_shot"])
def test_host_split_reads_a_tiny_cell(monkeypatch, name):
    for mod, attr in ((serve, "run_window"), (runner, "TraceSpan"), (runner, "run_cell")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))  # restored after the test
    lines = []
    cap = host_split.Capture(HostSpans())
    host_split.install(cap)
    torch.set_num_threads(1)
    result = runner.run_cell(tiny_cell(name), 2**31 + 7, float("inf"), False, "cpu", 0.0,
                             log=lines.append, max_slots=1)
    assert list(result)[-1] == "checks" and result["correct"]
    w = result["host"]["window"]
    assert w["batches"] == sum(s.name == "engine.batch" for s in cap.host_spans.spans) > 0
    for k in ("stage_host_ms", "engine_host_ms", "head_pull_ms"):
        assert w[k] > 0
    assert 0.95 <= w["coverage"] <= 1.0
    decode_parts = {"stage.gather", "stage.layers", "stage.scatter"}
    assert (decode_parts <= set(w["self_ms_per_batch"])) == name.endswith("generate")
    assert "span" not in result["host"]
    assert any(line.startswith("host spans over the window") for line in lines)
    assert any(line.startswith("kernels built by nvcc") for line in lines)


def test_marked_span_joins_a_traced_tiny_cell(monkeypatch):
    """A ``--trace 1`` run of a tiny cell through ``host_split``: the CPU has
    no device track, so each matmul's CPU event plays a kernel (busy, and
    launched at its start) and the benchmark's own device reading is a stub."""
    for mod, attr in ((serve, "run_window"), (runner, "TraceSpan"), (runner, "run_cell")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))
    real_activity = host.device_activity
    matmuls = ("aten::mm", "aten::addmm", "aten::bmm")

    def activity(events):
        mm = [e for e in events if e.name() in matmuls and e.duration_ns() > 0]
        _, _, clocks = real_activity(events)
        return [(e.start_ns(), e.end_ns()) for e in mm], [e.start_ns() for e in mm], clocks

    def summary(self):
        if self.t_start is None or self.t_stop is None:
            return None
        return {"busy_s": 0.0, "window_s": self.t_stop - self.t_start, "batches": self.batches,
                "calls": dict(self.calls), "least_s": dict(self.least_s),
                "op_device_s": dict.fromkeys(trace.OPS, 0.0), "op_kernels": {}, "unmatched": 0,
                "device_ops": [], "idle_gaps": []}

    monkeypatch.setattr(host, "device_activity", activity)
    monkeypatch.setattr(trace.TraceSpan, "summary", summary)
    lines = []
    cap = host_split.Capture(HostSpans())
    host_split.install(cap)
    torch.set_num_threads(1)
    cell = tiny_cell("stablelm-1.6b.single_shot", slot_requests=24, trace={"seconds": 0.3})
    result = runner.run_cell(cell, 2**31 + 11, 0.5, True, "cpu", 0.0, log=lines.append)
    assert result["correct"] and list(result)[-1] == "checks"
    assert len(cap.span.readings) == 2  # a marker as the profiler starts, one before it stops
    j = result["host"]["span"]
    assert abs(j["clock_drift_ms"]) < 1.0
    assert j["batches"] > 0 and j["launches"] > 0
    # every matmul runs inside a stage program: the heads' too
    assert j["launches_in_stage_or_input"] == 1.0
    assert set(j["launches_by_span"]) <= {"stage.forward", "stage.heads", "stage.embed"}
    assert j["launches_per_batch"] == pytest.approx(j["launches"] / j["batches"])
    assert 0.0 <= j["idle_in_engine"] <= 100.0
    assert j["idle_s"] == pytest.approx(sum(s for _, s in j["idle_gaps_program"]), rel=1e-6)
    assert any(line.startswith("host spans over the traced span") for line in lines)
