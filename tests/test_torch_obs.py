"""The port's observability (``repro_torch.obs``) against the JAX package's
(``repro.obs``).

Unit layer: the same synthetic event sequences go through the JAX object
and the port's, which must give equal registry snapshots, span trees,
Chrome-trace payloads, delay decompositions and validator verdicts.  Serve
layer: both engines (same bridged weights, the JAX engine's ``p`` and
thresholds copied into the port) serve the same prompts with a tracer and
a metrics collector attached; span kinds per request, histogram counts and
the roofline join's analytic columns must be equal, delay decompositions
equal at rtol 1e-9 (the serving tests' delay tolerance), and the port's
traced serve bitwise equal to its untraced serve.
"""
import json

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.roofline import constants as tconst

from torch_port_common import engine_pair

GEN = 4
THRESHOLD = 0.1
PACKAGES = {"jax": jobs, "port": tobs}


# ---------------------------------------------------------------------------
# unit layer: one synthetic event sequence, both packages
# ---------------------------------------------------------------------------


def _metrics_ops(obs):
    r = obs.MetricsRegistry()
    r.counter("a").inc()
    r.counter("a").inc(np.float64(2.5))
    for v in (1.0, np.float64(3.0), 2.0):
        r.gauge("g").set(v)
    h = r.histogram("h", lo_decade=-3, hi_decade=0, per_decade=8)
    for x in np.random.default_rng(0).uniform(1e-3, 1e-1, size=500):
        h.observe(x)
    h.observe(0.0)
    h.observe(1e5)
    return r


def test_metrics_registry_snapshot_matches_jax():
    want = _metrics_ops(jobs).snapshot()
    got = _metrics_ops(tobs).snapshot()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert _metrics_ops(tobs).histogram("h").counts == _metrics_ops(jobs).histogram("h").counts


def _emit_one_request(tr, rid=0, base=0.0):
    """The engine's hook sequence for one single-hop request."""
    tr.on_submit(base, rid, ed=0, arrival=base)
    tr.on_transfer(base, base + 0.01, 0.01, src=0, dst=2, rid=rid, mb=1.0)
    tr.on_enqueue(base + 0.01, rid, node=2)
    tr.on_batch(
        base + 0.03, 2, 1.0, 0.02, 0,
        stage=1, rids=(rid,), t_dispatch=base + 0.015, t_start=base + 0.02,
        n_rows=4, n_tokens=48, is_decode=False, wall_clock_s=1e-4,
    )
    tr.on_exit(base + 0.03, rid, stage=1, conf=0.9)


def _emit_resubmitted(tr):
    """A request whose replica fails while it waits, re-executed from its ED."""
    tr.on_submit(0.0, 7, ed=0, arrival=0.0)
    tr.on_transfer(0.0, 0.01, 0.01, src=0, dst=2, rid=7, mb=1.0)
    tr.on_enqueue(0.01, 7, node=2)
    tr.on_failure(0.02, node=2)
    tr.on_resubmit(0.02, 7)
    tr.on_transfer(0.02, 0.03, 0.01, src=0, dst=3, rid=7, mb=1.0)
    tr.on_enqueue(0.03, 7, node=3)
    tr.on_batch(0.05, 3, 1.0, 0.015, 0, stage=1, rids=(7,), t_dispatch=0.035, t_start=0.04,
                n_rows=1, n_tokens=12, is_decode=False, wall_clock_s=1e-4)
    tr.on_exit(0.05, 7, stage=1, conf=0.8)


def _synthetic(obs):
    """Three requests, a pool sample and a fail-stop re-execution, through
    a tracer and a metrics collector on one stream."""
    tr, mc = obs.SpanTracer(), obs.MetricsCollector()
    stream = obs.build_stream(tr, mc)
    for rid in range(3):
        _emit_one_request(stream, rid=rid, base=0.05 * rid)
    stream.on_pool(0.2, 2, 0.25, 1, 4)
    _emit_resubmitted(stream)
    return tr, mc


def _spans(tr):
    return {rid: [(s.kind, s.t0, s.t1, s.node, s.stage, s.attrs) for s in spans]
            for rid, spans in tr.spans.items()}


def test_tracer_synthetic_serve_matches_jax():
    (jt, jm), (tt, tm) = _synthetic(jobs), _synthetic(tobs)
    assert _spans(tt) == _spans(jt)
    assert tt.instants == jt.instants and tt.counters == jt.counters
    assert tt.attempts == jt.attempts == {0: 1, 1: 1, 2: 1, 7: 2}
    assert tt.clock.now == jt.clock.now
    for rid in jt.spans:
        assert tt.components(rid) == jt.components(rid)
        assert tt.check_tree(rid) == jt.check_tree(rid) == []
    assert {k: vars(v) for k, v in tt.compute_wall.items()} == {
        k: vars(v) for k, v in jt.compute_wall.items()}
    assert tm.snapshot() == jm.snapshot()


def test_chrome_trace_payload_matches_jax():
    (jt, _), (tt, _) = _synthetic(jobs), _synthetic(tobs)
    payload = tobs.chrome_trace(tt)
    assert json.dumps(payload) == json.dumps(jobs.chrome_trace(jt))
    assert tobs.validate_chrome_trace(payload) == []


def test_decompose_matches_jax():
    class Stats:  # the engine's ServeStats keeps parallel rid / delay lists
        rids = [0, 1, 2, 7]
        delays = [0.03, 0.03, 0.03, 0.06]  # rid 7's tree tiles only 0.05

    (jt, _), (tt, _) = _synthetic(jobs), _synthetic(tobs)
    for stats in (None, Stats()):
        got, want = tobs.decompose(tt, stats), jobs.decompose(jt, stats)
        assert got == want
    assert not got["reconciles"] and got["max_residual_s"] == pytest.approx(0.01)
    assert got["num_with_lost_time"] == 1


def _planted(obs):
    """Span trees with planted violations: a gap, a backwards span, no
    spans, and a tree that never closed."""
    tr = obs.SpanTracer()
    tr.add_span(1, "queue", 0.0, 0.01, node=2)
    tr.add_span(1, "compute", 0.02, 0.03, node=2)
    tr.add_span(2, "compute", 0.05, 0.01)
    tr.add_instant(0.5, "failure", node=3)
    tr.add_counter(0.5, "queue_depth", 3, 2)
    return tr


def test_check_tree_flags_the_same_violations():
    jt, tt = _planted(jobs), _planted(tobs)
    for rid in (0, 1, 2):
        assert tt.check_tree(rid) == jt.check_tree(rid) != []
    assert json.dumps(tobs.chrome_trace(tt)) == json.dumps(jobs.chrome_trace(jt))


CORRUPT = {
    "a list": [],
    "no traceEvents": {},
    "empty": {"traceEvents": []},
    "events not a list": {"traceEvents": 3},
    "negative duration": {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "s", "ts": 0.0, "dur": -5.0}]},
    "no ts": {"traceEvents": [{"ph": "i", "pid": 1, "tid": 0, "name": "x"}]},
    "unknown phase": {"traceEvents": [{"ph": "Q", "pid": 1, "ts": 0.0}]},
    "E without B": {"traceEvents": [{"ph": "E", "pid": 1, "tid": 0, "name": "s", "ts": 1.0}]},
    "unclosed B": {"traceEvents": [{"ph": "B", "pid": 1, "tid": 0, "name": "s", "ts": 1.0}]},
    "overlap": {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 5, "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "pid": 1, "tid": 5, "name": "b", "ts": 5.0, "dur": 10.0}]},
    "X without dur, no pid": {"traceEvents": [{"ph": "X", "tid": 0, "name": "s", "ts": 0.0}]},
}


@pytest.mark.parametrize("case", list(CORRUPT))
def test_validate_chrome_trace_catches_the_same_corruptions(case):
    errs = tobs.validate_chrome_trace(CORRUPT[case])
    assert errs and errs == jobs.validate_chrome_trace(CORRUPT[case])


def test_null_tracer_and_stream_dispatch():
    nt = tobs.NullTracer()
    nt.on_batch(0.0, 1, 1.0, 0.1, 0)
    nt.add_span(0, "queue", 0.0, 1.0)
    assert nt.wants_wall_clock is False
    with pytest.raises(AttributeError):
        nt.spans
    assert tobs.build_stream() is None
    assert tobs.build_stream(tobs.MetricsCollector()).wants_wall is False
    assert tobs.build_stream(tobs.MetricsCollector(), tobs.SpanTracer()).wants_wall is True
    assert tobs.SPAN_KINDS == jobs.SPAN_KINDS and tobs.HOOKS == jobs.HOOKS
    # the reference's exports, in its order, then the port's own host spans
    # (``tests/test_torch_host_spans.py``), which the reference has no
    # counterpart of
    assert tobs.__all__ == jobs.__all__ + ["HOST_SPANS", "HostSpan", "HostSpans"]


def test_roofline_constants_are_the_h100s():
    """The bound uses one H100 SXM's published dense bf16 peak and HBM rate,
    not the reference's TPU figures."""
    from repro.roofline import constants as jconst

    assert (tconst.PEAK_FLOPS_BF16, tconst.HBM_BW) == (989e12, 3.35e12)
    assert tconst.BYTES == jconst.BYTES
    assert not hasattr(tconst, "ICI_BW")


# ---------------------------------------------------------------------------
# serve layer: both engines traced on the same prompts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    return engine_pair(THRESHOLD)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 128, size=n).astype(np.int32) for n in (12, 8) * 5]


def _serve(engine, prompts, **kw):
    # slow enough arrivals that prompts join running decode batches
    engine.rng = np.random.default_rng(7)
    return engine.serve(prompts, arrival_rate=60.0, batch_size=4, gen_len=GEN,
                        decode_mode="cached", **kw)


@pytest.fixture(scope="module")
def traced(engines, prompts):
    """{package: (stats, tracer, metrics)} of one traced serve each."""
    out = {}
    for (name, obs), engine in zip(PACKAGES.items(), engines):
        tracer, metrics = obs.SpanTracer(), obs.MetricsCollector()
        out[name] = (_serve(engine, prompts, tracer=tracer, metrics=metrics), tracer, metrics)
    return out


def test_traced_serve_is_bitwise_the_untraced_serve(engines, prompts, traced):
    stats, _, _ = traced["port"]
    plain = _serve(engines[1], prompts)
    assert stats.sequences_by_rid() == plain.sequences_by_rid()
    assert stats.exit_stage == plain.exit_stage and stats.rids == plain.rids
    assert stats.delays == plain.delays
    assert plain.trace is None and stats.trace is traced["port"][1]


def test_serve_span_trees_match_jax(traced):
    (jstats, jtr, _), (tstats, ttr, _) = traced["jax"], traced["port"]
    assert tstats.sequences_by_rid() == jstats.sequences_by_rid()
    assert sorted(ttr.spans) == sorted(jtr.spans) == sorted(tstats.rids)
    for rid in jtr.spans:
        assert [s.kind for s in ttr.spans[rid]] == [s.kind for s in jtr.spans[rid]]
        assert ttr.check_tree(rid) == []
    assert {s.kind for spans in ttr.spans.values() for s in spans} == set(tobs.SPAN_KINDS)
    assert [i["kind"] for i in ttr.instants] == [i["kind"] for i in jtr.instants]


def test_serve_decomposition_matches_jax(traced):
    (jstats, jtr, _), (tstats, ttr, _) = traced["jax"], traced["port"]
    got, want = tobs.decompose(ttr, tstats), jobs.decompose(jtr, jstats)
    assert got["reconciles"] and got["max_residual_s"] == 0.0
    assert got["num_requests"] == want["num_requests"] == len(tstats.rids)
    for k in tobs.SPAN_KINDS:
        assert got["mean_components_s"][k] == pytest.approx(want["mean_components_s"][k],
                                                            rel=1e-9, abs=1e-15)
    by_rid = {e["rid"]: e for e in want["per_request"]}
    for e in got["per_request"]:
        for k in (*tobs.SPAN_KINDS, "total", "reported_delay"):
            assert e[k] == pytest.approx(by_rid[e["rid"]][k], rel=1e-9, abs=1e-15)
    assert got["per_node"].keys() == want["per_node"].keys()
    assert got["per_stage"].keys() == want["per_stage"].keys()
    assert {k: v["visits"] for k, v in got["per_stage"].items()} == {
        k: v["visits"] for k, v in want["per_stage"].items()}
    report = tstats.report()
    assert report["decomposition"]["reconciles"]
    assert report["summary"]["delay_components"] == got["mean_components_s"]
    json.dumps(report)


def test_serve_metrics_match_jax(traced):
    (jstats, _, jm), (tstats, _, tm) = traced["jax"], traced["port"]
    got, want = tm.registry, jm.registry
    assert got.names() == want.names()
    for name in want.names():
        g, w = got._metrics[name], want._metrics[name]
        if isinstance(w, jobs.Histogram):
            assert g.counts == w.counts and g.n == w.n, name
        elif isinstance(w, jobs.Counter):
            assert g.value == w.value, name
        else:
            assert (g.n_samples, g.max_value) == (w.n_samples, w.max_value), name
    assert tm.realized_exit_histogram() == jm.realized_exit_histogram()
    assert got.counter("batches").value == tstats.summary()["num_batches"]


def test_serve_roofline_rows_match_jax(engines, traced):
    (_, jtr, _), (_, ttr, _) = traced["jax"], traced["port"]
    got = tobs.roofline_utilization(ttr, engines[1].cfg)
    want = jobs.roofline_utilization(jtr, engines[0].cfg)
    assert got.keys() == want.keys() and {r["phase"] for r in got.values()} == {"prefill", "decode"}
    for key, row in got.items():
        for col in ("stage", "phase", "calls", "device_rows", "live_rows", "device_tokens",
                    "analytic_gflops", "analytic_gbytes", "padded_row_frac"):
            assert row[col] == want[key][col], (key, col)
        assert row["modeled_gflops"] == pytest.approx(want[key]["modeled_gflops"], rel=1e-9)
        bound = max(row["analytic_gflops"] * 1e9 / tconst.PEAK_FLOPS_BF16,
                    row["analytic_gbytes"] * 1e9 / tconst.HBM_BW)
        assert row["bound_s"] == pytest.approx(bound, rel=1e-12)
        assert row["measured_wall_s"] > 0
        assert row["utilization"] == row["bound_s"] / row["measured_wall_s"]


def test_attribution_report_matches_jax(engines, traced):
    """The model side (steady-state flows in float32) within f32 rounding."""
    (jeng, teng) = engines
    (jstats, jtr, _), (tstats, ttr, _) = traced["jax"], traced["port"]
    I_node = teng.state.stage_remaining[teng.topo.node_stage]  # EDs: entry 0, 1.0
    got = tobs.attribution_report(ttr, teng.p, teng.topo, teng.profile, I_node, tstats)
    want = jobs.attribution_report(jtr, jeng.p, jeng.topo, jeng.profile, I_node, jstats)
    assert got["reconciles"] and got["num_requests"] == want["num_requests"]
    for side in ("measured", "model"):
        for k, v in want[side].items():
            assert got[side][k] == pytest.approx(v, rel=1e-5, abs=1e-12), (side, k)
    assert got["per_node"].keys() == want["per_node"].keys()
    for j, row in want["per_node"].items():
        assert got["per_node"][j]["model_sojourn_s"] == pytest.approx(row["model_sojourn_s"],
                                                                      rel=1e-5)
        assert got["per_node"][j]["visits"] == row["visits"]
