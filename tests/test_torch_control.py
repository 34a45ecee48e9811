"""The port's online control plane (``repro_torch.control``) against the JAX
package's (``repro.control``).

Estimators and scenario builders fed the same inputs must agree exactly; a
controller planning on the same telemetry must give the same decision, the
same thresholds and ``p`` at atol 1e-5 (the port's DTO-EE matches the
reference to that, ``tests/test_torch_core.py``).  Whole serves under a
controller can route differently after the first install, so they are held
to their decisions (when and how often they reconfigure, which replica is
slowed or dead), and to tokens only where routing cannot drift.
"""
import dataclasses

import numpy as np
import pytest

import repro.control as jctl
import repro_torch.control as tctl
from repro.core import dto_ee as jdto
from repro.obs import SpanTracer as JTracer
from repro_torch.core import dto_ee as tdto
from repro_torch.obs import MetricsCollector, SpanTracer, decompose

from torch_port_common import engine_pair

THRESHOLD = 0.1
RATE = 60.0


@pytest.fixture(scope="module")
def pair():
    # replicas at 0.5% of nameplate: stage services of ~10-50 ms, as the
    # JAX package's control tests use, so that replicas hold queues
    return engine_pair(THRESHOLD, capacity_scale=0.005)


@pytest.fixture
def engines(pair):
    """The module's engine pair, put back after each test as it was: serves
    under a controller or a failure replace the engines' topology view,
    strategy and round program, and every serve moves the capacity EWMA."""
    saved = [(e.topo, dto.clone_state(e.state), e._round_step, e.straggler.mu_hat.copy())
             for e, dto in zip(pair, (jdto, tdto))]
    yield pair
    for e, (topo, state, step, mu) in zip(pair, saved):
        e.topo, e.state, e._round_step = topo, state, step
        e.straggler.mu_hat[:] = mu


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 128, size=12).astype(np.int32) for _ in range(12)]


def _serve(engine, prompts, seed=7, **kw):
    engine.rng = np.random.default_rng(seed)
    kw.setdefault("arrival_rate", RATE)
    kw.setdefault("batch_size", 4)
    return engine.serve(prompts, **kw)


def _by_rid(stats, values):
    return [v for _, v in sorted(zip(stats.rids, values))]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def _feed(tele, topo):
    """Arrivals, a throttled replica's batches, transfers, exits and a
    failure, out of timestamp order as the engine emits them."""
    ed, node, other = (int(topo.nodes_at_stage(0)[0]), int(topo.nodes_at_stage(1)[0]),
                       int(topo.nodes_at_stage(2)[1]))
    mu = float(topo.mu[node]) * 0.1
    for k in range(30):
        tele.on_arrival(0.1 * k, ed, k)
        tele.on_batch(0.01 * k + 0.05, node, mu * 0.01, 0.01, k % 3)
    tele.on_batch(0.02, other, 3.0, 0.5, 1)
    for e in range(3):
        tele.on_transfer(0.1 * e, 0.1 * e + 0.4, 0.4 + e, int(topo.edge_src[e]),
                         int(topo.edge_dst[e]), mb=1.0 + e)
    tele.on_transfer(0.3, 0.3, 0.0, 0, 1, mb=1.0)  # zero-time hop: ignored
    for rid, stage in enumerate((2, 2, 3, 4, 4, 4)):
        tele.on_exit(0.5 + 0.1 * rid, rid, stage)
    tele.on_failure(2.5, int(topo.nodes_at_stage(2)[0]))


def test_telemetry_estimates_match_jax(engines):
    jeng, teng = engines
    cfg = tctl.TelemetryConfig(window_s=1.0, ewma_alpha=0.3)
    jt = jctl.Telemetry(jeng.topo, jctl.TelemetryConfig(window_s=1.0, ewma_alpha=0.3))
    tt = tctl.Telemetry(teng.topo, cfg)
    _feed(jt, jeng.topo)
    _feed(tt, teng.topo)
    eff_t, eff_j = tt.effective_topology(teng.topo, 1.0), jt.effective_topology(jeng.topo, 1.0)
    for field in ("mu", "phi_ext", "edge_rate"):
        np.testing.assert_array_equal(getattr(eff_t, field), getattr(eff_j, field))
    eff_t.validate()
    node = int(teng.topo.nodes_at_stage(1)[0])
    assert eff_t.mu[node] == pytest.approx(float(teng.topo.mu[node]) * 0.1, rel=0.05)
    for now in (0.3, 1.0, 2.9, 6.0):  # the windows evict as ``now`` advances
        np.testing.assert_array_equal(tt.arrival_rates(teng.topo, now),
                                      jt.arrival_rates(jeng.topo, now))
        np.testing.assert_array_equal(tt.mu_estimates(teng.topo, now),
                                      jt.mu_estimates(jeng.topo, now))
        np.testing.assert_array_equal(tt.exit_fractions(now), jt.exit_fractions(now))
        assert tt.snapshot(teng.topo, now) == jt.snapshot(jeng.topo, now)
    np.testing.assert_array_equal(tt.edge_rate_estimates(teng.topo),
                                  jt.edge_rate_estimates(jeng.topo))
    np.testing.assert_array_equal(tt.queue_depths(), jt.queue_depths())


# ---------------------------------------------------------------------------
# the controller's plan
# ---------------------------------------------------------------------------


def _plan(ctl, eng, tele_cls, cfg, **ccfg):
    tele = tele_cls(eng.topo, cfg)
    _feed(tele, eng.topo)
    controller = ctl.ReconfigController(tele, ctl.ControllerConfig(**ccfg))
    return controller, controller.plan(eng, now=1.0)


@pytest.mark.parametrize("ccfg", [
    {"rounds": 10},  # the throttled replica's drift triggers a plan
    {"rounds": 10, "adapt_thresholds": False},
    {"rounds": 10, "drift_deadband": 100.0},  # hysteresis: skip
    {"rounds": 10, "drift_deadband": -1.0, "p_deadband": 1e9, "adapt_thresholds": False},  # hold
])
def test_controller_plan_matches_jax(engines, ccfg):
    jeng, teng = engines
    jc, jplan = _plan(jctl, jeng, jctl.Telemetry, jctl.TelemetryConfig(window_s=1.0), **ccfg)
    tc, tplan = _plan(tctl, teng, tctl.Telemetry, tctl.TelemetryConfig(window_s=1.0), **ccfg)
    assert [e["action"] for e in tc.log] == [e["action"] for e in jc.log]
    assert (tplan is None) == (jplan is None)
    if jplan is None:
        return
    np.testing.assert_allclose(tplan.state.carry.p.numpy(), np.asarray(jplan.state.carry.p),
                               atol=1e-5)
    np.testing.assert_array_equal(tplan.state.thresholds, jplan.state.thresholds)
    assert tplan.decision_time == jplan.decision_time and tplan.drift == jplan.drift
    np.testing.assert_array_equal(tplan.topo.mu, jplan.topo.mu)
    assert tc.install(teng, tplan) and teng.state is tplan.state and teng.topo is tplan.topo
    if not ccfg.get("adapt_thresholds", True):
        np.testing.assert_array_equal(tplan.state.thresholds, jeng.state.thresholds)


def test_noop_reconfig_install_is_bitwise_invisible(engines, prompts):
    """Installs of zero-round phases (p and thresholds unchanged) mid-serve
    leave every request bitwise as an uninterrupted serve has it."""
    _, teng = engines
    ref = _serve(teng, prompts, gen_len=3, decode_mode="cached")
    ctl = tctl.ReconfigController(
        tctl.Telemetry(teng.topo, tctl.TelemetryConfig(window_s=0.1)),
        tctl.ControllerConfig(interval=0.03, rounds=0, drift_deadband=-1.0, p_deadband=-1.0),
    )
    stats = _serve(teng, prompts, gen_len=3, decode_mode="cached", controller=ctl)
    assert stats.num_reconfigs > 0 and len(stats.reconfig_times) == stats.num_reconfigs
    assert stats.sequences_by_rid() == ref.sequences_by_rid()
    assert stats.exit_stage == ref.exit_stage and stats.delays == ref.delays


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jctl.SCENARIO_NAMES)
def test_scenario_builders_match_jax(engines, name):
    jeng, teng = engines
    want = jctl.get_scenario(name, jeng.topo, p=jeng.p, horizon=2.0, seed=3)
    got = tctl.get_scenario(name, teng.topo, p=teng.p, horizon=2.0, seed=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tctl.busiest_replica(teng.topo, None) == jctl.busiest_replica(jeng.topo, None)
    assert tctl.SCENARIO_NAMES == jctl.SCENARIO_NAMES and tctl.__all__ == jctl.__all__


def test_slowdown_is_detected_and_reconfigured_as_in_jax(engines, prompts):
    """Both engines, each with its own package's telemetry, controller and
    scenario, throttle the same replica and reconfigure at the same times."""
    span = len(prompts) / RATE
    out = {}
    for ctl, eng in zip((jctl, tctl), engines):
        victim = ctl.busiest_replica(eng.topo, eng.p)
        mu0 = float(eng.topo.mu[victim])
        scn = ctl.node_slowdown(eng.topo, 0.1 * span, 10 * span, factor=0.1, node=victim)
        tele = ctl.Telemetry(eng.topo, ctl.TelemetryConfig(window_s=span / 6))
        ctrl = ctl.ReconfigController(
            tele, ctl.ControllerConfig(interval=span / 6, rounds=5, drift_deadband=0.2))
        stats = _serve(eng, prompts, scenario=scn, controller=ctrl)
        out[ctl] = (victim, mu0, stats, [e["action"] for e in ctrl.log])
        assert float(eng.topo.mu[victim]) > 0.1 * mu0  # the view never saw the scenario
    (jv, jmu, js, jlog), (tv, tmu, ts, tlog) = out[jctl], out[tctl]
    assert tv == jv and tmu == jmu
    assert len(ts.delays) == len(prompts)
    assert ts.num_reconfigs == js.num_reconfigs >= 1
    assert ts.reconfig_times == pytest.approx(js.reconfig_times, rel=1e-12)
    assert tlog == jlog
    # the capacity estimate moved from nameplate toward the slowed rate
    cap = ts.summary()["capacity_estimates"][tv]
    assert 0.1 * tmu <= cap < tmu
    assert cap == pytest.approx(js.summary()["capacity_estimates"][jv], rel=1e-6)


def test_failure_scenario_completes_with_closed_spans_as_in_jax(engines, prompts):
    """Fail-stop with arrivals fast enough that the victim holds queued work:
    every request completes, re-executed ones with their abandoned wait as
    lost time; no controller, so the port routes as the JAX engine does."""
    out = {}
    for ctl, eng, tracer in zip((jctl, tctl), engines, (JTracer(), SpanTracer())):
        scn = ctl.get_scenario("failure", eng.topo, p=eng.p, horizon=len(prompts) / RATE)
        stats = _serve(eng, prompts, scenario=scn, tracer=tracer, arrival_rate=4 * RATE)
        out[ctl] = (scn.events[0].node, stats, tracer, eng)
    (jdead, js, _, _), (tdead, ts, tracer, teng) = out[jctl], out[tctl]
    assert tdead == jdead and tdead not in set(teng.topo.edge_dst.tolist())
    assert len(ts.delays) == len(prompts)
    assert ts.resubmitted == js.resubmitted > 0
    # exits as the JAX engine's; tokens as the port's own plain serve's (the
    # two packages' single-shot tokens differ at a near-tie: ROADMAP Queue 3)
    assert _by_rid(ts, ts.exit_stage) == _by_rid(js, js.exit_stage)
    plain = _serve(teng, prompts, arrival_rate=4 * RATE)
    assert ts.sequences_by_rid() == plain.sequences_by_rid()
    np.testing.assert_allclose(_by_rid(ts, ts.delays), _by_rid(js, js.delays), rtol=1e-9)
    for rid in ts.rids:
        assert tracer.check_tree(rid) == []
    dec = decompose(tracer, ts)
    assert dec["reconciles"] and dec["num_with_lost_time"] > 0
    assert {i["kind"] for i in tracer.instants} >= {"failure", "resubmit", "retire"}
    sums = np.zeros(teng.topo.num_nodes)
    np.add.at(sums, teng.topo.edge_src, teng.p)
    np.testing.assert_allclose(sums[np.unique(teng.topo.edge_src)], 1.0, atol=1e-6)


def test_failure_scenario_refused_under_cached_decode(engines, prompts):
    _, teng = engines
    scn = tctl.get_scenario("failure", teng.topo, p=teng.p, horizon=1.0)
    with pytest.raises(ValueError, match="stateless single-shot"):
        _serve(teng, prompts, gen_len=3, decode_mode="cached", scenario=scn)


def test_burst_scenario_modulates_arrivals_as_in_jax(engines, prompts):
    jeng, teng = engines
    scn = {ctl: ctl.arrival_burst(eng.topo, 0.02, 0.1, factor=4.0, ed_share=0.5, seed=0)
           for ctl, eng in zip((jctl, tctl), engines)}
    assert scn[tctl].modulates_arrivals and scn[tctl].modulates_eds
    assert scn[tctl].arrival_factor(0.01) == 1.0 < scn[tctl].arrival_factor(0.05)
    js = _serve(jeng, prompts, scenario=scn[jctl])
    ts = _serve(teng, prompts, scenario=scn[tctl])
    plain = _serve(teng, prompts)
    assert len(ts.delays) == len(prompts)
    assert _by_rid(ts, ts.arrivals) == _by_rid(js, js.arrivals)
    assert _by_rid(ts, ts.arrivals) != _by_rid(plain, plain.arrivals)
    assert ts.sequences_by_rid() == plain.sequences_by_rid()


def test_telemetry_unchanged_by_stream_cohabitation(engines, prompts):
    """A tracer and a metrics collector on the telemetry's stream change no
    estimate and no result of the serve."""
    _, teng = engines
    span = len(prompts) / RATE
    runs = []
    for observers in ({}, {"tracer": SpanTracer(), "metrics": MetricsCollector()}):
        tele = tctl.Telemetry(teng.topo, tctl.TelemetryConfig(window_s=span))
        runs.append((_serve(teng, prompts, telemetry=tele, **observers), tele))
    (ref, tele_ref), (stats, tele) = runs
    assert stats.sequences_by_rid() == ref.sequences_by_rid() and stats.delays == ref.delays
    now = 2 * span
    for field in ("mu", "phi_ext", "edge_rate"):
        np.testing.assert_array_equal(getattr(tele.effective_topology(teng.topo, now), field),
                                      getattr(tele_ref.effective_topology(teng.topo, now), field))
    np.testing.assert_array_equal(tele.queue_depths(), tele_ref.queue_depths())
