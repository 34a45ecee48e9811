"""The port's serving slice: the whole engine against the JAX engine, and
the port's own serving invariants (as ``tests/test_decode_serving.py``
asserts them for the JAX package).

The slice comparison builds both engines from the same seeds and bridged
weights, copies the JAX engine's strategy ``p`` and thresholds into the
port (so control-plane float drift cannot move routing), and serves the
same prompts.  Exact equality of every sequence and exit stage is
expected, and of the simulated delays at rtol 1e-9.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import exit_confidence as texit
from repro_torch.kernels import flash_attention as tflash
from repro_torch.serving import monolithic_generate

from torch_port_common import engine_pair

GEN = 6
THRESHOLD = 0.1  # the mid-range threshold of tests/test_decode_serving.py


@pytest.fixture(scope="module")
def engines():
    return engine_pair(THRESHOLD)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 128, size=n).astype(np.int32) for n in (12, 8, 12, 8, 12, 8, 12, 8)]


@pytest.fixture(scope="module")
def reference(engines, prompts):
    """The port's monolithic single-host generation, per request."""
    _, teng = engines
    return {
        i: (stage, tuple(toks))
        for i, p in enumerate(prompts)
        for toks, stage in [
            monolithic_generate(teng.programs.params, teng.cfg, p, teng.thresholds, GEN)
        ]
    }


def _serve(engine, prompts, seed=7, **kw):
    engine.rng = np.random.default_rng(seed)
    kw.setdefault("arrival_rate", 1e5)
    kw.setdefault("batch_size", 4)
    return engine.serve(prompts, gen_len=GEN, **kw)


# ---------------------------------------------------------------------------
# the slice vs the JAX engine
# ---------------------------------------------------------------------------


def test_serve_matches_jax_engine(engines, prompts):
    _assert_serves_match(*engines, prompts)


def test_serve_matches_jax_engine_glm4(prompts):
    """Reduced glm4-9b: GQA with 2 query heads per KV head, RMSNorm."""
    _assert_serves_match(*engine_pair(THRESHOLD, "glm4-9b"), prompts)


def _assert_serves_match(jeng, teng, prompts):
    np.testing.assert_array_equal(teng.p, jeng.p)
    want = _serve(jeng, prompts, decode_mode="cached")
    got = _serve(teng, prompts, decode_mode="cached")
    assert got.sequences_by_rid() == want.sequences_by_rid()
    order = np.argsort(want.rids)
    np.testing.assert_allclose(
        np.asarray(got.delays)[np.argsort(got.rids)], np.asarray(want.delays)[order], rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(got.confidences)[np.argsort(got.rids)],
        np.asarray(want.confidences)[order], atol=1e-2,
    )
    s, w = got.summary(), want.summary()
    for key in ("num_batches", "num_forward_rows", "num_real_rows", "generated_tokens",
                "exit_histogram", "peak_in_flight"):
        assert s[key] == w[key], key
    assert s["capacity_estimates"] == pytest.approx(w["capacity_estimates"], rel=1e-9)


# ---------------------------------------------------------------------------
# the port's own invariants: cached == stateless == monolithic
# ---------------------------------------------------------------------------


def test_reference_mixes_early_and_late_exits(reference):
    lens = sorted(len(toks) for _, toks in reference.values())
    assert lens[0] == 1 and lens[-1] == GEN
    assert any(1 < n < GEN for n in lens)


@pytest.mark.parametrize("mode", ["cached", "stateless"])
def test_decode_modes_match_monolithic(engines, prompts, reference, mode):
    _, teng = engines
    stats = _serve(teng, prompts, decode_mode=mode)
    assert stats.sequences_by_rid() == reference
    assert len(stats.delays) == len(prompts) and all(np.isfinite(stats.delays))


def test_continuous_batching_admission_mid_decode(engines, prompts, reference):
    """Slow arrivals: later prompts join replicas whose slot rings already
    hold mid-decode residents; outputs must not change."""
    _, teng = engines
    stats = _serve(teng, prompts, seed=11, arrival_rate=50.0, num_slots=3)
    assert stats.sequences_by_rid() == reference


def test_early_exit_retires_slots_under_pressure(engines, prompts, reference):
    """A 2-slot ring forces admission to wait on retirements."""
    _, teng = engines
    stats = _serve(teng, prompts, num_slots=2)
    assert stats.sequences_by_rid() == reference
    assert stats.summary()["peak_in_flight"] <= 2 * len(prompts)


@pytest.mark.parametrize("kw", [{"batch_size": 1}, {"batch_policy": "threshold"}])
def test_batching_choices_keep_tokens(engines, prompts, reference, kw):
    _, teng = engines
    assert _serve(teng, prompts, seed=9, **kw).sequences_by_rid() == reference


def test_classification_default_is_single_shot(engines, prompts, reference):
    _, teng = engines
    teng.rng = np.random.default_rng(7)
    stats = teng.serve(prompts, arrival_rate=1e5, batch_size=4)
    for rid, (_, toks) in reference.items():
        assert stats.sequences_by_rid()[rid][1] == toks[:1]


def test_cpu_serve_launches_no_kernel(engines, prompts):
    _, teng = engines
    def counts():
        return (texit.exit_confidence.launches, tdec.decode_attention.launches,
                tflash.flash_attention.launches)

    before = counts()
    _serve(teng, prompts, decode_mode="cached")
    assert counts() == before


def test_select_exit_matches_jax():
    import jax.numpy as jnp

    from repro.serving import select_exit as jselect
    from repro_torch.serving import select_exit as tselect

    rng = np.random.default_rng(3)
    conf = rng.uniform(0, 1, (16, 2)).astype(np.float32)
    etok = rng.integers(0, 128, (16, 2)).astype(np.int32)
    final = rng.integers(0, 128, 16).astype(np.int32)
    thr = np.array([0.6, 0.4], np.float32)
    jt, js = jselect(jnp.asarray(final), jnp.asarray(conf), jnp.asarray(etok), jnp.asarray(thr))
    tt, ts = tselect(torch.from_numpy(final), torch.from_numpy(conf), torch.from_numpy(etok),
                     torch.from_numpy(thr))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _observer(kw: str, teng):
    """A real object for each observer / control keyword of ``serve``: the
    controller installs zero-round phases (p and thresholds unchanged) and
    the scenario throttles a replica's physical capacity, so none of them
    can move routing or the exit decisions."""
    from repro_torch.control import (ControllerConfig, ReconfigController, Telemetry,
                                     TelemetryConfig, node_slowdown)
    from repro_torch.obs import MetricsCollector, SpanTracer

    if kw == "scenario":
        return node_slowdown(teng.topo, 0.0, 1e9, factor=0.2, p=teng.p)
    if kw == "controller":
        return ReconfigController(
            Telemetry(teng.topo, TelemetryConfig(window_s=1e-3)),
            ControllerConfig(interval=1e-3, rounds=0, drift_deadband=-1.0, p_deadband=-1.0),
        )
    if kw == "telemetry":
        return Telemetry(teng.topo)
    return {"tracer": SpanTracer, "metrics": MetricsCollector}[kw]()


@pytest.mark.parametrize("kw", ["scenario", "controller", "telemetry", "tracer", "metrics"])
def test_observer_and_control_options_keep_tokens(engines, prompts, reference, kw):
    """Each observer / control option serves every request with the plain
    serve's tokens and exits; all but the scenario (which slows a replica's
    simulated service) also keep its simulated delays bit for bit."""
    _, teng = engines
    plain = _serve(teng, prompts, decode_mode="cached")
    obj = _observer(kw, teng)
    stats = _serve(teng, prompts, decode_mode="cached", **{kw: obj})
    assert stats.sequences_by_rid() == plain.sequences_by_rid() == reference
    if kw != "scenario":
        assert stats.delays == plain.delays
    if kw == "controller":
        assert stats.num_reconfigs > 0  # the install path ran
    if kw in ("tracer", "metrics"):
        assert getattr(stats, "trace" if kw == "tracer" else "metrics") is obj


def test_cuda_without_a_card_raises(engines, monkeypatch):
    from repro_torch.serving.engine import StagePrograms

    _, teng = engines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StagePrograms(teng.programs.params, teng.cfg)


def test_launch_serve_on_cpu(capsys, tmp_path):
    import json
    import re

    from repro_torch.launch.serve import main
    from repro_torch.obs import validate_chrome_trace

    trace, report = tmp_path / "trace.json", tmp_path / "report.json"
    main(["--device", "cpu", "--slots", "2", "--requests-per-slot", "4", "--gen-len", "3",
          "--batch-size", "2", "--trace-out", str(trace), "--stats-report", str(report)])
    out = capsys.readouterr().out
    assert out.count("slot ") == 2 and out.rstrip().endswith("done")
    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    rep = json.loads(report.read_text())
    assert rep["decomposition"]["reconciles"] and rep["decomposition"]["num_requests"] == 4
    assert rep["metrics"]["metrics"]["delay_s"]["n"] == 4
    main(["--device", "cpu", "--slots", "2", "--slot-seconds", "1", "--requests-per-slot", "4",
          "--num-eds", "4", "--scenario", "slowdown", "--reconfig-interval", "0.25",
          "--batch-policy", "threshold"])
    out = capsys.readouterr().out
    done, reconfigs = map(int, re.search(r"online: (\d+) done .* reconfigs (\d+)", out).groups())
    assert done > 0 and reconfigs >= 1 and out.rstrip().endswith("done")
