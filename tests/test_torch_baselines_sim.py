"""The port's discrete-event simulator, baselines and utility against the JAX
package's.

The simulator is numpy on the host in both packages: the same topology,
strategy, thresholds and seed must give the same result exactly (every
field of ``SimResult``, and the same span trees through a tracer).  The
baselines are host-side searches whose strategies are float32 arrays in
both: held at f32 atol 2e-5 (and paths, sweep counts and thresholds
exactly).  The paper's claims of ``tests/test_system.py`` are then asserted
with the port alone.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import dto_ee as jdto
from repro.core import simulator as jsim
from repro.core.thresholds import synthetic_validation as jvalidation
from repro.core.topology import build_edge_network as jnetwork
from repro.core.types import RESNET101_PROFILE as JRESNET
from repro.core.types import DtoHyperParams as JHyper
from repro.core.utility import utility as jutility
from repro.obs.trace import SpanTracer as JTracer
from repro_torch.core import baselines as tbase
from repro_torch.core import dto_ee as tdto
from repro_torch.core import simulator as tsim
from repro_torch.core.thresholds import synthetic_validation as tvalidation
from repro_torch.core.topology import build_edge_network as tnetwork
from repro_torch.core.topology import build_uniform_network as tuniform
from repro_torch.core.types import RESNET101_PROFILE as TRESNET
from repro_torch.core.types import DtoHyperParams as THyper
from repro_torch.core.utility import utility as tutility
from repro_torch.obs.trace import SpanTracer as TTracer

import torch_port_common  # noqa: F401  (one CPU thread for the port's ops)

F32_ATOL = 2e-5


@pytest.fixture(scope="module")
def setups():
    """Paper Figs 3-4's regime (ResNet-101 profile, arrival rates x3), built
    by each package, with DTO-EE's converged strategy and thresholds from
    the JAX package's solve."""
    assert dataclasses.asdict(JRESNET) == dataclasses.asdict(TRESNET)
    jt = jnetwork(seed=0, profile=JRESNET, arrival_rate_scale=3.0)
    tt = tnetwork(seed=0, profile=TRESNET, arrival_rate_scale=3.0)
    for f in ("node_stage", "mu", "phi_ext", "edge_src", "edge_dst", "edge_rate"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    je, te = jvalidation(seed=1, profile=JRESNET), tvalidation(seed=1, profile=TRESNET)
    res = jdto.solve(jt, JRESNET, je, JHyper())
    p, thr = np.asarray(res.state.carry.p), res.state.thresholds
    return (jt, je), (tt, te), p, thr


def _assert_same_result(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("seed", [0, 42])
def test_simulate_slot_matches_exactly(setups, seed, coalesce):
    (jt, je), (tt, te), p, thr = setups
    want = jsim.simulate_slot(jt, JRESNET, je, p, thr, duration=3.0, seed=seed, coalesce=coalesce)
    got = tsim.simulate_slot(tt, TRESNET, te, p, thr, duration=3.0, seed=seed, coalesce=coalesce)
    _assert_same_result(got, want)
    assert got.completed == got.generated > 100


def test_simulate_slot_strategy_switch_and_tracer_match(setups):
    """A strategy switch mid-slot (a slow decision charged to the old p)
    and the tracer hook: the same result and the same span trees."""
    (jt, je), (tt, te), p, thr = setups
    p_old = np.asarray(jbase.computing_first(jt), np.float64)
    jtr, ttr = JTracer(), TTracer()
    want = jsim.simulate_slot(jt, JRESNET, je, p, thr, duration=2.0, seed=3,
                              strategy_switch=(0.7, p_old), tracer=jtr)
    got = tsim.simulate_slot(tt, TRESNET, te, torch.from_numpy(p.copy()), thr, duration=2.0, seed=3,
                             strategy_switch=(0.7, p_old), tracer=ttr)
    _assert_same_result(got, want)
    jspans, tspans = jtr.spans, ttr.spans
    assert sorted(tspans) == sorted(jspans) and len(jspans) == want.generated
    for rid, js in jspans.items():
        assert [dataclasses.astuple(s) for s in tspans[rid]] == [dataclasses.astuple(s) for s in js]
        assert ttr.check_tree(rid) == jtr.check_tree(rid)


def test_cf_bf_and_paths_to_strategy_match(setups):
    (jt, _), (tt, _), _, _ = setups
    for jfn, tfn in ((jbase.computing_first, tbase.computing_first),
                     (jbase.bandwidth_first, tbase.bandwidth_first)):
        got, want = tfn(tt), jfn(jt)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    remaining = np.array([1.0, 0.9, 0.7, 0.5, 0.4, 0.3])[: jt.num_stages + 1]
    rng = np.random.default_rng(0)
    paths = {}
    for ed in jt.nodes_at_stage(0):
        path, cur = [], int(ed)
        for _ in range(jt.num_stages):
            cur = int(rng.choice(jt.successors(cur)))
            path.append(cur)
        paths[int(ed)] = tuple(path)
    np.testing.assert_allclose(tbase.paths_to_strategy(tt, TRESNET, remaining, paths).numpy(),
                               np.asarray(jbase.paths_to_strategy(jt, JRESNET, remaining, paths)),
                               atol=F32_ATOL)


def test_ngto_and_ga_match(setups):
    (jt, je), (tt, te), _, thr = setups
    remaining = je.evaluate(thr).stage_remaining
    np.testing.assert_array_equal(te.evaluate(thr).stage_remaining, remaining)
    jp, jsweeps = jbase.ngto(jt, JRESNET, remaining, max_sweeps=6)
    tp, tsweeps = tbase.ngto(tt, TRESNET, remaining, max_sweeps=6)
    assert tsweeps == jsweeps
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=F32_ATOL)
    lam = np.random.default_rng(1).uniform(0, 20, jt.num_nodes)
    jga = jbase.genetic_paths(jt, JRESNET, remaining, lam_snapshot=lam, seed=4, generations=5)
    tga = tbase.genetic_paths(tt, TRESNET, remaining, lam_snapshot=lam, seed=4, generations=5)
    assert isinstance(tga, tbase.GaResult)
    assert tga.paths == jga.paths and tga.generations == jga.generations
    np.testing.assert_allclose(tga.p.numpy(), np.asarray(jga.p), atol=F32_ATOL)


def test_adapt_thresholds_for_strategy_matches(setups):
    (jt, je), (tt, te), _, _ = setups
    jp, tp = jbase.bandwidth_first(jt), tbase.bandwidth_first(tt)
    jthr, jrem, jacc = jbase.adapt_thresholds_for_strategy(jt, JRESNET, je, jp, JHyper())
    tthr, trem, tacc = tbase.adapt_thresholds_for_strategy(tt, TRESNET, te, tp, THyper())
    np.testing.assert_array_equal(tthr, jthr)
    np.testing.assert_array_equal(trem, jrem)
    assert tacc == jacc


def test_utility_matches():
    for args in ((0.3, 0.5, 0.8), (1.7, 0.0, 0.2), (0.0, 1.0, 1.0)):
        assert tutility(*args) == jutility(*args)


def test_paper_claim_dto_ee_beats_baselines_static():
    """The port's analogue of ``tests/test_system.py``: DTO-EE's simulated
    delay is at least 10% below CF's and BF's, each baseline with its
    thresholds adapted to its strategy, all in the port."""
    profile, hyper = TRESNET, THyper()
    topo = tnetwork(seed=0, profile=profile, arrival_rate_scale=3.0)
    ep = tvalidation(seed=1, profile=profile)
    res = tdto.solve(topo, profile, ep, hyper)
    dto = tsim.simulate_slot(topo, profile, ep, res.state.carry.p.numpy(), res.state.thresholds,
                             seed=42)
    for p_b in (tbase.computing_first(topo), tbase.bandwidth_first(topo)):
        thr_b, _, _ = tbase.adapt_thresholds_for_strategy(topo, profile, ep, p_b, hyper)
        sim_b = tsim.simulate_slot(topo, profile, ep, p_b.numpy(), thr_b, seed=42)
        assert dto.mean_delay < sim_b.mean_delay * 0.9


def test_paper_claim_threshold_ablation_direction():
    """The port's analogue of ``tests/test_system.py``'s ablation: DTO-EE
    against thresholds fixed at 1.0, >=15% lower delay within 5 accuracy
    points and a better utility U (Eq. 9)."""
    profile, hyper = TRESNET, THyper()
    ep = tvalidation(seed=1, profile=profile)
    topo = tuniform(seed=0, profile=profile, ed_arrival_rate=2.2)
    res = tdto.solve(topo, profile, ep, hyper)
    dto = tsim.simulate_slot(topo, profile, ep, res.state.carry.p.numpy(), res.state.thresholds,
                             seed=5)
    res10 = tdto.solve(topo, profile, ep, hyper, adapt_thresholds=False)
    base = tsim.simulate_slot(topo, profile, ep, res10.state.carry.p.numpy(),
                              np.ones(ep.num_early_branches), seed=5)
    assert dto.mean_delay < base.mean_delay * 0.85
    assert dto.accuracy > base.accuracy - 0.05
    a = hyper.utility_a
    assert (tutility(dto.mean_delay, ep.normalized_accuracy(dto.accuracy), a)
            < tutility(base.mean_delay, ep.normalized_accuracy(base.accuracy), a))
