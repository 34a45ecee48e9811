"""The port's DTO-EE control plane (float32 torch on the CPU) vs the JAX
package's (jnp).  Tolerances: p at atol 1e-5 after a configuration phase,
thresholds equal; f32 queueing terms at rtol 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dto_ee as jdto
from repro.core import gradients as jgrad
from repro.core import penalty as jpen
from repro.core import queueing as jq
from repro.core.profiles import profile_from_arch as jprofile
from repro.core.simulator import RoutingCdf as JRoutingCdf
from repro.core.thresholds import synthetic_validation as jvalidation
from repro.core.topology import NetworkSpec as JSpec
from repro.core.topology import build_edge_network as jnetwork
from repro.core.types import DtoHyperParams as JHyper
from repro_torch.core import dto_ee as tdto
from repro_torch.core import gradients as tgrad
from repro_torch.core import penalty as tpen
from repro_torch.core import queueing as tq
from repro_torch.core.profiles import profile_from_arch as tprofile
from repro_torch.core.simulator import RoutingCdf as TRoutingCdf
from repro_torch.core.thresholds import synthetic_validation as tvalidation
from repro_torch.core.topology import NetworkSpec as TSpec
from repro_torch.core.topology import build_edge_network as tnetwork
from repro_torch.core.types import DtoHyperParams as THyper

from torch_port_common import configs


@pytest.fixture(scope="module")
def setups():
    """The serving tests' topology and exit profile, built by each package
    (tests/test_decode_serving.py: stablelm reduced, 4 EDs, 2 ESs a stage)."""
    jcfg, tcfg = configs()
    jp, tp = jprofile(jcfg), tprofile(tcfg)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    jt = jnetwork(seed=0, profile=jp, spec=JSpec(num_eds=4, es_per_stage=(2, 2)))
    tt = tnetwork(seed=0, profile=tp, spec=TSpec(num_eds=4, es_per_stage=(2, 2)))
    for f in ("node_stage", "mu", "phi_ext", "edge_src", "edge_dst", "edge_rate", "edge_offsets"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    je, te = jvalidation(seed=1, profile=jp), tvalidation(seed=1, profile=tp)
    np.testing.assert_array_equal(te.conf, je.conf)
    return (jt, jp, je), (tt, tp, te)


def test_configuration_phase_matches(setups):
    (jt, jp, je), (tt, tp, te) = setups
    jstate = jdto.run_configuration_phase(jt, jp, je, JHyper(rounds=20)).state
    tstate = tdto.run_configuration_phase(tt, tp, te, THyper(rounds=20)).state
    np.testing.assert_allclose(tstate.carry.p.numpy(), np.asarray(jstate.carry.p), atol=1e-5)
    np.testing.assert_array_equal(tstate.thresholds, jstate.thresholds)
    np.testing.assert_array_equal(tstate.stage_remaining, jstate.stage_remaining)
    np.testing.assert_allclose(tstate.carry.phi.numpy(), np.asarray(jstate.carry.phi), rtol=1e-5)


def test_solve_matches(setups):
    (jt, jp, je), (tt, tp, te) = setups
    jres = jdto.solve(jt, jp, je, JHyper(rounds=10), max_phases=3)
    tres = tdto.solve(tt, tp, te, THyper(rounds=10), max_phases=3)
    np.testing.assert_allclose(tres.state.carry.p.numpy(), np.asarray(jres.state.carry.p), atol=1e-5)
    np.testing.assert_array_equal(tres.state.thresholds, jres.state.thresholds)
    np.testing.assert_allclose(tres.delay_history, jres.delay_history, rtol=1e-5)


def test_queueing_penalty_and_gradients_match(setups):
    (jt, jp, je), (tt, tp, te) = setups
    rng = np.random.default_rng(0)
    # a non-uniform valid strategy: one Eq. 19 move off uniform
    delta = jnp.asarray(rng.uniform(0.0, 1.0, jt.num_edges), jnp.float32)
    p = np.array(jdto.eq19_update(jdto.uniform_strategy(jt), delta, jt, 0.3))
    I = np.ones(jt.num_stages + 1, np.float32)
    I[2] = 0.7
    jI = jq.node_remaining_ratio(jt, jnp.asarray(I))
    tI = tq.node_remaining_ratio(tt, torch.from_numpy(I))
    hyper_j, hyper_t = JHyper(), THyper()
    jphi, jlam = jq.steady_state_flows(jnp.asarray(p), jt, jp, jI)
    tphi, tlam = tq.steady_state_flows(torch.from_numpy(p), tt, tp, tI)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=1e-5)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-5)
    np.testing.assert_allclose(
        float(tq.average_response_delay(torch.from_numpy(p), tt, tp, tI, tphi, tlam)),
        float(jq.average_response_delay(jnp.asarray(p), jt, jp, jI, jphi, jlam)), rtol=1e-5)
    np.testing.assert_allclose(
        tq.compute_delay_per_node(tt, tp, tlam).numpy(),
        np.asarray(jq.compute_delay_per_node(jt, jp, jlam)), rtol=1e-5)
    assert bool(tq.is_stable(tt, tlam)) == bool(jq.is_stable(jt, jlam))
    np.testing.assert_allclose(
        float(tpen.objective_r(torch.from_numpy(p), tt, tp, tI, hyper_t)),
        float(jpen.objective_r(jnp.asarray(p), jt, jp, jI, hyper_j)), rtol=1e-5)
    np.testing.assert_allclose(
        tgrad.analytic_gradient(torch.from_numpy(p), tt, tp, tI, hyper_t).numpy(),
        np.asarray(jgrad.analytic_gradient(jnp.asarray(p), jt, jp, jI, hyper_j)), rtol=1e-4)


def test_lemma1_analytic_gradient_matches_autograd(setups):
    """Paper Eq. 22 against torch.autograd of R(P), as the reference holds
    it against jax.grad."""
    _, (tt, tp, te) = setups
    p = tdto.uniform_strategy(tt)
    I = torch.ones(tt.num_stages + 1)
    I[3] = 0.6
    tI = tq.node_remaining_ratio(tt, I)
    hyper = THyper()
    p_req = p.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(tpen.objective_r(p_req, tt, tp, tI, hyper), p_req)
    analytic = tgrad.analytic_gradient(p, tt, tp, tI, hyper)
    np.testing.assert_allclose(analytic.numpy(), auto.numpy(), rtol=1e-3, atol=1e-6)


def test_eq19_update_and_tie_break_match(setups):
    (jt, _, _), (tt, _, _) = setups
    rng = np.random.default_rng(1)
    p = np.array(jdto.uniform_strategy(jt))
    delta = rng.integers(0, 3, jt.num_edges).astype(np.float32)  # many ties
    want = jdto.eq19_update(jnp.asarray(p), jnp.asarray(delta), jt, 0.15)
    got = tdto.eq19_update(torch.from_numpy(p), torch.from_numpy(delta), tt, 0.15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_routing_cdf_samples_match(setups):
    (jt, _, _), (tt, _, _) = setups
    p = np.asarray(jdto.uniform_strategy(jt), np.float64)
    jr, tr = JRoutingCdf(jt, p), TRoutingCdf(tt, p)
    g1, g2 = np.random.default_rng(5), np.random.default_rng(5)
    for node in list(range(jt.num_nodes - 2)) * 3:
        assert jr.sample(g1, node) == tr.sample(g2, node)
