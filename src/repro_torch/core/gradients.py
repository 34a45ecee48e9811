"""Repulsive factors Delta (Eq. 15) and gradient info Omega (Eqs. 14, 16);
the counterpart of ``repro.core.gradients`` over float32 torch tensors.

  * ``delta_edges`` — per-edge Delta given the receivers' (lam, Omega), i.e.
    exactly what a DTO-O offloader computes from received RUS messages.
  * ``backward_recursion`` — the centralized oracle that runs the recursion
    to a fixed point over stages; ``analytic_gradient`` (paper Eq. 22) is
    held against ``torch.autograd`` of ``penalty.objective_r`` in the tests
    (Lemma 1), as the reference holds it against ``jax.grad``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.core.queueing import segment_sum, t32
from repro_torch.core.types import DtoHyperParams, ModelProfile, Topology

_BIG = 1e8  # repulsive factor of an unstable receiver (on top of the penalty)


def delta_edges(
    p: torch.Tensor, topo: Topology, profile: ModelProfile, lam: torch.Tensor,
    omega: torch.Tensor, hyper: DtoHyperParams,
) -> torch.Tensor:
    """Delta_{i,j} per edge (Eq. 15) from receiver-side state (lam, omega).

    Delta_ij = mu_j a/(mu_j-lam_j)^2 + beta/r_ij + Omega_j
               + 2*K*Phi * max(0, a*(lam_j - mu_j + eps))
    """
    dst = topo.edge_dst
    alpha_n = t32(queueing.alpha_per_node(topo, profile))
    beta_e = t32(queueing.beta_per_edge(topo, profile))
    mu = queueing.finite_mu(topo)
    total_phi = float(topo.phi_ext.sum())

    mu_d, lam_d, a_d = mu[dst], lam[dst], alpha_n[dst]
    gap = mu_d - lam_d
    stable = gap > 0
    congestion = torch.where(stable, mu_d * a_d / torch.where(stable, gap, 1.0) ** 2, _BIG)
    transmission = beta_e / t32(topo.edge_rate)
    pen = 2.0 * hyper.penalty_k * total_phi * torch.clamp(
        a_d * (lam_d - mu_d + hyper.penalty_eps), min=0.0
    )
    return congestion + transmission + omega[dst] + pen


def omega_from_delta(
    p: torch.Tensor, topo: Topology, I_node: torch.Tensor, delta: torch.Tensor
) -> torch.Tensor:
    """Omega_i = I_i * sum_{j in L_i} p_ij * Delta_ij (Eq. 16); 0 at stage H."""
    omega = segment_sum(p * delta, topo.edge_src, topo.num_nodes) * I_node
    is_last = torch.as_tensor(topo.node_stage == topo.num_stages)
    return torch.where(is_last, 0.0, omega)


def backward_recursion(
    p: torch.Tensor, topo: Topology, profile: ModelProfile, I_node: torch.Tensor,
    lam: torch.Tensor, hyper: DtoHyperParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (Delta, Omega) by sweeping stages H-1 .. 0 (centralized oracle)."""
    src_stage = topo.node_stage[topo.edge_src]
    omega = torch.zeros(topo.num_nodes, dtype=torch.float32)
    delta = torch.zeros(topo.num_edges, dtype=torch.float32)
    for h in range(topo.num_stages - 1, -1, -1):
        d_all = delta_edges(p, topo, profile, lam, omega, hyper)
        sel = t32((src_stage == h).astype(np.float32))
        delta = delta + d_all * sel
        omega_h = omega_from_delta(p, topo, I_node, d_all * sel)
        omega = torch.where(torch.as_tensor(topo.node_stage == h), omega_h, omega)
    return delta, omega


def analytic_gradient(
    p: torch.Tensor, topo: Topology, profile: ModelProfile, I_node: torch.Tensor,
    hyper: DtoHyperParams,
) -> torch.Tensor:
    """dR/dp_ij = (phi_i * I_i / Phi) * Delta_ij (paper Eq. 22), at steady state."""
    phi, lam = queueing.steady_state_flows(p, topo, profile, I_node)
    delta, _ = backward_recursion(p, topo, profile, I_node, lam, hyper)
    total_phi = float(topo.phi_ext.sum())
    src = topo.edge_src
    return phi[src] * I_node[src] / total_phi * delta
