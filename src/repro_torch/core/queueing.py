"""M/D/1-PS queueing model of the staged edge network (paper §2.3-§2.4).

The counterpart of ``repro.core.queueing``: the same functions over float32
torch tensors on the CPU (``jax.ops.segment_sum`` becomes ``index_add_``).
The topology's integer arrays stay numpy.  Node-indexed remaining ratios
``I_node[v]`` carry the per-stage remaining ratio I_h of v's stage (EDs: 1.0).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import ModelProfile, Topology

# A delay stand-in for an unstable queue (lambda >= mu), finite so that
# gradients stay defined; the exterior penalty steers the optimizer out.
UNSTABLE_DELAY = 1e6

F32 = torch.float32


def t32(a) -> torch.Tensor:
    """A float32 CPU tensor of ``a``."""
    return torch.as_tensor(np.asarray(a, np.float32))


def segment_sum(data: torch.Tensor, segment_ids: np.ndarray, num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=data.dtype)
    return out.index_add_(0, torch.as_tensor(segment_ids, dtype=torch.int64), data)


def finite_mu(topo: Topology) -> torch.Tensor:
    """ES capacities with the EDs' infinite ones replaced by 1e30."""
    return t32(np.where(np.isinf(topo.mu), 1e30, topo.mu))


def node_remaining_ratio(topo: Topology, stage_remaining: torch.Tensor) -> torch.Tensor:
    """Broadcast per-stage remaining ratios I_h (length H+1, entry 0 == 1.0
    for EDs) to nodes."""
    return stage_remaining[torch.as_tensor(topo.node_stage, dtype=torch.int64)]


def alpha_per_node(topo: Topology, profile: ModelProfile) -> np.ndarray:
    """alpha_h of each node's sub-model (EDs: 0 — they do not compute)."""
    alpha = np.concatenate([[0.0], np.asarray(profile.alpha, np.float64)])
    return alpha[topo.node_stage]


def beta_per_edge(topo: Topology, profile: ModelProfile) -> np.ndarray:
    """beta of the data shipped over each edge == input size of the dst stage."""
    beta = np.concatenate([[0.0], np.asarray(profile.beta, np.float64)])
    return beta[topo.node_stage[topo.edge_dst]]


def steady_state_flows(
    p: torch.Tensor, topo: Topology, profile: ModelProfile, I_node: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact steady-state (phi, lam) via stage-by-stage propagation (Eqs. 3, 5)."""
    alpha_n = t32(alpha_per_node(topo, profile))
    phi = t32(topo.phi_ext)
    src, dst = topo.edge_src, topo.edge_dst
    src_stage = topo.node_stage[src]
    for h in range(0, topo.num_stages):  # propagate across the h -> h+1 boundary
        sel = t32((src_stage == h).astype(np.float32))
        contrib = p * phi[src] * I_node[src] * sel
        inflow = segment_sum(contrib, dst, topo.num_nodes)
        phi = torch.where(torch.as_tensor(topo.node_stage == h + 1), inflow, phi)
    return phi, phi * alpha_n


def one_round_flows(
    p: torch.Tensor, phi_prev: torch.Tensor, topo: Topology, profile: ModelProfile,
    I_node: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One synchronous RUR sweep: receivers recompute (phi, lam) from the
    offloaders' previous-round arrival estimates (Alg. 1 lines 1-4)."""
    alpha_n = t32(alpha_per_node(topo, profile))
    src, dst = topo.edge_src, topo.edge_dst
    contrib = p * phi_prev[src] * I_node[src]
    inflow = segment_sum(contrib, dst, topo.num_nodes)
    phi = torch.where(torch.as_tensor(topo.node_stage > 0), inflow, t32(topo.phi_ext))
    return phi, phi * alpha_n


def compute_delay_per_node(topo: Topology, profile: ModelProfile, lam: torch.Tensor) -> torch.Tensor:
    """M/D/1-PS sojourn time per subtask on each ES (Eq. 6): alpha/(mu-lam)."""
    alpha_n = t32(alpha_per_node(topo, profile))
    gap = finite_mu(topo) - lam
    stable = gap > 0
    delay = torch.where(stable, alpha_n / torch.where(stable, gap, 1.0), UNSTABLE_DELAY)
    return torch.where(torch.as_tensor(topo.node_stage > 0), delay, 0.0)


def transmission_delay_per_edge(topo: Topology, profile: ModelProfile) -> np.ndarray:
    """T^cm per edge (Eq. 4): beta_{h+1} / r_{i,j}.  Static given the topology."""
    return beta_per_edge(topo, profile) / topo.edge_rate


def average_response_delay(
    p: torch.Tensor, topo: Topology, profile: ModelProfile, I_node: torch.Tensor,
    phi: torch.Tensor, lam: torch.Tensor,
) -> torch.Tensor:
    """System mean response delay T (Eq. 8)."""
    gap = finite_mu(topo) - lam
    stable = gap > 0
    queue_term = torch.where(stable, lam / torch.where(stable, gap, 1.0), lam * UNSTABLE_DELAY)
    queue_term = torch.where(torch.as_tensor(topo.node_stage > 0), queue_term, 0.0)
    t_cm = t32(transmission_delay_per_edge(topo, profile))
    phi_edge = p * phi[topo.edge_src] * I_node[topo.edge_src]
    total_phi = t32(topo.phi_ext.sum())
    return (torch.sum(queue_term) + torch.sum(phi_edge * t_cm)) / total_phi


def is_stable(topo: Topology, lam: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """True iff every ES satisfies lam < mu - eps (P1's first constraint)."""
    ok = lam < finite_mu(topo) - eps
    return torch.all(torch.where(torch.as_tensor(topo.node_stage > 0), ok, True))


def system_utilization(topo: Topology, lam: torch.Tensor) -> torch.Tensor:
    """max_j lam_j / mu_j over ESs — headline congestion metric."""
    rho = lam / finite_mu(topo)
    return torch.max(torch.where(torch.as_tensor(topo.node_stage > 0), rho, 0.0))
