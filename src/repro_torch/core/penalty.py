"""Exterior-point penalty (paper Eq. 11) and the penalized objective R(P);
the counterpart of ``repro.core.penalty`` over float32 torch tensors."""
from __future__ import annotations

import torch

from repro_torch.core import queueing
from repro_torch.core.types import DtoHyperParams, ModelProfile, Topology


def penalty(topo: Topology, lam: torch.Tensor, k: float, eps: float) -> torch.Tensor:
    """N(P) = K * sum_j max(0, lam_j - mu_j + eps)^2  over ESs (Eq. 11)."""
    viol = torch.clamp(lam - queueing.finite_mu(topo) + eps, min=0.0)
    viol = torch.where(torch.as_tensor(topo.node_stage > 0), viol, 0.0)
    return k * torch.sum(viol**2)


def objective_r(
    p: torch.Tensor, topo: Topology, profile: ModelProfile, I_node: torch.Tensor,
    hyper: DtoHyperParams,
) -> torch.Tensor:
    """R(P) = T + N(P) at exact steady-state flows (problem P2)."""
    phi, lam = queueing.steady_state_flows(p, topo, profile, I_node)
    t = queueing.average_response_delay(p, topo, profile, I_node, phi, lam)
    return t + penalty(topo, lam, hyper.penalty_k, hyper.penalty_eps)
