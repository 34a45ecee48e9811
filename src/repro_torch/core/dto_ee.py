"""DTO-EE: distributed joint optimization of task offloading and early-exit
confidence thresholds (paper Algorithms 1-3).

The counterpart of ``repro.core.dto_ee``.  The per-round message passing
(DTO-R + DTO-O) is vectorized over float32 torch tensors on the CPU
(``segment_min`` becomes ``scatter_reduce(..., "amin")``); the reference
jit-compiles it, here it runs eagerly.  The discrete threshold moves (Alg. 3
lines 5-8) are host-side table lookups.

Faithful distributed semantics: arrival estimates (phi) and gradient info
(Omega) each propagate ONE stage per communication round — receivers use the
offloaders' previous-round RURs, offloaders use the receivers' previous-round
Omega (stale by one round), exactly like the RUR/RUS exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

import torch

from repro_torch.core import gradients, penalty, queueing
from repro_torch.core.queueing import segment_sum, t32
from repro_torch.core.thresholds import ExitProfile, threshold_step
from repro_torch.core.types import DtoHyperParams, ModelProfile, Topology


class RoundCarry(NamedTuple):
    """Traced per-round state of the message passing."""

    p: torch.Tensor  # [E] offloading probabilities
    phi: torch.Tensor  # [N] arrival-rate estimates (tasks/s)
    lam: torch.Tensor  # [N] required compute (GFLOP/s)
    omega: torch.Tensor  # [N] gradient info from each node's last DTO-O run


@dataclasses.dataclass
class DtoState:
    """Full algorithm state across a configuration-update phase."""

    carry: RoundCarry
    thresholds: np.ndarray  # one per early-exit branch (discrete grid)
    stage_remaining: np.ndarray  # I_h for stages 0..H
    accuracy: float
    round: int = 0


@dataclasses.dataclass
class PhaseResult:
    state: DtoState
    delay_history: np.ndarray
    objective_history: np.ndarray
    accuracy_history: np.ndarray
    rounds_run: int


def clone_state(state: DtoState) -> DtoState:
    """Independent copy for speculative configuration phases (the online
    controller plans against measured topologies without touching the live
    state until the install point).  The carry's tensors are never written
    in place and are shared; the host-side numpy arrays are copied."""
    return DtoState(
        carry=state.carry,
        thresholds=state.thresholds.copy(),
        stage_remaining=state.stage_remaining.copy(),
        accuracy=state.accuracy,
        round=state.round,
    )


def uniform_strategy(topo: Topology) -> torch.Tensor:
    """p_{i,j}^0 = 1/|L_i| (Alg. 3 line 1)."""
    deg = np.maximum(topo.out_degree(), 1)
    return t32(1.0 / deg[topo.edge_src])


def _segment_min(data: torch.Tensor, segment_ids: np.ndarray, num_segments: int, empty):
    out = torch.full((num_segments,), empty, dtype=data.dtype)
    ids = torch.as_tensor(segment_ids, dtype=torch.int64)
    return out.scatter_reduce(0, ids, data, reduce="amin", include_self=True)


def eq19_update(
    p: torch.Tensor, delta: torch.Tensor, topo: Topology, tau_p: float | torch.Tensor
) -> torch.Tensor:
    """The Eq. 19 move: shift tau_p of off-minimum mass onto argmin-Delta.

    p_j   <- (1 - tau_p) p_j          for j != j*
    p_j*  <- p_j* + tau_p sum_{j!=j*} p_j  ==  p_j* + tau_p (1 - p_j*)
    """
    src = topo.edge_src
    n = topo.num_nodes
    e = topo.num_edges
    dmin = _segment_min(delta, src, n, float("inf"))
    at_min = delta <= dmin[src] + 0.0
    # first-occurrence tie-break for j*
    arange = torch.arange(e)
    idx = torch.where(at_min, arange, e)
    star_idx = _segment_min(idx, src, n, e)
    is_star = arange == star_idx[src]
    p_new = torch.where(is_star, p + tau_p * (1.0 - p), (1.0 - tau_p) * p)
    # float32 drift guard: renormalize per source
    tot = segment_sum(p_new, src, n)
    return p_new / torch.clamp(tot[src], min=1e-12)


def make_round_step(
    topo: Topology, profile: ModelProfile, hyper: DtoHyperParams
) -> Callable[[RoundCarry, torch.Tensor, torch.Tensor], tuple[RoundCarry, torch.Tensor]]:
    """Build the synchronous round: DTO-R (Alg. 1) then DTO-O (Alg. 2).

    Returns fn(carry, I_node, tau_p) -> (carry', delta).
    """

    def round_step(carry: RoundCarry, I_node: torch.Tensor, tau_p: torch.Tensor):
        # --- DTO-R: receivers process RURs -> (lam, phi), respond RUS ------
        phi_new, lam_new = queueing.one_round_flows(
            carry.p, carry.phi, topo, profile, I_node
        )
        # --- DTO-O: offloaders process RUSs (stale omega), update strategy -
        delta = gradients.delta_edges(
            carry.p, topo, profile, lam_new, carry.omega, hyper
        )
        omega_new = gradients.omega_from_delta(carry.p, topo, I_node, delta)
        p_new = eq19_update(carry.p, delta, topo, tau_p)
        return RoundCarry(p=p_new, phi=phi_new, lam=lam_new, omega=omega_new), delta

    return round_step


def evaluate_strategy(
    p: torch.Tensor,
    topo: Topology,
    profile: ModelProfile,
    I_node: torch.Tensor,
    hyper: DtoHyperParams,
) -> tuple[float, float, bool]:
    """(T, R, stable) at exact steady-state flows — the analytic scoreboard."""
    phi, lam = queueing.steady_state_flows(p, topo, profile, I_node)
    t = queueing.average_response_delay(p, topo, profile, I_node, phi, lam)
    n = penalty.penalty(topo, lam, hyper.penalty_k, hyper.penalty_eps)
    stable = queueing.is_stable(topo, lam)
    return float(t), float(t + n), bool(stable)


def init_state(
    topo: Topology,
    profile: ModelProfile,
    exit_profile: ExitProfile,
    initial_thresholds: np.ndarray | None = None,
    p0: torch.Tensor | None = None,
) -> DtoState:
    thresholds = (
        np.asarray(initial_thresholds, np.float64)
        if initial_thresholds is not None
        else np.full(exit_profile.num_early_branches, 0.8)
    )
    ev = exit_profile.evaluate(thresholds)
    p = p0 if p0 is not None else uniform_strategy(topo)
    n = topo.num_nodes
    carry = RoundCarry(
        p=p,
        phi=t32(topo.phi_ext),
        lam=torch.zeros(n, dtype=torch.float32),
        omega=torch.zeros(n, dtype=torch.float32),
    )
    return DtoState(
        carry=carry,
        thresholds=thresholds,
        stage_remaining=ev.stage_remaining,
        accuracy=ev.accuracy,
    )


def run_configuration_phase(
    topo: Topology,
    profile: ModelProfile,
    exit_profile: ExitProfile,
    hyper: DtoHyperParams,
    state: DtoState | None = None,
    adapt_thresholds: bool = True,
    round_step=None,
    tau_p: float | None = None,
) -> PhaseResult:
    """Algorithm 3: n rounds of concurrent DTO-R/DTO-O; every m rounds, the
    cyclically-selected stage's exit branch tries a +/- tau_c threshold move.

    ``tau_p`` overrides the hyper step size for this phase (solve() decays
    it across phases — Frank-Wolfe-style diminishing steps to converge past
    the O(tau_p) oscillation band of the fixed-step Eq. 19 dynamics)."""
    H = profile.num_stages
    state = state or init_state(topo, profile, exit_profile)
    round_step = round_step or make_round_step(topo, profile, hyper)
    tau_now = t32(hyper.tau_p if tau_p is None else tau_p)

    # branch lookup: stage -> early-branch index
    stage_to_branch = {s: b for b, s in enumerate(exit_profile.branch_stage[:-1])}
    total_phi = float(topo.phi_ext.sum())

    delays, objectives, accuracies = [], [], []
    carry = state.carry
    thresholds = state.thresholds.copy()
    stage_remaining = state.stage_remaining.copy()
    accuracy = state.accuracy

    for t in range(hyper.rounds):
        I_node = t32(stage_remaining)[torch.as_tensor(topo.node_stage, dtype=torch.int64)]
        carry, _delta = round_step(carry, I_node, tau_now)

        # ---- Alg. 3 lines 4-8: cyclic threshold adjustment ----------------
        if adapt_thresholds and t % hyper.threshold_every == 0:
            h = (t // hyper.threshold_every) % H + 1  # 1-indexed stage
            if h in stage_to_branch:
                b = stage_to_branch[h]
                nodes = topo.nodes_at_stage(h)
                phi_np = carry.phi.numpy()[nodes]
                omega_np = carry.omega.numpy()[nodes]
                decision = threshold_step(
                    exit_profile,
                    thresholds,
                    b,
                    phi_np,
                    omega_np,
                    total_phi,
                    hyper,
                )
                if decision.changed:
                    thresholds = decision.thresholds
                    stage_remaining = decision.stage_remaining
                    accuracy = decision.accuracy

        if (t % 5 == 0) or t == hyper.rounds - 1:
            I_node_now = t32(stage_remaining)[
                torch.as_tensor(topo.node_stage, dtype=torch.int64)
            ]
            t_now, r_now, _ = evaluate_strategy(
                carry.p, topo, profile, I_node_now, hyper
            )
            delays.append(t_now)
            objectives.append(r_now)
            accuracies.append(accuracy)

    final = DtoState(
        carry=carry,
        thresholds=thresholds,
        stage_remaining=stage_remaining,
        accuracy=accuracy,
        round=state.round + hyper.rounds,
    )
    return PhaseResult(
        state=final,
        delay_history=np.asarray(delays),
        objective_history=np.asarray(objectives),
        accuracy_history=np.asarray(accuracies),
        rounds_run=hyper.rounds,
    )


def solve(
    topo: Topology,
    profile: ModelProfile,
    exit_profile: ExitProfile,
    hyper: DtoHyperParams | None = None,
    max_phases: int = 8,
    tol: float = 1e-4,
    adapt_thresholds: bool = True,
    tau_decay: float = 0.6,
    tau_floor: float = 0.01,
) -> PhaseResult:
    """Run configuration phases until R(P) stops improving (convergence per
    §3.5: R(P^t) is monotone decreasing and bounded below).

    The per-phase step size decays geometrically: the fixed-step Eq. 19
    dynamics oscillate in an O(tau_p) band around the convex optimum
    (the update is a Frank-Wolfe step toward the argmin-Delta vertex), so
    diminishing steps recover convergence to the interior optimum."""
    hyper = hyper or DtoHyperParams()
    round_step = make_round_step(topo, profile, hyper)
    state = None
    last: PhaseResult | None = None
    prev_obj = np.inf
    tau = hyper.tau_p
    for _ in range(max_phases):
        last = run_configuration_phase(
            topo,
            profile,
            exit_profile,
            hyper,
            state=state,
            adapt_thresholds=adapt_thresholds,
            round_step=round_step,
            tau_p=tau,
        )
        state = last.state
        obj = float(last.objective_history[-1])
        # stop only once the step size has annealed AND progress stalled —
        # fixed-tau oscillation would otherwise trigger a premature break
        if tau <= tau_floor and abs(prev_obj - obj) <= tol * max(abs(prev_obj), 1.0):
            break
        prev_obj = obj
        tau = max(tau * tau_decay, tau_floor)
    assert last is not None
    return last
