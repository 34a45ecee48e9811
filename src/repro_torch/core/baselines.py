"""Baseline offloading strategies from paper §4.1: CF, BF, NGTO, GA.

The counterpart of ``repro.core.baselines``: the same host-side numpy
searches, with every strategy returned as a float32 torch tensor on the CPU
(where the reference returns a ``jnp`` array), as the port's ``dto_ee``
holds its strategy.

All baselines use the SAME threshold-adaptation machinery as DTO-EE (the
paper adapts thresholds across all baselines with equal frequency/step), so
a baseline here only decides the offloading probabilities P.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gradients, queueing
from repro_torch.core.queueing import t32
from repro_torch.core.thresholds import threshold_step
from repro_torch.core.types import DtoHyperParams, ModelProfile, Topology


def computing_first(topo: Topology) -> torch.Tensor:
    """CF: offload proportionally to receiver computing capacity mu_j."""
    w = topo.mu[topo.edge_dst].copy()
    w[~np.isfinite(w)] = 0.0
    return _normalize_per_source(topo, w)


def bandwidth_first(topo: Topology) -> torch.Tensor:
    """BF: offload proportionally to link bandwidth r_{i,j}."""
    return _normalize_per_source(topo, topo.edge_rate.copy())


def _normalize_per_source(topo: Topology, w: np.ndarray) -> torch.Tensor:
    w = np.maximum(w, 1e-12)
    sums = np.zeros(topo.num_nodes)
    np.add.at(sums, topo.edge_src, w)
    return t32(w / sums[topo.edge_src])


# ---------------------------------------------------------------------------
# NGTO: non-cooperative game task offloading [29].
# Each offloader performs a selfish *myopic* best response — minimizing only
# its own immediate hop cost (transmission + receiver M/D/1-PS delay) given
# the other offloaders' current strategies — updated in round-robin order
# until a Nash equilibrium (no offloader moves).  The paper's critique (and
# what we reproduce): myopia w.r.t. downstream stages + long cyclic decision
# time.
# ---------------------------------------------------------------------------


def _simplex_project(v: np.ndarray) -> np.ndarray:
    """Euclidean projection onto the probability simplex."""
    u = np.sort(v)[::-1]
    css = np.cumsum(u) - 1.0
    ind = np.arange(1, v.shape[0] + 1)
    cond = u - css / ind > 0
    rho = ind[cond][-1]
    theta = css[cond][-1] / rho
    return np.maximum(v - theta, 0.0)


def ngto(
    topo: Topology,
    profile: ModelProfile,
    stage_remaining: np.ndarray,
    max_sweeps: int = 30,
    br_iters: int = 40,
    br_lr: float = 0.05,
    tol: float = 1e-4,
) -> tuple[torch.Tensor, int]:
    """Returns (p, round_robin_sweeps_used).  Pure numpy: the game runs on
    hosts, sequentially, by construction (that's its weakness)."""
    alpha = np.concatenate([[0.0], np.asarray(profile.alpha)])
    alpha_n = alpha[topo.node_stage]
    beta = np.concatenate([[0.0], np.asarray(profile.beta)])
    beta_e = beta[topo.node_stage[topo.edge_dst]]
    t_cm = beta_e / topo.edge_rate
    mu = np.where(np.isinf(topo.mu), 1e30, topo.mu)
    I_node = stage_remaining[topo.node_stage]

    deg = topo.out_degree()
    p = 1.0 / np.maximum(deg, 1)[topo.edge_src]

    H = topo.num_stages
    offloaders = np.nonzero(topo.node_stage < H)[0]

    def flows(p_vec: np.ndarray) -> np.ndarray:
        phi = topo.phi_ext.copy()
        for h in range(H):
            sel = topo.node_stage[topo.edge_src] == h
            inflow = np.zeros(topo.num_nodes)
            np.add.at(
                inflow,
                topo.edge_dst[sel],
                p_vec[sel] * phi[topo.edge_src[sel]] * I_node[topo.edge_src[sel]],
            )
            at = topo.node_stage == h + 1
            phi[at] = inflow[at]
        return phi

    sweeps = 0
    for sweep in range(max_sweeps):
        sweeps = sweep + 1
        moved = 0.0
        for i in offloaders:
            lo, hi = topo.edge_offsets[i], topo.edge_offsets[i + 1]
            if hi - lo <= 1:
                continue
            phi = flows(p)
            out_rate = phi[i] * I_node[i]  # tasks/s this offloader emits
            dsts = topo.edge_dst[lo:hi]
            # receiver background load excluding this offloader's share
            lam_all = phi * alpha_n
            own = p[lo:hi] * out_rate * alpha_n[dsts]
            lam_bg = lam_all[dsts] - own
            pi = p[lo:hi].copy()
            # projected gradient best response on the myopic hop cost
            for _ in range(br_iters):
                lam_j = lam_bg + pi * out_rate * alpha_n[dsts]
                gap = np.maximum(mu[dsts] - lam_j, 1e-6)
                # d/dp [ p*(t_cm + a/(mu-lam(p))) ]
                grad = (
                    t_cm[lo:hi]
                    + alpha_n[dsts] / gap
                    + pi * out_rate * alpha_n[dsts] ** 2 / gap**2
                )
                pi = _simplex_project(pi - br_lr * grad / (np.abs(grad).max() + 1e-12))
            moved = max(moved, float(np.abs(pi - p[lo:hi]).max()))
            p[lo:hi] = pi
        if moved < tol:
            break
    return t32(p), sweeps


# ---------------------------------------------------------------------------
# GA: genetic path search per ED [42].  Each ED gathers (possibly outdated)
# global state and searches a full source-routed path (one ES per stage)
# minimizing ITS OWN delay, then sends all its tasks down that path.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GaResult:
    # paths[ed] = tuple of node ids, one per stage 1..H
    paths: dict[int, tuple[int, ...]]
    p: torch.Tensor  # effective per-edge split implied by the chosen paths
    generations: int


def _edge_lookup(topo: Topology) -> dict[tuple[int, int], int]:
    return {
        (int(s), int(d)): k
        for k, (s, d) in enumerate(zip(topo.edge_src, topo.edge_dst))
    }


def genetic_paths(
    topo: Topology,
    profile: ModelProfile,
    stage_remaining: np.ndarray,
    lam_snapshot: np.ndarray | None = None,
    seed: int = 0,
    pop_size: int = 24,
    generations: int = 15,
    mutate_prob: float = 0.25,
) -> GaResult:
    """Per-ED GA over source-routed paths, scored against a *snapshot* of
    node loads (the outdated-information failure mode the paper describes:
    every ED optimizes selfishly against the same stale lambda)."""
    rng = np.random.default_rng(seed)
    H = topo.num_stages
    alpha = np.concatenate([[0.0], np.asarray(profile.alpha)])
    beta = np.concatenate([[0.0], np.asarray(profile.beta)])
    mu = np.where(np.isinf(topo.mu), 1e30, topo.mu)
    lookup = _edge_lookup(topo)
    succ = {int(v): topo.successors(v).tolist() for v in range(topo.num_nodes)}
    if lam_snapshot is None:
        lam_snapshot = np.zeros(topo.num_nodes)

    def random_path(ed: int) -> tuple[int, ...]:
        path, cur = [], ed
        for _ in range(H):
            nxt = int(rng.choice(succ[cur]))
            path.append(nxt)
            cur = nxt
        return tuple(path)

    def path_delay(ed: int, path: tuple[int, ...]) -> float:
        cur, total, alive = ed, 0.0, 1.0
        for h, nxt in enumerate(path, start=1):
            e = lookup[(cur, nxt)]
            gap = max(mu[nxt] - lam_snapshot[nxt], 1e-6)
            hop = beta[h] / topo.edge_rate[e] + alpha[h] / gap
            total += alive * hop
            alive *= stage_remaining[h]
            cur = nxt
        return total

    def crossover(a: tuple[int, ...], b: tuple[int, ...], ed: int) -> tuple[int, ...]:
        """Hop-by-hop repair: prefer a's prefix / b's suffix where the edge
        exists, fall back to a random successor (keeps every child valid
        even when the parents were produced by mutation splices)."""
        cut = int(rng.integers(1, H)) if H > 1 else 0
        child: list[int] = []
        cur = ed
        for h in range(H):
            options = succ[cur]
            want = a[h] if h < cut else b[h]
            child.append(want if want in options else int(rng.choice(options)))
            cur = child[-1]
        return tuple(child)

    eds = topo.nodes_at_stage(0)
    paths: dict[int, tuple[int, ...]] = {}
    for ed in eds:
        pop = [random_path(int(ed)) for _ in range(pop_size)]
        for _ in range(generations):
            scored = sorted(pop, key=lambda pth: path_delay(int(ed), pth))
            elite = scored[: max(pop_size // 4, 2)]
            children = []
            while len(children) < pop_size - len(elite):
                a, b = rng.choice(len(elite), 2)
                child = crossover(elite[a], elite[b], int(ed))
                if rng.random() < mutate_prob:
                    # mutate one hop and repair the suffix
                    cut = int(rng.integers(0, H))
                    child = crossover(child[:cut] + random_path(int(ed))[cut:], child, int(ed))
                children.append(child)
            pop = elite + children
        paths[int(ed)] = min(pop, key=lambda pth: path_delay(int(ed), pth))

    p = paths_to_strategy(topo, profile, stage_remaining, paths)
    return GaResult(paths=paths, p=p, generations=generations)


def paths_to_strategy(
    topo: Topology,
    profile: ModelProfile,
    stage_remaining: np.ndarray,
    paths: dict[int, tuple[int, ...]],
) -> torch.Tensor:
    """Convert per-ED source routes into effective per-edge splits: route the
    (exit-thinned) flow down each path, then normalize flow per offloader.
    Edges carrying no flow get probability 0 unless the node carries no flow
    at all (then uniform — it must still advertise a valid strategy)."""
    lookup = _edge_lookup(topo)
    flow = np.zeros(topo.num_edges)
    for ed, path in paths.items():
        rate, cur = float(topo.phi_ext[ed]), ed
        for h, nxt in enumerate(path, start=1):
            flow[lookup[(cur, nxt)]] += rate
            rate *= stage_remaining[h]
            cur = nxt
    sums = np.zeros(topo.num_nodes)
    np.add.at(sums, topo.edge_src, flow)
    deg = np.maximum(topo.out_degree(), 1)
    uniform = 1.0 / deg[topo.edge_src]
    has_flow = sums[topo.edge_src] > 0
    p = np.where(has_flow, flow / np.maximum(sums[topo.edge_src], 1e-12), uniform)
    return t32(p)


# ---------------------------------------------------------------------------
# Threshold adaptation for baselines (paper §4.1: "We adaptively adjust
# confidence thresholds across all baselines ... same update frequency and
# step size as DTO-EE").  A baseline only decides P; this runs the Eq. 17-18
# coupled adjustment against that fixed P, cycling branches like Alg. 3.
# ---------------------------------------------------------------------------


def adapt_thresholds_for_strategy(
    topo: Topology,
    profile: ModelProfile,
    exit_profile,
    p: torch.Tensor,
    hyper: DtoHyperParams,
    thresholds0: np.ndarray | None = None,
    sweeps: int = 10,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Returns (thresholds, stage_remaining, accuracy) adapted to P."""
    thresholds = (
        np.asarray(thresholds0, np.float64)
        if thresholds0 is not None
        else np.full(exit_profile.num_early_branches, 0.8)
    )
    total_phi = float(topo.phi_ext.sum())
    ev = exit_profile.evaluate(thresholds)
    for _ in range(sweeps):
        changed_any = False
        for b in range(exit_profile.num_early_branches):
            I_node = queueing.node_remaining_ratio(topo, t32(ev.stage_remaining))
            phi, lam = queueing.steady_state_flows(p, topo, profile, I_node)
            _, omega = gradients.backward_recursion(
                p, topo, profile, I_node, lam, hyper
            )
            stage = exit_profile.branch_stage[b]
            nodes = topo.nodes_at_stage(stage)
            decision = threshold_step(
                exit_profile,
                thresholds,
                b,
                phi.numpy()[nodes],
                omega.numpy()[nodes],
                total_phi,
                hyper,
            )
            if decision.changed:
                thresholds = decision.thresholds
                ev = exit_profile.evaluate(thresholds)
                changed_any = True
        if not changed_any:
            break
    return thresholds, ev.stage_remaining, ev.accuracy
