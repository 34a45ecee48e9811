"""Failure handling + elastic re-meshing for the collaborative deployment.

The paper's control plane already IS the graceful-degradation mechanism:
an overloaded or dead replica's repulsive factor Delta explodes (queueing
term + exterior penalty), so traffic drains away within a few RUR/RUS
rounds with no global coordination.  This module supplies the harder edges:

  * ``handle_failure``      — drop a dead replica from the topology and
    renormalize the offloading strategy (warm start: surviving mass is
    rescaled, not reset — the paper's Eq. 19 dynamics then re-balance).
  * ``elastic_remesh``      — rebuild the topology when replicas join/leave
    a stage, carrying over offloading probabilities for surviving edges.
  * ``StragglerMonitor``    — EWMA service-rate tracker per replica; a
    throttled replica's mu estimate sinks, which feeds straight back into
    the DTO-R RUS messages (the paper's dynamic-environment adaptation).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import topology as topo_lib
from repro_torch.core.types import Topology


def renormalize_strategy(topo: Topology, p: np.ndarray) -> np.ndarray:
    """Per-source renormalization after edges were dropped/added (uniform
    where a source lost all probability mass)."""
    p = np.maximum(np.asarray(p, np.float64), 0.0)
    sums = np.zeros(topo.num_nodes)
    np.add.at(sums, topo.edge_src, p)
    deg = np.maximum(np.diff(topo.edge_offsets), 1)
    uniform = 1.0 / deg[topo.edge_src]
    ok = sums[topo.edge_src] > 1e-12
    return np.where(ok, p / np.maximum(sums[topo.edge_src], 1e-12), uniform)


def handle_failure(
    topo: Topology, p: np.ndarray, dead_node: int
) -> tuple[Topology, np.ndarray]:
    """Remove ``dead_node``; surviving edges keep their relative mass.

    Raises RuntimeError (from ``with_node_failure``) if the failure strands
    an offloader — the caller escalates to ``elastic_remesh``.
    """
    old_edges = list(zip(topo.edge_src.tolist(), topo.edge_dst.tolist()))
    new_topo = topo_lib.with_node_failure(topo, dead_node)
    keep = {
        (s, d): i for i, (s, d) in enumerate(old_edges) if s != dead_node and d != dead_node
    }
    p_new = np.zeros(new_topo.num_edges)
    for i, (s, d) in enumerate(
        zip(new_topo.edge_src.tolist(), new_topo.edge_dst.tolist())
    ):
        p_new[i] = p[keep[(s, d)]]
    return new_topo, renormalize_strategy(new_topo, p_new)


def elastic_remesh(
    topo: Topology,
    p: np.ndarray,
    stage: int,
    add_replicas: int = 0,
    mu_new: float = 100.0,
    rng: np.random.Generator | None = None,
) -> tuple[Topology, np.ndarray]:
    """Grow stage ``stage`` by ``add_replicas`` nodes (scale-out), wiring
    each new replica to every stage-(h-1) node and every stage-(h+1) node
    it can reach.  Surviving edges keep their probability mass; new edges
    start at a small epsilon so Eq. 19 can ramp them based on measured Delta.
    """
    rng = rng or np.random.default_rng(0)
    H = topo.num_stages
    assert 1 <= stage <= H
    n_old = topo.num_nodes
    new_ids = np.arange(n_old, n_old + add_replicas, dtype=np.int32)

    node_stage = np.concatenate([topo.node_stage, np.full(add_replicas, stage, np.int32)])
    mu = np.concatenate([topo.mu, np.full(add_replicas, mu_new)])
    phi_ext = np.concatenate([topo.phi_ext, np.zeros(add_replicas)])

    old_pairs = list(zip(topo.edge_src.tolist(), topo.edge_dst.tolist()))
    pairs = list(old_pairs)
    rates = topo.edge_rate.tolist()
    preds = np.nonzero(topo.node_stage == stage - 1)[0]
    succs = np.nonzero(topo.node_stage == stage + 1)[0] if stage < H else []
    for nid in new_ids:
        for s in preds:
            pairs.append((int(s), int(nid)))
            rates.append(float(rng.uniform(10.0, 20.0)))
        for d in succs:
            pairs.append((int(nid), int(d)))
            rates.append(float(rng.uniform(10.0, 20.0)))

    order = np.lexsort((np.array([d for _, d in pairs]), np.array([s for s, _ in pairs])))
    pairs_sorted = [pairs[i] for i in order]
    rates_sorted = np.array(rates)[order]
    edge_src = np.array([s for s, _ in pairs_sorted], np.int32)
    edge_dst = np.array([d for _, d in pairs_sorted], np.int32)
    counts = np.bincount(edge_src, minlength=n_old + add_replicas)
    edge_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    new_topo = Topology(
        node_stage=node_stage,
        mu=mu,
        phi_ext=phi_ext,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_rate=rates_sorted,
        edge_offsets=edge_offsets,
    )
    new_topo.validate()

    old_lookup = {pair: i for i, pair in enumerate(old_pairs)}
    eps = 0.02
    p_new = np.empty(len(pairs_sorted))
    for i, pair in enumerate(pairs_sorted):
        j = old_lookup.get(pair)
        p_new[i] = p[j] if j is not None else eps
    return new_topo, renormalize_strategy(new_topo, p_new)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA service-rate estimates driving the mu each DTO-R advertises."""

    mu_hat: np.ndarray  # [N] GFLOP/s estimates
    alpha: float = 0.3

    @classmethod
    def from_topology(cls, topo: Topology, alpha: float = 0.3) -> "StragglerMonitor":
        return cls(mu_hat=np.where(np.isinf(topo.mu), 1e30, topo.mu).copy(), alpha=alpha)

    def observe(self, node: int, gflops_done: float, wall_seconds: float) -> None:
        if wall_seconds <= 0:
            return
        rate = gflops_done / wall_seconds
        self.mu_hat[node] = (1 - self.alpha) * self.mu_hat[node] + self.alpha * rate

    def throttled(self, topo: Topology, factor: float = 0.5) -> np.ndarray:
        """Nodes whose estimated rate fell below ``factor`` of nameplate."""
        nominal = np.where(np.isinf(topo.mu), 1e30, topo.mu)
        return np.nonzero(self.mu_hat < factor * nominal)[0]

    def as_topology(self, topo: Topology) -> Topology:
        """Topology with mu replaced by the current estimates (what the
        control plane should optimize against)."""
        import dataclasses as dc

        mu = np.where(np.isinf(topo.mu), np.inf, self.mu_hat)
        return dc.replace(topo, mu=mu)
