"""Edge-network topology builders (paper §4.1 deployment) + dynamic mutations."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.types import ModelProfile, Topology

# Effective inference throughput (GFLOP/s) of the three Jetson device
# families, per working mode (paper §4.1: "the fastest mode (mode 0 of AGX)
# achieves inference speeds approximately 5x faster than the slowest mode
# (mode 1 of TX2)").  Mode 0 is the fast mode.
JETSON_CAPACITY_GFLOPS: dict[str, tuple[float, float]] = {
    "tx2": (60.0, 40.0),
    "nx": (100.0, 70.0),
    "agx": (200.0, 130.0),
}
CAPACITY_POOL = np.array(
    [c for modes in JETSON_CAPACITY_GFLOPS.values() for c in modes], np.float64
)


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Knobs for the random staged deployment of paper §4.1."""

    num_eds: int = 50
    es_per_stage: tuple[int, int] = (4, 6)  # inclusive range, skewed to fewer late
    receivers_per_node: tuple[int, int] = (2, 4)  # inclusive range
    ed_bw_mbps: tuple[float, float] = (1.0, 10.0)  # ED -> ES
    es_bw_mbps: tuple[float, float] = (10.0, 20.0)  # ES -> ES
    ed_arrival_rate: tuple[float, float] = (0.5, 1.5)  # tasks/s scale, x rate knob


def _stage_sizes(rng: np.random.Generator, spec: NetworkSpec, num_stages: int) -> list[int]:
    lo, hi = spec.es_per_stage
    sizes = []
    for h in range(num_stages):
        # Skew later stages towards fewer ESs (early-exit thins traffic).
        frac = h / max(num_stages - 1, 1)
        mean = hi - frac * (hi - lo)
        size = int(np.clip(round(rng.normal(mean, 0.7)), lo, hi))
        sizes.append(size)
    return sizes


def build_edge_network(
    seed: int,
    profile: ModelProfile,
    spec: NetworkSpec | None = None,
    arrival_rate_scale: float = 1.0,
    capacity_scale: float = 1.0,
) -> Topology:
    """Random staged deployment: EDs -> S^1 -> ... -> S^H.

    Every offloader is wired to 2-4 receivers in the next stage; wiring
    guarantees every receiver has at least one predecessor (otherwise it
    would be dead weight) and every offloader at least one successor.
    """
    spec = spec or NetworkSpec()
    rng = np.random.default_rng(seed)
    H = profile.num_stages

    sizes = [spec.num_eds] + _stage_sizes(rng, spec, H)
    stage_of: list[int] = []
    for h, size in enumerate(sizes):
        stage_of += [h] * size
    node_stage = np.asarray(stage_of, np.int32)
    num_nodes = node_stage.shape[0]

    node_ids_at = []
    start = 0
    for size in sizes:
        node_ids_at.append(np.arange(start, start + size, dtype=np.int32))
        start += size

    mu = np.full(num_nodes, np.inf, np.float64)
    for h in range(1, H + 1):
        ids = node_ids_at[h]
        mu[ids] = rng.choice(CAPACITY_POOL, size=ids.shape[0]) * capacity_scale

    phi_ext = np.zeros(num_nodes, np.float64)
    lo, hi = spec.ed_arrival_rate
    phi_ext[node_ids_at[0]] = rng.uniform(lo, hi, size=sizes[0]) * arrival_rate_scale

    # --- wiring ----------------------------------------------------------
    edge_src: list[int] = []
    edge_dst: list[int] = []
    edge_rate: list[float] = []
    for h in range(0, H):  # offloader stage h -> receiver stage h+1
        senders = node_ids_at[h]
        receivers = node_ids_at[h + 1]
        rlo, rhi = spec.receivers_per_node
        bw_lo, bw_hi = spec.ed_bw_mbps if h == 0 else spec.es_bw_mbps
        chosen: list[np.ndarray] = []
        for s in senders:
            k = min(int(rng.integers(rlo, rhi + 1)), receivers.shape[0])
            picks = rng.choice(receivers, size=k, replace=False)
            chosen.append(np.sort(picks))
        # Ensure each receiver has >=1 predecessor.
        covered = np.unique(np.concatenate(chosen)) if chosen else np.array([], np.int32)
        for r in receivers:
            if r not in covered:
                s_idx = int(rng.integers(0, senders.shape[0]))
                chosen[s_idx] = np.unique(np.append(chosen[s_idx], r))
        for s, picks in zip(senders, chosen):
            for d in picks:
                edge_src.append(int(s))
                edge_dst.append(int(d))
                edge_rate.append(float(rng.uniform(bw_lo, bw_hi)))

    order = np.lexsort((np.asarray(edge_dst), np.asarray(edge_src)))
    edge_src_a = np.asarray(edge_src, np.int32)[order]
    edge_dst_a = np.asarray(edge_dst, np.int32)[order]
    edge_rate_a = np.asarray(edge_rate, np.float64)[order]

    counts = np.bincount(edge_src_a, minlength=num_nodes)
    edge_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    topo = Topology(
        node_stage=node_stage,
        mu=mu,
        phi_ext=phi_ext,
        edge_src=edge_src_a,
        edge_dst=edge_dst_a,
        edge_rate=edge_rate_a,
        edge_offsets=edge_offsets,
    )
    topo.validate()
    return topo


def build_uniform_network(
    seed: int,
    profile: ModelProfile,
    num_eds: int = 20,
    es_per_stage: int = 4,
    capacity_gflops: float = 120.0,
    bw_mbps: float = 15.0,
    ed_arrival_rate: float = 1.0,
    fully_connected: bool = True,
) -> Topology:
    """Homogeneous deployment used by the Fig. 9 ablation (same #ES per stage,
    same capacity, same links)."""
    rng = np.random.default_rng(seed)
    H = profile.num_stages
    sizes = [num_eds] + [es_per_stage] * H
    node_stage = np.concatenate([np.full(s, h, np.int32) for h, s in enumerate(sizes)])
    num_nodes = node_stage.shape[0]
    mu = np.full(num_nodes, np.inf, np.float64)
    mu[node_stage > 0] = capacity_gflops
    phi_ext = np.zeros(num_nodes, np.float64)
    phi_ext[node_stage == 0] = ed_arrival_rate

    node_ids_at = [np.nonzero(node_stage == h)[0] for h in range(H + 1)]
    edge_src, edge_dst, edge_rate = [], [], []
    for h in range(0, H):
        for s in node_ids_at[h]:
            receivers = node_ids_at[h + 1]
            if not fully_connected:
                k = min(3, receivers.shape[0])
                receivers = rng.choice(receivers, size=k, replace=False)
            for d in np.sort(receivers):
                edge_src.append(int(s))
                edge_dst.append(int(d))
                edge_rate.append(bw_mbps)
    edge_src_a = np.asarray(edge_src, np.int32)
    edge_dst_a = np.asarray(edge_dst, np.int32)
    edge_rate_a = np.asarray(edge_rate, np.float64)
    counts = np.bincount(edge_src_a, minlength=num_nodes)
    edge_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    topo = Topology(node_stage, mu, phi_ext, edge_src_a, edge_dst_a, edge_rate_a, edge_offsets)
    topo.validate()
    return topo


# ---------------------------------------------------------------------------
# Dynamic-environment mutations (paper §4.3) — all return fresh Topology.
# ---------------------------------------------------------------------------


def with_arrival_rates(topo: Topology, rng: np.random.Generator, lo: float, hi: float) -> Topology:
    phi = topo.phi_ext.copy()
    eds = topo.nodes_at_stage(0)
    phi[eds] = rng.uniform(lo, hi, size=eds.shape[0])
    return dataclasses.replace(topo, phi_ext=phi)


def with_resampled_capacities(
    topo: Topology, rng: np.random.Generator, scale: float = 1.0
) -> Topology:
    """Re-draw each ES's computing mode (paper: 'adjust the computation mode')."""
    mu = topo.mu.copy()
    ess = np.nonzero(topo.node_stage > 0)[0]
    mu[ess] = rng.choice(CAPACITY_POOL, size=ess.shape[0]) * scale
    return dataclasses.replace(topo, mu=mu)


def with_capacity_scale(topo: Topology, scale: float) -> Topology:
    mu = topo.mu.copy()
    ess = topo.node_stage > 0
    mu[ess] = mu[ess] * scale
    return dataclasses.replace(topo, mu=mu)


def with_link_degradation(
    topo: Topology,
    pairs: Sequence[tuple[int, int]],
    factor: float,
) -> Topology:
    """Scale the bandwidth of the named (src, dst) links by ``factor``
    (congestion / interference on specific hops, paper §4.3's dynamic links).

    Unknown pairs are ignored — the caller may hold a pair list predating a
    node failure that dropped some of those edges.
    """
    if factor <= 0:
        raise ValueError("link degradation factor must be positive")
    rate = topo.edge_rate.copy()
    index = {
        (int(s), int(d)): i
        for i, (s, d) in enumerate(zip(topo.edge_src, topo.edge_dst))
    }
    for pair in pairs:
        i = index.get((int(pair[0]), int(pair[1])))
        if i is not None:
            rate[i] = rate[i] * factor
    return dataclasses.replace(topo, edge_rate=rate)


def with_node_failure(topo: Topology, dead_node: int) -> Topology:
    """Drop a failed ES: remove its in/out edges (capacity -> 0 keeps indexing
    stable; the router must renormalize offloading probabilities).

    Raises if removing the node would strand an offloader with no successor —
    the caller must then trigger an elastic re-mesh instead.
    """
    if topo.node_stage[dead_node] == 0:
        raise ValueError("EDs do not fail in this model; they stop producing instead")
    keep = (topo.edge_src != dead_node) & (topo.edge_dst != dead_node)
    edge_src = topo.edge_src[keep]
    edge_dst = topo.edge_dst[keep]
    edge_rate = topo.edge_rate[keep]
    counts = np.bincount(edge_src, minlength=topo.num_nodes)
    H = int(topo.node_stage.max())
    deg_needed = (topo.node_stage < H) & (np.arange(topo.num_nodes) != dead_node)
    # EDs/ESs that still must offload:
    alive_senders = np.nonzero(deg_needed)[0]
    if np.any(counts[alive_senders] == 0):
        raise RuntimeError("node failure strands an offloader; elastic re-mesh required")
    mu = topo.mu.copy()
    mu[dead_node] = 1e-9  # effectively dead; no edges reference it anymore
    edge_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return dataclasses.replace(
        topo,
        mu=mu,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_rate=edge_rate,
        edge_offsets=edge_offsets,
    )
