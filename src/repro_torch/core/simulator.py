"""Routing-CDF sampler of the discrete-event simulator.

``RoutingCdf`` is copied from ``repro.core.simulator``: the serving engine
samples each request's next hop with it.  The event simulator itself
(``simulate_slot``) is not ported yet (ROADMAP).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import Topology


class RoutingCdf:
    """Per-strategy cache of the routing CDF over every node's out-edges.

    Successor sampling is one inverse-CDF draw (``searchsorted`` into the
    node's precomputed cumsum slice) instead of an ``rng.choice(p=...)``
    call — the simulator samples once per task-hop, so this is hot.
    """

    def __init__(self, topo: Topology, p: np.ndarray):
        self.topo = topo
        self.cdf = np.cumsum(np.asarray(p, np.float64))
        # per-node total mass: cdf[hi-1] - (cdf[lo-1] if lo else 0)
        off = topo.edge_offsets

        def _at(i: int) -> float:
            return float(self.cdf[i - 1]) if i > 0 else 0.0

        self.lo_mass = np.array([_at(int(o)) for o in off[:-1]])
        self.hi_mass = np.array([_at(int(o)) for o in off[1:]])

    def sample(self, rng: np.random.Generator, node: int) -> tuple[int, int]:
        topo = self.topo
        lo, hi = int(topo.edge_offsets[node]), int(topo.edge_offsets[node + 1])
        m_lo, m_hi = self.lo_mass[node], self.hi_mass[node]
        if m_hi - m_lo <= 0:
            e = int(rng.integers(lo, hi))
        else:
            r = m_lo + rng.random() * (m_hi - m_lo)
            e = min(int(np.searchsorted(self.cdf[lo:hi], r, side="right")) + lo, hi - 1)
        return int(topo.edge_dst[e]), e
