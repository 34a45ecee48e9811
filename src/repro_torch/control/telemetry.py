"""Streaming telemetry for the online control plane.

A copy of ``repro.control.telemetry``.

The serving engine emits one observation per event as its simulated clock
advances — arrivals at end devices, stage batches (GFLOPs, wall seconds,
queue depth), residual-stream transfers, and exit decisions.
:class:`Telemetry` subscribes to the engine's instrumentation stream
(:mod:`repro_torch.obs.stream` — the same call sites that feed span tracing and
metrics), consuming the hook subset it defines and folding the
observations into sliding-window / EWMA estimators; it can render
them as an *effective* :class:`~repro_torch.core.types.Topology`: the optimizer's
static profile with every measured quantity replaced by its live estimate.
That effective topology is what the controller re-optimizes against — the
measure half of the measure→re-optimize loop (EdgeShard / MoE² style) the
paper's dynamic experiments assume.

Estimator choices:

  * per-node service rates ``mu`` ride on :class:`StragglerMonitor` (EWMA of
    GFLOPs/wall per batch) — capacity drift shows up within a few batches;
  * per-ED arrival rates are sliding-window counts (bursts need a windowed
    rate, an EWMA over inter-arrival gaps reacts too slowly at low rates);
  * link rates are EWMAs keyed by the ``(src, dst)`` pair, so estimates
    survive edge-index shifts when a node failure rewrites the edge arrays;
  * queue depths and the realized exit-stage histogram are kept for
    reporting / prediction priors, not for the optimizer (DTO-EE's queueing
    model derives depths itself).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.types import Topology
from repro_torch.runtime.elastic import StragglerMonitor


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    window_s: float = 2.0  # sliding window for arrival / exit counts
    ewma_alpha: float = 0.3  # EWMA weight for service + link rates
    mu_floor: float = 1e-6  # effective-topology clamp (validate() needs > 0)


class Telemetry:
    """Sliding-window estimators over the engine's streaming observations.

    All hooks take the *simulated* timestamp of the observation; estimators
    take ``now`` so the window can be evicted lazily.  The object is cheap
    enough to leave attached to every serve call.
    """

    def __init__(self, topo: Topology, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        self.num_nodes = topo.num_nodes
        self.num_stages = topo.num_stages
        self.monitor = StragglerMonitor.from_topology(
            topo, alpha=self.config.ewma_alpha
        )
        n = self.num_nodes
        self._t0: float | None = None  # earliest observation timestamp
        # sliding windows: min-heaps of (t, key) + count arrays kept in sync.
        # Heaps, not FIFO deques: observations arrive out of timestamp order
        # (batches are stamped at completion when scheduled, arrivals carry
        # their ED timestamp but land at first-hop completion), and eviction
        # must still drop exactly the entries older than the window.
        self._arr_q: list[tuple[float, int]] = []
        self._arr_count = np.zeros(n, np.int64)
        self._arr_seen = False  # any arrival ever: empty window then means ~0
        self._srv_q: list[tuple[float, int]] = []
        self._srv_count = np.zeros(n, np.int64)
        self._exit_q: list[tuple[float, int]] = []
        self._exit_count = np.zeros(self.num_stages + 1, np.int64)
        # EWMAs
        self._edge_hat: dict[tuple[int, int], float] = {}
        self._qdepth_hat = np.zeros(n, np.float64)
        self._dead: set[int] = set()

    def attach_monitor(self, monitor: StragglerMonitor) -> None:
        """Adopt the engine's StragglerMonitor so there is ONE capacity EWMA:
        the estimates the controller plans from are exactly the ones
        ``ServeStats.capacity_estimates`` reports (the engine calls this at
        serve start)."""
        self.monitor = monitor

    # -- hooks (instrumentation-stream subscriber subset) --------------------
    def _seen(self, t: float) -> None:
        if self._t0 is None or t < self._t0:
            self._t0 = t

    def on_arrival(self, t: float, node: int, rid: int = -1) -> None:
        self._seen(t)
        self._arr_seen = True
        heapq.heappush(self._arr_q, (t, int(node)))
        self._arr_count[int(node)] += 1

    def on_batch(
        self, t: float, node: int, gflops: float, wall: float,
        queue_depth: int, **_,
    ) -> None:
        self._seen(t)
        node = int(node)
        self.monitor.observe(node, gflops, wall)
        heapq.heappush(self._srv_q, (t, node))
        self._srv_count[node] += 1
        a = self.config.ewma_alpha
        self._qdepth_hat[node] = (1 - a) * self._qdepth_hat[node] + a * queue_depth

    def on_transfer(
        self, t0: float, t1: float, wall: float, src: int, dst: int,
        rid: int = -1, mb: float = 0.0,
    ) -> None:
        # ``wall`` is the modeled hop time (mb / edge_rate), passed explicitly
        # rather than recomputed as t1 - t0: the estimator must see the exact
        # float the engine charged, not its round-trip through the timeline
        if wall <= 0:
            return
        self._seen(t1)
        key = (int(src), int(dst))
        rate = mb / wall
        prev = self._edge_hat.get(key)
        a = self.config.ewma_alpha
        self._edge_hat[key] = rate if prev is None else (1 - a) * prev + a * rate

    def on_exit(self, t: float, rid: int, stage: int, conf: float = 0.0) -> None:
        self._seen(t)
        heapq.heappush(self._exit_q, (t, int(stage)))
        self._exit_count[int(stage)] += 1

    def on_failure(self, t: float, node: int) -> None:
        """Failure detection: pin the dead replica's capacity estimate."""
        self._dead.add(int(node))
        self.monitor.mu_hat[int(node)] = self.config.mu_floor

    # -- estimators ---------------------------------------------------------
    def _evict(self, now: float) -> None:
        cut = now - self.config.window_s
        while self._arr_q and self._arr_q[0][0] < cut:
            _, v = heapq.heappop(self._arr_q)
            self._arr_count[v] -= 1
        while self._srv_q and self._srv_q[0][0] < cut:
            _, v = heapq.heappop(self._srv_q)
            self._srv_count[v] -= 1
        while self._exit_q and self._exit_q[0][0] < cut:
            _, s = heapq.heappop(self._exit_q)
            self._exit_count[s] -= 1

    def _span(self, now: float) -> float:
        if self._t0 is None:
            return 0.0
        return min(self.config.window_s, max(now - self._t0, 0.0))

    def arrival_rates(self, view: Topology, now: float) -> np.ndarray:
        """Measured per-node external arrival rates; the view's values where
        nothing has been observed yet (cold start)."""
        self._evict(now)
        phi = view.phi_ext.copy()
        span = self._span(now)
        if span > 0 and self._arr_seen:
            eds = np.nonzero(view.node_stage == 0)[0]
            phi[eds] = self._arr_count[eds] / span
        return phi

    def mu_estimates(self, view: Topology, now: float) -> np.ndarray:
        """EWMA capacity estimates for replicas with recent batches; the
        view's values elsewhere."""
        self._evict(now)
        mu = view.mu.copy()
        seen = np.nonzero(self._srv_count > 0)[0]
        for v in seen:
            mu[v] = max(float(self.monitor.mu_hat[v]), self.config.mu_floor)
        for v in self._dead:
            mu[v] = self.config.mu_floor
        return mu

    def edge_rate_estimates(self, view: Topology) -> np.ndarray:
        rate = view.edge_rate.copy()
        for i, (s, d) in enumerate(zip(view.edge_src, view.edge_dst)):
            hat = self._edge_hat.get((int(s), int(d)))
            if hat is not None:
                rate[i] = max(hat, 1e-9)
        return rate

    def exit_fractions(self, now: float) -> np.ndarray:
        """Realized exit-stage distribution over the window (index = stage;
        0 unused)."""
        self._evict(now)
        total = self._exit_count.sum()
        if total == 0:
            return np.zeros_like(self._exit_count, np.float64)
        return self._exit_count / total

    def queue_depths(self) -> np.ndarray:
        return self._qdepth_hat.copy()

    def effective_topology(self, view: Topology, now: float) -> Topology:
        """The view with every measured quantity replaced by its estimate —
        what the controller's configuration phase optimizes against."""
        return dataclasses.replace(
            view,
            mu=self.mu_estimates(view, now),
            phi_ext=self.arrival_rates(view, now),
            edge_rate=self.edge_rate_estimates(view),
        )

    def snapshot(self, view: Topology, now: float) -> dict:
        """Loggable summary of the current estimates."""
        self._evict(now)
        mu = self.mu_estimates(view, now)
        es = np.nonzero(view.node_stage > 0)[0]
        return {
            "t": float(now),
            "arrival_rate_total": float(
                self.arrival_rates(view, now)[view.node_stage == 0].sum()
            ),
            "mu_estimates": {int(v): float(mu[v]) for v in es},
            "mean_queue_depth": float(self._qdepth_hat[es].mean()) if es.size else 0.0,
            "exit_fractions": self.exit_fractions(now).tolist(),
            "observed_edges": len(self._edge_hat),
        }
