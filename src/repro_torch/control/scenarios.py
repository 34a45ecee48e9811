"""Composable live-environment perturbations (the paper's Figs. 7–8 regime).

A copy of ``repro.control.scenarios``.

A :class:`Scenario` is a list of timed :class:`ScenarioEvent` mutations the
engine applies to its *physical* serve-time topology as the simulated clock
passes each event — plus optional modulation of the arrival process itself
(piecewise arrival-rate factors and time-varying end-device weights).  The
optimizer's view never sees these mutations directly; it has to notice them
through telemetry and reconfigure, which is exactly what the closed-loop
benchmarks measure.

Builders pick concrete victims from the deployed topology (and, when given,
the live offloading strategy ``p`` — the busiest replica is the one the
strategy actually leans on), so a scenario composed for one network stresses
the load-bearing parts of another.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import topology as topo_lib
from repro_torch.core.types import Topology


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One timed mutation of the physical environment.

    kind:
      * ``mu_scale``    — scale node ``node``'s compute capacity by ``factor``
      * ``phi_scale``   — scale ``nodes``' external arrival rates by ``factor``
        (bookkeeping: the realized arrival process is shaped by the scenario's
        arrival modulation, this keeps the environment's ground truth aligned)
      * ``rate_scale``  — scale the bandwidth of the ``pairs`` links
      * ``fail``        — fail-stop node ``node`` (engine re-executes resident
        tasks from their source EDs and drops the node from both topologies)
    """

    time: float
    kind: str
    node: int = -1
    nodes: tuple[int, ...] = ()
    pairs: tuple[tuple[int, int], ...] = ()
    factor: float = 1.0


@dataclasses.dataclass
class Scenario:
    name: str
    events: list[ScenarioEvent] = dataclasses.field(default_factory=list)
    # piecewise-constant arrival-rate modulation: sorted (t, factor) steps,
    # factor holding from t onward; empty = homogeneous arrivals
    arrival_steps: tuple[tuple[float, float], ...] = ()
    # time-varying end-device weights: (t0, t1, {node: factor}) windows
    ed_windows: tuple[tuple[float, float, dict], ...] = ()

    # -- arrival-process modulation ----------------------------------------
    @property
    def modulates_arrivals(self) -> bool:
        return any(f != 1.0 for _, f in self.arrival_steps)

    def arrival_factor(self, t: float) -> float:
        f = 1.0
        for t0, step in self.arrival_steps:
            if t >= t0:
                f = step
        return f

    @property
    def max_arrival_factor(self) -> float:
        return max([f for _, f in self.arrival_steps] + [1.0])

    @property
    def modulates_eds(self) -> bool:
        return bool(self.ed_windows)

    def ed_weights(
        self, t: float, eds: np.ndarray, base_w: np.ndarray
    ) -> np.ndarray:
        w = np.asarray(base_w, np.float64).copy()
        for t0, t1, factors in self.ed_windows:
            if t0 <= t < t1:
                for i, v in enumerate(eds):
                    w[i] *= factors.get(int(v), 1.0)
        return w

    # -- environment mutation (engine-side, in place) -----------------------
    def apply_env(self, ev: ScenarioEvent, env: Topology) -> None:
        """Apply one (non-failure) event to the engine's private physical
        topology; arrays are mutated in place so every closure over the
        environment sees the change immediately."""
        if ev.kind == "mu_scale":
            env.mu[ev.node] = env.mu[ev.node] * ev.factor
        elif ev.kind == "phi_scale":
            for v in ev.nodes:
                env.phi_ext[v] = env.phi_ext[v] * ev.factor
        elif ev.kind == "rate_scale":
            env.edge_rate[:] = topo_lib.with_link_degradation(
                env, ev.pairs, ev.factor
            ).edge_rate
        else:
            raise ValueError(f"engine handles kind={ev.kind!r} itself")


# ---------------------------------------------------------------------------
# victim selection
# ---------------------------------------------------------------------------


def busiest_replica(topo: Topology, p: np.ndarray | None, stage: int = 1) -> int:
    """The stage-``stage`` node carrying the most strategy-weighted inbound
    traffic (uniform strategy when ``p`` is None) — the replica whose loss or
    throttling hurts a stale strategy the most."""
    if p is None:
        deg = np.maximum(topo.out_degree(), 1)
        p = 1.0 / deg[topo.edge_src]
    p = np.asarray(p, np.float64)
    mass = np.zeros(topo.num_nodes)
    src_stage = topo.node_stage[topo.edge_src]
    # weight stage-0 sources by their external rate; deeper sources equally
    w_src = np.where(topo.phi_ext > 0, topo.phi_ext, 1.0)
    for e in range(topo.num_edges):
        if int(topo.node_stage[topo.edge_dst[e]]) == stage:
            mass[topo.edge_dst[e]] += p[e] * w_src[topo.edge_src[e]]
    del src_stage
    nodes = topo.nodes_at_stage(stage)
    return int(nodes[int(np.argmax(mass[nodes]))])


def _safe_failure_victims(topo: Topology, stage: int = 1) -> list[int]:
    """Stage nodes whose removal strands no offloader (checked by actually
    trying the structural mutation)."""
    out = []
    for v in topo.nodes_at_stage(stage):
        try:
            topo_lib.with_node_failure(topo, int(v))
        except RuntimeError:
            continue
        out.append(int(v))
    return out


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def arrival_burst(
    topo: Topology,
    t0: float,
    t1: float,
    factor: float = 4.0,
    p: np.ndarray | None = None,
    ed_share: float = 0.5,
    seed: int = 0,
) -> Scenario:
    """A subset of end devices (``ed_share`` of the external-rate mass)
    bursts to ``factor``x during [t0, t1): the total arrival rate rises AND
    the traffic mix skews toward the bursting devices' preferred replicas —
    the re-balancing case a uniform burst would hide."""
    del p
    rng = np.random.default_rng(seed)
    eds = topo.nodes_at_stage(0)
    order = rng.permutation(len(eds))
    w = topo.phi_ext[eds]
    total = max(float(w.sum()), 1e-12)
    chosen: list[int] = []
    acc = 0.0
    for i in order:
        chosen.append(int(eds[i]))
        acc += float(w[i])
        if acc / total >= ed_share:
            break
    share = acc / total
    # bursting share at factor-x lifts the TOTAL rate by 1 + share*(factor-1)
    total_factor = 1.0 + share * (factor - 1.0)
    return Scenario(
        name="burst",
        events=[
            ScenarioEvent(t0, "phi_scale", nodes=tuple(chosen), factor=factor),
            ScenarioEvent(t1, "phi_scale", nodes=tuple(chosen), factor=1.0 / factor),
        ],
        arrival_steps=((0.0, 1.0), (t0, total_factor), (t1, 1.0)),
        ed_windows=((t0, t1, {v: factor for v in chosen}),),
    )


def node_slowdown(
    topo: Topology,
    t0: float,
    t1: float,
    factor: float = 0.15,
    p: np.ndarray | None = None,
    node: int | None = None,
) -> Scenario:
    """The busiest stage-1 replica throttles to ``factor`` of nameplate at
    ``t0`` (thermal / co-tenant interference) and recovers at ``t1``."""
    victim = busiest_replica(topo, p) if node is None else int(node)
    return Scenario(
        name="slowdown",
        events=[
            ScenarioEvent(t0, "mu_scale", node=victim, factor=factor),
            ScenarioEvent(t1, "mu_scale", node=victim, factor=1.0 / factor),
        ],
    )


def link_degradation(
    topo: Topology,
    t0: float,
    t1: float,
    factor: float = 0.1,
    p: np.ndarray | None = None,
    node: int | None = None,
) -> Scenario:
    """Every link INTO the busiest stage-1 replica degrades to ``factor`` of
    its bandwidth during [t0, t1) (congested uplink)."""
    victim = busiest_replica(topo, p) if node is None else int(node)
    pairs = tuple(
        (int(s), int(d))
        for s, d in zip(topo.edge_src, topo.edge_dst)
        if int(d) == victim
    )
    return Scenario(
        name="link",
        events=[
            ScenarioEvent(t0, "rate_scale", pairs=pairs, factor=factor),
            ScenarioEvent(t1, "rate_scale", pairs=pairs, factor=1.0 / factor),
        ],
    )


def node_failure(
    topo: Topology,
    t0: float,
    p: np.ndarray | None = None,
    node: int | None = None,
) -> Scenario:
    """Fail-stop of (by default) the busiest SAFE stage-1 replica at ``t0``
    — resident tasks re-execute from their EDs, the strategy renormalizes,
    and the controller re-balances the survivors."""
    if node is None:
        safe = _safe_failure_victims(topo)
        if not safe:
            raise RuntimeError(
                "no stage-1 replica can fail without stranding an offloader; "
                "use elastic_remesh first"
            )
        busy = busiest_replica(topo, p)
        node = busy if busy in safe else safe[0]
    return Scenario(
        name="failure", events=[ScenarioEvent(t0, "fail", node=int(node))]
    )


NAMES = ("burst", "slowdown", "link", "failure")


def get_scenario(
    name: str,
    topo: Topology,
    p: np.ndarray | None = None,
    horizon: float = 5.0,
    seed: int = 0,
    **kw,
) -> Scenario:
    """Build a named scenario with its disruption window anchored to
    ``horizon``.  Mode changes persist per slot exactly as the paper's
    dynamic regime re-randomizes them: the slowdown's computing mode holds
    through the measured window (recovery lands at 2x horizon) and the
    failure at 0.25 is permanent; the burst spans [0.2, 0.9) and the link
    degradation [0.25, 0.7)."""
    t0, t1 = 0.25 * horizon, 0.7 * horizon
    if name == "burst":
        return arrival_burst(topo, 0.2 * horizon, 0.9 * horizon, p=p, seed=seed, **kw)
    if name == "slowdown":
        return node_slowdown(topo, 0.2 * horizon, 2.0 * horizon, p=p, **kw)
    if name == "link":
        return link_degradation(topo, t0, t1, p=p, **kw)
    if name == "failure":
        return node_failure(topo, t0, p=p, **kw)
    raise ValueError(f"unknown scenario {name!r}; choose from {NAMES}")
