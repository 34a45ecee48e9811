"""Closed-loop reconfiguration controller for the serving engine.

The counterpart of ``repro.control.controller``, on the port's
``core.dto_ee`` (float32 torch on the CPU).

At every slot boundary (``interval`` simulated seconds) the controller:

  1. renders the telemetry's **effective topology** — the optimizer's view
     with measured capacities / arrival rates / link rates substituted in;
  2. applies **hysteresis**: if the measured environment drifted less than
     ``drift_deadband`` (relative) since the last accepted plan, nothing
     happens — re-optimizing a quiet environment only thrashes routing;
  3. **warm-starts** a DTO-EE configuration phase (Algorithm 3) from the
     engine's live state against the effective topology, off to the side —
     the serving data plane keeps routing on the live ``p``/thresholds;
  4. returns a :class:`ReconfigPlan` carrying the phase result plus its
     **decision time** (``rounds x local_comm_s``, the paper's §4.1 cost of
     a distributed configuration phase).  The engine installs the plan only
     after that much simulated time has passed, so slow reconfigurations
     route on stale strategies exactly as the paper charges them.

``install`` swaps topology view, round program, offloading strategy and
thresholds into the engine atomically (between batches — the engine applies
it at an event boundary), and rejects plans whose edge structure was
invalidated by a node failure that landed mid-decision.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import dto_ee
from repro_torch.core.types import Topology

from repro_torch.control.telemetry import Telemetry

#: paper §4.1: one local RUR/RUS exchange costs ~2 ms
LOCAL_COMM_S = 0.002


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    interval: float = 1.0  # simulated seconds between reconfiguration ticks
    rounds: int = 30  # DTO-EE rounds per mid-serve configuration phase
    local_comm_s: float = LOCAL_COMM_S
    adapt_thresholds: bool = True
    warm_start: bool = True  # False: re-solve each tick from a cold state
    # hysteresis: skip planning entirely below this relative environment
    # drift, and skip the install when the new strategy barely moved
    drift_deadband: float = 0.05
    p_deadband: float = 1e-3

    @property
    def decision_time(self) -> float:
        return self.rounds * self.local_comm_s


@dataclasses.dataclass
class ReconfigPlan:
    """A planned (not yet installed) configuration update."""

    state: dto_ee.DtoState
    topo: Topology  # effective topology the phase optimized against
    round_step: Callable
    decision_time: float
    t_planned: float
    p_l1: float  # mean |p_new - p_live| at plan time
    drift: float  # relative environment drift that triggered the plan


def _rel_drift(ref: Topology, eff: Topology) -> float:
    """Max relative change of any measured quantity between two same-shaped
    topologies (the hysteresis trigger)."""
    es = ref.node_stage > 0
    mu_ref = np.maximum(ref.mu[es], 1e-12)
    d_mu = float(np.max(np.abs(eff.mu[es] - ref.mu[es]) / mu_ref)) if es.any() else 0.0
    phi_ref = max(float(ref.phi_ext.sum()), 1e-12)
    d_phi = abs(float(eff.phi_ext.sum()) - float(ref.phi_ext.sum())) / phi_ref
    rate_ref = np.maximum(ref.edge_rate, 1e-12)
    d_rate = float(np.max(np.abs(eff.edge_rate - ref.edge_rate) / rate_ref))
    return max(d_mu, d_phi, d_rate)


class ReconfigController:
    """Drives closed-loop DTO-EE over a live ``CollaborativeEngine.serve``.

    Pass it (with its telemetry) to ``serve(controller=...)``; the engine
    calls :meth:`plan` at tick events and :meth:`install` once the plan's
    decision time has elapsed.
    """

    def __init__(self, telemetry: Telemetry, config: ControllerConfig | None = None):
        self.telemetry = telemetry
        self.config = config or ControllerConfig()
        if self.config.interval <= 0:
            raise ValueError("controller interval must be positive")
        self._ref_topo: Topology | None = None  # environment at last accept
        self.log: list[dict] = []

    @property
    def interval(self) -> float:
        return self.config.interval

    def plan(self, engine, now: float) -> ReconfigPlan | None:
        cfg = self.config
        view = engine.topo
        eff = self.telemetry.effective_topology(view, now)
        ref = self._ref_topo if self._ref_topo is not None else view
        if ref.num_edges != eff.num_edges:
            ref = view  # a failure rewrote the structure since the last plan
        drift = _rel_drift(ref, eff)
        if drift < cfg.drift_deadband:
            self.log.append(
                {"t": float(now), "action": "skip", "drift": drift}
            )
            return None
        hyper = dataclasses.replace(engine.hyper, rounds=cfg.rounds)
        round_step = dto_ee.make_round_step(eff, engine.profile, hyper)
        state0 = dto_ee.clone_state(engine.state) if cfg.warm_start else None
        res = dto_ee.run_configuration_phase(
            eff,
            engine.profile,
            engine.exit_profile,
            hyper,
            state=state0,
            adapt_thresholds=cfg.adapt_thresholds,
            round_step=round_step,
        )
        p_new = res.state.carry.p.numpy().astype(np.float64)
        p_l1 = float(np.mean(np.abs(p_new - engine.p)))
        thr_moved = not np.array_equal(res.state.thresholds, engine.state.thresholds)
        if p_l1 < cfg.p_deadband and not thr_moved:
            # the environment drifted but the optimum barely moved: installing
            # would only churn the routing CDF
            self.log.append(
                {"t": float(now), "action": "hold", "drift": drift, "p_l1": p_l1}
            )
            self._ref_topo = eff
            return None
        self.log.append(
            {
                "t": float(now),
                "action": "plan",
                "drift": drift,
                "p_l1": p_l1,
                "thresholds_moved": thr_moved,
                "decision_time": cfg.decision_time,
            }
        )
        return ReconfigPlan(
            state=res.state,
            topo=eff,
            round_step=round_step,
            decision_time=cfg.decision_time,
            t_planned=float(now),
            p_l1=p_l1,
            drift=drift,
        )

    def install(self, engine, plan: ReconfigPlan) -> bool:
        """Atomically swap the plan into the engine; False if a structure
        change (node failure) landed between plan and install."""
        if plan.topo.num_edges != engine.topo.num_edges:
            self.log.append(
                {"t": plan.t_planned, "action": "stale", "reason": "edge set changed"}
            )
            return False
        engine.topo = plan.topo
        engine.state = plan.state
        engine._round_step = plan.round_step
        self._ref_topo = plan.topo
        self.log.append(
            {
                "t": plan.t_planned + plan.decision_time,
                "action": "install",
                "p_l1": plan.p_l1,
            }
        )
        return True
