"""Online control plane: closed-loop DTO-EE over the live serving engine
(the counterpart of ``repro.control``).

``telemetry``   — sliding-window estimators fed by the engine's streaming
                  hooks (arrivals, batch service times, transfers, exits).
``controller``  — slot-boundary reconfiguration: effective topology from
                  telemetry -> warm-started DTO-EE phase -> atomic install
                  after the decision time, with hysteresis.
``scenarios``   — composable live-environment perturbations (bursts,
                  slowdowns, link degradation, node failure) driving the
                  paper's Figs. 7–8 dynamic regime against the real engine.
"""
from repro_torch.control.controller import (
    LOCAL_COMM_S,
    ControllerConfig,
    ReconfigController,
    ReconfigPlan,
)
from repro_torch.control.scenarios import (
    NAMES as SCENARIO_NAMES,
    Scenario,
    ScenarioEvent,
    arrival_burst,
    busiest_replica,
    get_scenario,
    link_degradation,
    node_failure,
    node_slowdown,
)
from repro_torch.control.telemetry import Telemetry, TelemetryConfig

__all__ = [
    "LOCAL_COMM_S", "ControllerConfig", "ReconfigController", "ReconfigPlan",
    "SCENARIO_NAMES", "Scenario", "ScenarioEvent", "arrival_burst",
    "busiest_replica", "get_scenario", "link_degradation", "node_failure",
    "node_slowdown", "Telemetry", "TelemetryConfig",
]
