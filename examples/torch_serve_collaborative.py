"""Collaborative inference with DTO-EE vs. static baselines on the PyTorch
port — the paper's headline experiment, the steps, configs, seeds and
printed lines of ``examples/serve_collaborative.py``, through
``repro_torch`` alone.

    PYTHONPATH=src python examples/torch_serve_collaborative.py [--device cpu]

Deploys the ResNet101 profile (paper Table 2) across a heterogeneous edge
network, optimizes (P, C) with DTO-EE, and measures mean response delay +
accuracy in the discrete-event simulator against CF / BF / NGTO / GA —
each baseline with its own adapted thresholds, as in §4.1.  The control
plane and the simulator run on the host whatever the device; ``--device``
(default ``cuda``) is checked all the same, as in the other examples.
"""
import argparse

import numpy as np

from repro_torch.core import baselines, dto_ee, simulator
from repro_torch.core.thresholds import synthetic_validation
from repro_torch.core.topology import build_edge_network
from repro_torch.core.types import RESNET101_PROFILE, DtoHyperParams
from repro_torch.serving.engine import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
resolve_device(ap.parse_args().device)

profile = RESNET101_PROFILE
hyper = DtoHyperParams()
topo = build_edge_network(seed=0, profile=profile, arrival_rate_scale=3.0)
exit_profile = synthetic_validation(seed=1, profile=profile)

print(f"{len(topo.nodes_at_stage(0))} EDs, stages "
      f"{[len(topo.nodes_at_stage(h)) for h in range(1, profile.num_stages + 1)]}, "
      f"arrival {topo.phi_ext.sum():.1f} tasks/s")

# ---- DTO-EE ---------------------------------------------------------------
res = dto_ee.solve(topo, profile, exit_profile, hyper)
state = res.state
rows = [("DTO-EE", np.asarray(state.carry.p), state.thresholds)]

# ---- baselines (each adapts its own thresholds, paper §4.1) ----------------
for name, p in [
    ("CF", baselines.computing_first(topo)),
    ("BF", baselines.bandwidth_first(topo)),
]:
    thr, _, _ = baselines.adapt_thresholds_for_strategy(
        topo, profile, exit_profile, p, hyper
    )
    rows.append((name, np.asarray(p), thr))

thr0 = np.full(exit_profile.num_early_branches, 0.8)
sr0 = exit_profile.evaluate(thr0).stage_remaining
p_ngto, sweeps = baselines.ngto(topo, profile, sr0)
thr, _, _ = baselines.adapt_thresholds_for_strategy(
    topo, profile, exit_profile, p_ngto, hyper
)
rows.append(("NGTO", np.asarray(p_ngto), thr))

ga = baselines.genetic_paths(topo, profile, sr0, seed=3)
thr, _, _ = baselines.adapt_thresholds_for_strategy(
    topo, profile, exit_profile, ga.p, hyper
)
rows.append(("GA", np.asarray(ga.p), thr))

# ---- measure ----------------------------------------------------------------
print(f"{'algo':8s} {'delay ms':>9s} {'accuracy':>9s} {'p95 ms':>8s}")
results = {}
for name, p, thr in rows:
    sim = simulator.simulate_slot(
        topo, profile, exit_profile, p, thr, duration=5.0, seed=42
    )
    results[name] = sim
    print(f"{name:8s} {sim.mean_delay*1e3:9.1f} {sim.accuracy:9.4f} "
          f"{sim.p95_delay*1e3:8.1f}")

best_baseline = min(v.mean_delay for k, v in results.items() if k != "DTO-EE")
worst_baseline = max(v.mean_delay for k, v in results.items() if k != "DTO-EE")
d = results["DTO-EE"].mean_delay
print(f"\nDTO-EE delay reduction: {(1 - d / best_baseline) * 100:.0f}% vs best "
      f"baseline, {(1 - d / worst_baseline) * 100:.0f}% vs worst (paper: 21-41%)")
