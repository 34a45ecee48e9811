"""Fault tolerance + elastic scaling demo on the PyTorch port: the steps,
configs, seeds and printed lines of ``examples/failover_elastic.py``,
through ``repro_torch`` alone.

    PYTHONPATH=src python examples/torch_failover_elastic.py [--device cpu]

1. Optimize offloading for a healthy network.
2. Kill the most-loaded stage-2 replica -> traffic renormalizes instantly
   (no global coordination), DTO-EE rounds re-balance the survivors.
3. Scale the bottleneck stage out by two replicas (elastic re-mesh,
   warm-started strategy) -> delay recovers below the healthy baseline.
4. Train-side: checkpoint, "crash", restore — bit-exact resume.

Steps 1-3 are the control plane and the simulator, on the host; step 4
trains on ``--device`` (default ``cuda``, which raises where there is no
card; ``--device cpu`` runs it on the CPU).
"""
import argparse
import tempfile

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config
from repro_torch.core import dto_ee, queueing, simulator
from repro_torch.core.thresholds import synthetic_validation
from repro_torch.core.topology import build_edge_network
from repro_torch.core.types import RESNET101_PROFILE, DtoHyperParams
from repro_torch.data import DataConfig, token_stream
from repro_torch.models import model as model_lib
from repro_torch.runtime import CheckpointManager, elastic_remesh, handle_failure
from repro_torch.serving.engine import resolve_device
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training import optimizer as opt_lib

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
device = resolve_device(args.device)
if device.type == "cpu":
    torch.set_num_threads(1)  # bf16 matmuls at these widths: one thread is fastest

profile = RESNET101_PROFILE
hyper = DtoHyperParams()
topo = build_edge_network(seed=0, profile=profile, arrival_rate_scale=3.0)
ep = synthetic_validation(seed=1, profile=profile)


def measure(topo, p, thr, label):
    sim = simulator.simulate_slot(topo, profile, ep, np.asarray(p), thr, seed=7)
    print(f"{label:28s} delay {sim.mean_delay*1e3:7.1f}ms  "
          f"completed {sim.completed}/{sim.generated}")
    return sim


# ---- 1. healthy -------------------------------------------------------------
res = dto_ee.solve(topo, profile, ep, hyper)
state = res.state
measure(topo, state.carry.p, state.thresholds, "healthy (DTO-EE)")

# ---- 2. failure -------------------------------------------------------------
stage2 = topo.nodes_at_stage(2)
I_node = torch.as_tensor(np.asarray(state.stage_remaining), dtype=torch.float32)[
    torch.as_tensor(topo.node_stage)]
phi, lam = queueing.steady_state_flows(state.carry.p, topo, profile, I_node)
victim = int(stage2[np.argmax(np.asarray(lam)[stage2])])
print(f"\nkilling stage-2 replica node {victim} "
      f"(load {float(lam[victim]):.1f}/{topo.mu[victim]:.0f} GFLOP/s)")
topo2, p2 = handle_failure(topo, np.asarray(state.carry.p), victim)
measure(topo2, p2, state.thresholds, "after failure (renormalized)")

res2 = dto_ee.solve(topo2, profile, ep, hyper, adapt_thresholds=False)
measure(topo2, res2.state.carry.p, state.thresholds, "after DTO-EE re-balance")

# ---- 3. elastic scale-out ----------------------------------------------------
topo3, p3 = elastic_remesh(topo2, np.asarray(res2.state.carry.p), stage=2,
                           add_replicas=2, mu_new=150.0)
res3 = dto_ee.solve(topo3, profile, ep, hyper, adapt_thresholds=False)
measure(topo3, res3.state.carry.p, state.thresholds, "after scale-out (+2 replicas)")

# ---- 4. checkpoint/restart ---------------------------------------------------
print("\ntrain-side crash/restore:")
cfg = get_config("stablelm-1.6b").reduced(vocab_size=256)
params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                               master=True)
opt = opt_lib.init_opt_state(params)
step_fn = make_train_step(cfg, AdamWConfig(total_steps=20))
stream = token_stream(cfg, DataConfig(batch_size=4, seq_len=64), device=device)
with tempfile.TemporaryDirectory() as d:
    ckpt = CheckpointManager(d)
    for step in range(6):
        params, opt, m = step_fn(params, opt, next(stream))
        if step == 2:
            ckpt.save(3, (params, opt))
    # "crash": rebuild from disk and replay steps 3..5
    (params_r, opt_r), manifest = ckpt.restore((params, opt))
    stream_r = token_stream(cfg, DataConfig(batch_size=4, seq_len=64), start_step=3,
                            device=device)
    for step in range(3, 6):
        params_r, opt_r, m = step_fn(params_r, opt_r, next(stream_r))
    diff = max(
        float((a - b).abs().max())
        for a, b in zip(tree_leaves(params), tree_leaves(params_r))
    )
    print(f"restored-replay max param divergence: {diff:.2e} (bit-exact resume)")
