"""Quickstart on the PyTorch port: train a tiny staged model, then serve it
collaboratively.  The steps, configs, seeds and printed lines of
``examples/quickstart.py``, through ``repro_torch`` alone.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--steps 60]

  1. build a reduced architecture config (same structure as qwen2.5-32b)
  2. train it for ``--steps`` steps (60) with the deep-supervision loss
  3. deploy it across a small edge topology
  4. run DTO-EE configuration rounds and serve a Poisson request stream,
     watching early exits appear as confidence grows

``--device`` defaults to ``cuda`` (the kernels on the card) and raises where
there is no card; ``--device cpu`` runs the plain versions on the CPU.  The
weights are random from seed 0 (the port's generator, so the numbers differ
from the JAX example's).
"""
import argparse

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs import get_config
from repro_torch.core.profiles import profile_from_arch
from repro_torch.core.thresholds import synthetic_validation
from repro_torch.core.topology import NetworkSpec, build_edge_network
from repro_torch.core.types import DtoHyperParams
from repro_torch.data import DataConfig, token_stream
from repro_torch.models import model as model_lib
from repro_torch.serving import CollaborativeEngine
from repro_torch.serving.engine import resolve_device
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training import optimizer as opt_lib

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--steps", type=int, default=60)
args = ap.parse_args()
device = resolve_device(args.device)
if device.type == "cpu":
    torch.set_num_threads(1)  # bf16 matmuls at these widths: one thread is fastest

# ---- 1. config ------------------------------------------------------------
cfg = get_config("qwen2.5-32b").reduced(vocab_size=256)
print(f"arch: {cfg.name} | {cfg.num_layers}L d={cfg.d_model} "
      f"stages={cfg.num_stages} exits={cfg.exit_stages}")

# ---- 2. train ---------------------------------------------------------------
steps = args.steps
params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                               master=True)
opt_state = opt_lib.init_opt_state(params)
step_fn = make_train_step(cfg, AdamWConfig(learning_rate=1e-3, total_steps=60))
stream = token_stream(cfg, DataConfig(batch_size=8, seq_len=64, seed=0), device=device)
for step in range(steps):
    params, opt_state, metrics = step_fn(params, opt_state, next(stream))
    if step % 20 == 0 or step == steps - 1:
        print(f"train step {step:3d}  loss {float(metrics['loss']):.3f}  "
              f"exit2 {float(metrics.get('exit_2_loss', 0)):.3f}")

# ---- 3. deploy --------------------------------------------------------------
# serving weights: the f32 masters' matrices in bf16, as the kernels take them
params = tree_map(lambda p: p.to(torch.bfloat16) if p.ndim >= 2 else p, params)
profile = profile_from_arch(cfg)
topo = build_edge_network(
    seed=0, profile=profile, spec=NetworkSpec(num_eds=6, es_per_stage=(2, 3))
)
exit_profile = synthetic_validation(seed=1, profile=profile)
engine = CollaborativeEngine(
    params, cfg, topo, profile, exit_profile,
    DtoHyperParams(rounds=30), seed=0, device=device,
)

# ---- 4. serve ---------------------------------------------------------------
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, size=24).astype(np.int32) for _ in range(16)]
for slot in range(2):
    engine.configuration_phase()
    stats = engine.serve(prompts, duration=2.0)
    s = stats.summary()
    print(f"slot {slot}: completed {s['num_completed']}  "
          f"mean delay {s['mean_delay']*1e3:.1f}ms  exits {s['exit_histogram']}  "
          f"thresholds {np.round(engine.thresholds, 2)}")
print("quickstart OK")
