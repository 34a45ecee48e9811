"""End-to-end trainer: ``python -m repro_torch.launch.train --arch <id>
[--reduced] [--device cpu]``, the counterpart of ``repro.launch.train`` on
one device.

The flags are the reference's plus ``--device`` (default ``cuda``; asking
for it without a card raises).  Weights are random, drawn from ``--seed``
by a ``torch.Generator`` on the device, and kept as f32 masters.
Checkpoints are written every ``--ckpt-every`` steps and at the end, and
restored automatically on relaunch: kill the process at any step and rerun
the same command to resume, bit for bit (the batches are a function of the
step).  A non-finite loss raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, token_stream
from repro_torch.models import model as model_lib
from repro_torch.runtime import CheckpointManager
from repro_torch.serving.engine import resolve_device
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training import optimizer as opt_lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    opt_cfg = AdamWConfig(
        learning_rate=args.lr, total_steps=args.steps, warmup_steps=min(20, args.steps)
    )
    dcfg = DataConfig(batch_size=args.batch, seq_len=args.seq, seed=args.seed)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, gen, device, master=True)
    opt_state = opt_lib.init_opt_state(params)
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        (params, opt_state), manifest = ckpt.restore((params, opt_state))
        start_step = manifest["step"]
        print(f"restored checkpoint at step {start_step}")

    n_params = sum(p.numel() for p in torch.utils._pytree.tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, {args.steps} steps")

    stream = token_stream(cfg, dcfg, start_step=start_step, device=device)
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = next(stream)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = time.time() - t0
            print(
                f"step {step:5d}  loss {loss:.4f}  grad_norm {gn:.3f}  "
                f"({dt/max(step-start_step+1,1):.2f}s/step)",
                flush=True,
            )
            if not np.isfinite(loss):
                raise RuntimeError("loss diverged")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(step + 1, (params, opt_state), {"arch": cfg.name})
            print(f"checkpoint -> {path}")
    if ckpt is not None:
        ckpt.save(args.steps, (params, opt_state), {"arch": cfg.name})


if __name__ == "__main__":
    main()
