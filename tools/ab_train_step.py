"""Full-width stablelm-1.6b train steps of this checkout and of another, in
turns, on one GPU.

    python3 tools/ab_train_step.py <other src dir> [--turns otto]

``<other src dir>`` holds another checkout's ``repro_torch`` package (an
earlier commit's ``src/``, unpacked by ``git archive`` into a git-ignored
directory).  Each turn is a process of its own that imports ``repro_torch``
from one of the two trees ("t" this checkout's ``src/``, "o" the other) and
runs ``chip_smoke.py``'s train phase set-up: f32 masters from the seed,
B 8 x S 512 from the token stream, AdamW.  It takes 6 steps and a profiled
7th and prints one line: the median synchronized wall of steps 2-6, the
peak device memory, the profiled step's device busy, and the backward's
fill and add kernels (``chip_smoke.device_launches``).  The turns run in
the order ``--turns`` gives (default o, t, t, o); the card's name and power
limit are printed first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(src: str) -> None:
    sys.path[:0] = [src, str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.models import model as model_lib
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training import optimizer as opt_lib

    dev = torch.device("cuda")
    cfg = get_config("stablelm-1.6b")
    params = model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                                   master=True)
    opt_state = opt_lib.init_opt_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=cs.TRAIN_STEPS,
                                               warmup_steps=cs.TRAIN_STEPS))
    stream = token_stream(cfg, DataConfig(batch_size=cs.TRAIN_B, seq_len=cs.TRAIN_S, seed=0),
                          device=dev)
    batches = [next(stream) for _ in range(cs.TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for batch in batches[:cs.TRAIN_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # synchronizes
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    bwd: dict = {}
    names = cs.device_launches(lambda: step_fn(params, opt_state, batches[cs.TRAIN_STEPS]), bwd)
    print("RESULT " + json.dumps({
        "src": src, "median_wall_ms": float(np.median(walls[1:])) * 1e3,
        "walls_ms": [w * 1e3 for w in walls], "peak_gib": peak, "losses": losses,
        "device_busy_ms": sum(sum(v) for v in names.values()) / 1e3,
        "backward": bwd}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("other", nargs="?")
    parser.add_argument("--turns", default="otto")
    parser.add_argument("--worker")
    args = parser.parse_args()
    if args.worker:
        worker(args.worker)
        return
    if not args.other:
        parser.error("name the other checkout's src directory")
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_train_step: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)
    trees = {"t": str(ROOT / "src"), "o": str(Path(args.other).resolve())}
    for turn in args.turns:
        proc = subprocess.run([sys.executable, __file__, "--worker", trees[turn]],
                              capture_output=True, text=True, timeout=900)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
        if line is None:
            sys.exit(f"turn {turn} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        r = json.loads(line[7:])
        print(f"{turn} ({r['src']}): median wall of steps 2-{len(r['walls_ms'])} "
              f"{r['median_wall_ms']:.2f} ms (steps {[round(w, 1) for w in r['walls_ms']]}); "
              f"peak {r['peak_gib']:.3f} GiB; profiled step busy {r['device_busy_ms']:.1f} ms; "
              "backward " + "; ".join(f"{k} x{n} {ms:.2f} ms" for k, (n, ms) in
                                      r["backward"].items())
              + f"; losses {[round(x, 5) for x in r['losses']]}", flush=True)


if __name__ == "__main__":
    main()
