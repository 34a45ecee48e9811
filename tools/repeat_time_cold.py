"""How often a ``chip_smoke.time_cold`` reading comes out off, on one GPU.

    python3 tools/repeat_time_cold.py [--readings 24]

Times the flash kernel and SDPA in turns at ``chip_smoke.py``'s two B 8
prefill shapes, ``--readings`` times each, every reading with its launches'
spread and the overwrites its profile recorded (``chip_smoke.launch_summary``).
Prints each reading more than 25% off the median of its kind in full, then
per kind the median, the range and the number of such readings.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--readings", type=int, default=24)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("repeat_time_cold: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}", flush=True)
    for label, B, S, hq, kvh, hd in chip_smoke.FLASH_SHAPES[:2]:
        q, k, v = (torch.randn((B, S, h, hd), generator=gen, device=dev).bfloat16()
                   for h in (hq, kvh, kvh))
        kinds = {
            "kernel": lambda: kflash.flash_attention(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True),
        }
        readings = {kind: [] for kind in kinds}
        for _ in range(args.readings):
            for kind, fn in kinds.items():
                st = {}
                readings[kind].append((chip_smoke.time_cold(fn, 100, flush, stats=st), st))
        print(f"flash {label} (B {B}, S {S}, {hq}/{kvh} heads of {hd}):", flush=True)
        for kind, rs in readings.items():
            ms = np.array([m for m, _ in rs])
            med = float(np.median(ms))
            off = [(i, m, st) for i, (m, st) in enumerate(rs) if abs(m - med) > 0.25 * med]
            for i, m, st in off:
                print(f"  {kind} reading {i}: {m:.5f} ms: {chip_smoke.launch_summary(st)}")
            print(f"  {kind}: median {med:.5f} ms over {len(rs)} readings (min {ms.min():.5f}, max "
                  f"{ms.max():.5f}); {len(off)} more than 25% off", flush=True)
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")


if __name__ == "__main__":
    main()
