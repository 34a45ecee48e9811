"""Time two builds of the dense flash-decode kernel side by side on one GPU.

    python3 tools/ab_decode_attention.py BASELINE_CSRC_DIR [--rounds 3]

Builds ``decode_attention.cu`` from ``BASELINE_CSRC_DIR`` (for example the
``src/repro_torch/kernels/csrc`` of an earlier commit, unpacked with ``git
archive``) and from this checkout, with the port's nvcc flags, loads both
through their C entry point, checks that they give bitwise equal outputs at
stablelm-1.6b's serve shapes, and times them in turns (baseline, current,
current, baseline per round) with ``chip_smoke.time_cold``: profiler device
time, cold L2.  Prints the card's name and power limit beside the times.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

# stablelm-1.6b at the serve's shapes (chip_smoke.py): 8 rows, 32 heads of 64,
# the first batch halfway through its generation
B, S, HEADS, HD = 8, 182, 32, 64
LENGTHS = [68, 87, 88, 55, 112, 70, 60, 106]


def load(csrc: Path, out_dir: Path, tag: str):
    out = out_dir / f"libdecode_attention_{tag}.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                          str(csrc / "decode_attention.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(out)).decode_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline_csrc", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_decode_attention: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, HEADS, HD), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, HEADS, HD), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, HEADS, HD), generator=gen, device=dev).bfloat16()
    ln = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"baseline": load(args.baseline_csrc, Path(tmp), "baseline"),
               "current": load(build.CSRC, Path(tmp), "current")}

        def call(fn):
            out = torch.empty_like(q)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(), out.data_ptr(),
                     B, S, HEADS, 1, HD, float(1.0 / math.sqrt(HD)),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out

        same = torch.equal(call(fns["baseline"]), call(fns["current"]))
        times = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name in ("baseline", "current", "current", "baseline"):
                times[name].append(chip_smoke.time_cold(lambda: call(fns[name]), 200, flush))
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    print(f"decode_attention B={B} S={S} heads={HEADS} hd={HD} lengths {LENGTHS}; outputs bitwise "
          f"equal: {same}")
    for name, ts in times.items():
        print(f"  {name}: ms per launch {' '.join(f'{t:.5f}' for t in ts)}; min {min(ts):.5f}")
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
