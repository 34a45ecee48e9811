"""Compare two builds of the flash-decode kernels side by side on one GPU.

    python3 tools/ab_decode_attention.py BASELINE_CSRC_DIR [--rounds 3]

Builds ``decode_attention.cu`` and ``paged_decode_attention.cu`` from
``BASELINE_CSRC_DIR`` (for example the ``src/repro_torch/kernels/csrc`` of an
earlier commit, unpacked with ``git archive``) and from this checkout, with
the port's nvcc flags, and loads each through its C entry point.  Checks
that the two builds of each kernel give bitwise equal outputs at every
(hd, G) both compile for (hd 32, 64, 128; G 1, 2, 4, 8) and at stablelm-1.6b's
serve shapes, then times the dense kernel at the serve shapes in turns
(baseline, current, current, baseline per round) with
``chip_smoke.time_cold``: profiler device time, cold L2.  Prints the card's
name and power limit beside the times; exits 1 if any output differs.
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


def load(csrc: Path, out_dir: Path, tag: str, name: str, n_ptr: int, n_int: int):
    out = out_dir / f"lib{name}_{tag}.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                          str(csrc / f"{name}.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), f"{name}_bf16")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def checked(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def same_at_every_instantiation(dense, paged, dev) -> list[str]:
    """The (hd, G) pairs, dense or paged, at which the two builds differ."""
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    B, S, KVH, BS = 4, 300, 4, 16
    lengths = torch.tensor([300, 17, 1, 256], dtype=torch.int32, device=dev)
    n_log = -(-S // BS)
    table = torch.randperm(B * n_log, generator=gen, device=dev).int().reshape(B, n_log)
    differ = []
    for hd in (32, 64, 128):
        for G in (1, 2, 4, 8):
            q = torch.randn((B, KVH * G, hd), generator=gen, device=dev).bfloat16()
            k = torch.randn((B, S, KVH, hd), generator=gen, device=dev).bfloat16()
            v = torch.randn((B, S, KVH, hd), generator=gen, device=dev).bfloat16()
            kp = torch.randn((B * n_log, BS, KVH, hd), generator=gen, device=dev).bfloat16()
            vp = torch.randn((B * n_log, BS, KVH, hd), generator=gen, device=dev).bfloat16()
            outs = {}
            for tag in ("baseline", "current"):
                o_d, o_p = torch.empty_like(q), torch.empty_like(q)
                checked(dense[tag](q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                                   o_d.data_ptr(), B, S, KVH, G, hd, float(1.0 / math.sqrt(hd)),
                                   stream))
                checked(paged[tag](q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                                   lengths.data_ptr(), o_p.data_ptr(), B, n_log, BS, KVH, G, hd,
                                   float(1.0 / math.sqrt(hd)), stream))
                outs[tag] = (o_d, o_p)
            for i, kind in enumerate(("dense", "paged")):
                if not torch.equal(outs["baseline"][i], outs["current"][i]):
                    differ.append(f"{kind} hd={hd} G={G}")
    return differ


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
        roots = {"baseline": args.baseline_csrc, "current": build.CSRC}
        fns = {tag: load(root, Path(tmp), tag, "decode_attention", 5, 5)
               for tag, root in roots.items()}
        paged = {tag: load(root, Path(tmp), tag, "paged_decode_attention", 6, 6)
                 for tag, root in roots.items()}
        differ = same_at_every_instantiation(fns, paged, dev)

        def call(fn):
            out = torch.empty_like(q)
            checked(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(), out.data_ptr(),
                       B, S, HEADS, 1, HD, float(1.0 / math.sqrt(HD)),
                       torch.cuda.current_stream().cuda_stream))
            return out

        same = torch.equal(call(fns["baseline"]), call(fns["current"]))
        times = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name in ("baseline", "current", "current", "baseline"):
                times[name].append(chip_smoke.time_cold(lambda: call(fns[name]), 200, flush))
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    print(f"both builds, dense and paged, at hd 32/64/128 x G 1/2/4/8: "
          f"{'bitwise equal' if not differ else 'DIFFER at ' + ', '.join(differ)}")
    print(f"decode_attention B={B} S={S} heads={HEADS} hd={HD} lengths {LENGTHS}; outputs bitwise "
          f"equal: {same}")
    for name, ts in times.items():
        print(f"  {name}: ms per launch {' '.join(f'{t:.5f}' for t in ts)}; min {min(ts):.5f}")
    if not same or differ:
        sys.exit(1)


if __name__ == "__main__":
    main()
