"""Time the exit-head kernel at every LM head of the registry on one GPU,
against its library yardstick and, optionally, an earlier build.

    python3 tools/ab_exit_head.py [BASELINE_CSRC_DIR] [--rounds 2] [--batches 1 8 32]
                                  [--variants unit-8 l2-256] [--full-grid]

At each of the five registry LM heads (random bf16 w of the head's shape,
made from a seed) and each batch size: the kernel of this checkout (through
the port's wrapper), cuBLAS plus reductions (bf16 ``matmul`` then max,
logsumexp and argmax in f32) and, when ``BASELINE_CSRC_DIR`` is given, the
baseline build of ``exit_confidence.cu`` from that directory (for example
the ``src/repro_torch/kernels/csrc`` of commit d927fbd unpacked with ``git
archive``; its C entry must have that commit's signature: one call for every
B, partials per 256-column tile), all timed in turns (baseline, current,
library, library, current, baseline per round) with ``chip_smoke.time_cold``
(profiler device time, cold L2).  Each time is printed beside the bytes
bound (one read of w at 3.35 TB/s) and its share of it.  Before timing, both
builds are held to the plain version at B 8 on inputs with a clear top-1
margin (``chip_smoke.conf_close``, exact argmax).  Then the host's cost of
one call (200 calls enqueued, then one synchronize) for both builds at
stablelm-1.6b's head, B 8.

``--variants`` adds builds of this checkout's ``exit_confidence.cu`` with
text replacements (``VARIANTS``: the unit of the vocab split, whose edges
are multiples of it; the L2 promotion of w's tensor map), each called
through the same wrapper and timed in the same turns.  ``--full-grid`` adds
the current kernel on one CTA per SM, in place of ``grid_ctas``' count.

Prints the card's name and power limit; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import exit_confidence as kexit  # noqa: E402
from repro_torch.roofline.constants import HBM_BW  # noqa: E402

ARCHS = ("stablelm-1.6b", "glm4-9b", "deepseek-v2-lite-16b", "internlm2-20b", "qwen2.5-32b")
# name -> [(text in csrc/exit_confidence.cu, its replacement)]
_W_PROMO = "CU_TENSOR_MAP_L2_PROMOTION_L2_128B)) return nullptr;"
_UNIT = "constexpr int UNIT = 64;"
VARIANTS = {
    **{f"unit-{u}": [(_UNIT, f"constexpr int UNIT = {u};")] for u in (8, 16, 32, 128, 256)},
    **{f"l2-{name}": [(_W_PROMO, f"CU_TENSOR_MAP_L2_PROMOTION_{enum})) return nullptr;")]
       for name, enum in (("none", "NONE"), ("64", "L2_64B"), ("256", "L2_256B"))},
}
VARIANTS["unit-8-l2-256"] = VARIANTS["unit-8"] + VARIANTS["l2-256"]


def build_variant(name: str, tmp: Path):
    """This checkout's exit kernel with ``VARIANTS[name]`` applied, loaded
    and typed as the wrapper types its own."""
    src = (build.CSRC / "exit_confidence.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source exactly once")
        src = src.replace(old, new)
    d = tmp / name
    d.mkdir()
    for path in build.CSRC.glob("*.cuh"):
        (d / path.name).write_text(path.read_text())
    (d / "exit_confidence.cu").write_text(src)
    out = d / "lib.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(d / "exit_confidence.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(out)).exit_confidence_bf16
    fn.argtypes = kexit._lib().argtypes
    fn.restype = ctypes.c_int
    return fn


class Baseline:
    """An earlier build of the exit head, called with its own C signature
    (h, w, part_m, part_l, part_i, conf, idx, B, d, V, stream; partials
    [B, ceil(V / 256)])."""

    def __init__(self, csrc: Path, tmp: Path):
        out = tmp / "libexit_baseline.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(csrc / "exit_confidence.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the baseline:\n{proc.stdout}{proc.stderr}")
        self.fn = ctypes.CDLL(str(out)).exit_confidence_bf16
        self.fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, h, w):
        B, d = h.shape
        V = w.shape[1]
        nt = -(-V // 256)
        part = torch.empty((3, B, nt), dtype=torch.float32, device=h.device)
        conf = torch.empty((B,), dtype=torch.float32, device=h.device)
        idx = torch.empty((B,), dtype=torch.int32, device=h.device)
        err = self.fn(h.data_ptr(), w.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                      part[2].data_ptr(), conf.data_ptr(), idx.data_ptr(), B, d, V,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError {err}")
        return conf, idx


def margin_inputs(gen, dev, B, d, V):
    """chip_smoke's head inputs: logits ~ N(0, 1), row b's target raised by 8."""
    h = torch.randn((B, d), generator=gen, device=dev)
    w = torch.randn((d, V), generator=gen, device=dev) / math.sqrt(d)
    tgt = torch.randperm(V, generator=gen, device=dev)[:B]
    w[:, tgt] += 8.0 * (h / h.norm(dim=1, keepdim=True) ** 2).T
    return h.bfloat16(), w.bfloat16()


def host_us(fn, n=200) -> float:
    """Host microseconds per call over ``n`` enqueued calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("baseline_csrc", type=Path, nargs="?")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    parser.add_argument("--variants", nargs="+", default=[], choices=sorted(VARIANTS))
    parser.add_argument("--full-grid", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_exit_head: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = chip_smoke.L2Flush(dev)
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        base = Baseline(args.baseline_csrc, Path(tmp)) if args.baseline_csrc else None
        build.build_all(["exit_confidence"])
        libs = {"": None, **{v: build_variant(v, Path(tmp)) for v in args.variants}}
        own_lib, own_grid = kexit._lib, kexit.grid_ctas
        for name, (secs, log) in build.build_reports.items():
            for kernel, used in chip_smoke.ptxas_lines(log):
                print(f"  {kernel}: {used}")
        failed = []
        for arch in ARCHS:
            cfg = get_config(arch)
            d, V = cfg.d_model, cfg.vocab_size
            h, w = margin_inputs(gen, dev, 8, d, V)
            cr, ir = ref.exit_confidence_ref(h, w)
            builds = {"current": kexit.exit_confidence, **({"baseline": base} if base else {})}
            for tag, fn in builds.items():
                c, i = fn(h, w)
                ok, err, rel = chip_smoke.conf_close(c, cr)
                ok = ok and torch.equal(i, ir)
                print(f"{arch} d={d} V={V} B=8 {tag}: {'ok' if ok else 'FAIL'} conf max|err| {err:.3g}, "
                      f"max rel err {rel:.3g}, argmax equal {torch.equal(i, ir)}", flush=True)
                if not ok:
                    failed.append(f"{arch} {tag}")
            w = torch.randn((d, V), generator=gen, device=dev).bfloat16()
            for B in args.batches:
                h = torch.randn((B, d), generator=gen, device=dev).bfloat16()

                def library():
                    logits = torch.matmul(h, w).float()
                    return logits.max(-1).values, torch.logsumexp(logits, -1), logits.argmax(-1)

                def at(lib):
                    def run():
                        if lib is not None:
                            kexit._lib = lambda: lib
                        try:
                            return kexit.exit_confidence(h, w)
                        finally:
                            kexit._lib = own_lib
                    return run

                currents = {f"current{' ' + v if v else ''}": at(lib) for v, lib in libs.items()}
                if args.full_grid:
                    def full_grid():
                        kexit.grid_ctas = lambda V_, n_sm: n_sm
                        try:
                            return kexit.exit_confidence(h, w)
                        finally:
                            kexit.grid_ctas = own_grid
                    currents["current (one CTA per SM)"] = full_grid
                kinds = {**currents, "library": library}
                if base:
                    kinds["baseline"] = lambda: base(h, w)
                order = (["baseline"] if base else []) + [*currents, "library", "library",
                                                          *reversed(currents)] + (
                    ["baseline"] if base else [])
                ms = {k: [] for k in kinds}
                for _ in range(args.rounds):
                    for k in order:
                        ms[k].append(chip_smoke.time_cold(kinds[k], 30, flush))
                bound = (d * V * 2 + B * d * 2 + B * 8) / HBM_BW * 1e3
                med = {k: float(np.median(v)) for k, v in ms.items()}
                print(f"{arch} d={d} V={V} B={B}: bound {bound:.4f} ms; " + "; ".join(
                    f"{k} {med[k]:.4f} ms ({bound / med[k]:.1%} of the bound; readings "
                    f"{' '.join(f'{t:.4f}' for t in ms[k])})" for k in kinds), flush=True)
            del w, h
        d, V = get_config("stablelm-1.6b").d_model, get_config("stablelm-1.6b").vocab_size
        w = torch.randn((d, V), generator=gen, device=dev).bfloat16()
        h = torch.randn((8, d), generator=gen, device=dev).bfloat16()
        line = (f"host us per call at d={d} V={V} B=8 (200 enqueued): current "
                f"{host_us(lambda: kexit.exit_confidence(h, w)):.2f}")
        if base:
            line += f", baseline {host_us(lambda: base(h, w)):.2f}"
        print(line)
        print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
        if failed:
            sys.exit(f"ab_exit_head: checks failed: {failed}")


if __name__ == "__main__":
    main()
