"""Where the decode walk's time goes, on one GPU.

    python3 tools/probe_decode_walk.py

Builds variants of ``csrc/decode_attention.cu`` in a temporary directory,
each from this checkout's sources with its patches applied at the lines of
``decode_attention_core.cuh`` marked ``// PROBE: <name>`` (a marker that is
missing or not unique is an error):

  * ``current``  — the sources as they are;
  * ``empty``    — the walk returns at once: the launch's own floor;
  * ``loads``    — the K/V tiles are loaded and waited for, but no score,
                   softmax or P.V is computed: loads plus the reduction;
  * ``ring1``, ``ring3`` — ``RING`` 1 or 3 instead of 2: no prefetch, or a
    deeper ring with fewer CTAs resident;
  * ``stamps``   — the current walk, with warp 0 of each CTA recording its
    clocks at entry, when its first tile has landed, at the end of its walk
    and at its exit.

Times every variant in turns at each shape (``chip_smoke.time_cold``:
profiler device time, cold L2, median of 4 readings), then runs ``stamps``
once after the L2 overwrite and prints the spread of the CTAs' exits and
the median cycles of each part.  The variants' outputs are not checked: only
``current`` is the kernel, and ``chip_smoke.py`` gates it.
"""
from __future__ import annotations

import ctypes
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402

CORE = "decode_attention_core.cuh"
STAMP_BUFFER = 65536
# (file, marker, where, text) per variant: text goes before or after the line
# holding ``// PROBE: <marker>``, or ``(old, new)`` is replaced within it;
# marker None appends to the file
PATCHES = {
    "current": [],
    "empty": [(CORE, "entry", "after", "  return;\n")],
    "loads": [(CORE, "compute begins", "before", "#if 0\n"),
              (CORE, "compute ends", "before", "#endif\n")],
    **{f"ring{n}": [(CORE, "ring", "replace", ("RING = 2", f"RING = {n}"))] for n in (1, 3)},
    "stamps": [
        (CORE, "namespace", "after", f"__device__ unsigned long long stamps[{STAMP_BUFFER}][4];\n"),
        (CORE, "entry", "after", "  const long long c0 = clock64();\n  long long c1 = c0;\n"),
        (CORE, "compute begins", "before", "    if (i == 0) c1 = clock64();\n"),
        (CORE, "walk ends", "after", "  const long long c2 = clock64();\n"),
        (CORE, "exit", "before",
         "  if (tid == 0) {\n"
         "    unsigned long long* o = stamps[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
         f"blockIdx.z)) % {STAMP_BUFFER}];\n"
         "    unsigned long long now;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(now));\n"
         "    o[0] = now; o[1] = c1 - c0; o[2] = c2 - c1; o[3] = clock64() - c2;\n"
         "  }\n"),
        ("decode_attention.cu", None, "end",
         "\nextern \"C\" int read_stamps(void* dst, int n) {\n"
         "  return cudaMemcpyFromSymbol(dst, decode_core::stamps, (size_t)n * 4 * 8);\n}\n\n"
         "extern \"C\" int clear_stamps() {\n"
         "  void* p;\n"
         "  const cudaError_t err = cudaGetSymbolAddress(&p, decode_core::stamps);\n"
         "  return err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(decode_core::stamps));\n}\n"),
    ],
}
# (label, B, S, Hq, KVH, hd, lengths)
SHAPES = (
    ("stablelm-1.6b serve shapes, G 1", 8, 182, 32, 32, 64, [68, 87, 88, 55, 112, 70, 60, 106]),
    ("the same at B 32", 32, 182, 32, 32, 64, [68, 87, 88, 55, 112, 70, 60, 106] * 4),
    ("stablelm-1.6b heads, long cache, G 1", 8, chip_smoke.LONG_S, 32, 32, 64, chip_smoke.LONG_LENGTHS),
    ("glm4-9b serve shapes, G 16", 8, max(chip_smoke.GLM_LENGTHS) + 8, 32, 2, 128, chip_smoke.GLM_LENGTHS),
    ("glm4-9b heads, long cache, G 16", 8, chip_smoke.LONG_S, 32, 2, 128, chip_smoke.LONG_LENGTHS),
)


def patched(text: str, marker: str | None, where: str, new) -> str:
    if marker is None:
        return text + new
    lines = text.splitlines(keepends=True)
    at = [i for i, line in enumerate(lines) if line.rstrip().endswith(f"PROBE: {marker}")]
    if len(at) != 1:
        raise RuntimeError(f"{len(at)} lines marked 'PROBE: {marker}' (want 1)")
    i = at[0]
    if where == "replace":
        old, rep = new
        if old not in lines[i]:
            raise RuntimeError(f"{old!r} is not on the line marked 'PROBE: {marker}'")
        lines[i] = lines[i].replace(old, rep)
    else:
        lines.insert(i if where == "before" else i + 1, new)
    return "".join(lines)


def build_variants(tmp: Path) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name, patches in PATCHES.items():
        src = tmp / name
        shutil.copytree(build.CSRC, src)
        for file, marker, where, new in patches:
            (src / file).write_text(patched((src / file).read_text(), marker, where, new))
        out = tmp / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src / "decode_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
        fn = libs[name].decode_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_decode_walk: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = chip_smoke.L2Flush(dev)
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for label, B, S, hq, kvh, hd, lengths in SHAPES:
            q = torch.randn((B, hq, hd), generator=gen, device=dev).bfloat16()
            k = torch.randn((B, S, kvh, hd), generator=gen, device=dev).bfloat16()
            v = torch.randn((B, S, kvh, hd), generator=gen, device=dev).bfloat16()
            ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
            part_o, part_lse = kdec.split_scratch(B, S, kvh, hq // kvh, hd, dev)
            out = torch.empty_like(q)

            def call(lib):
                err = lib.decode_attention_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(), out.data_ptr(),
                    None if part_o is None else part_o.data_ptr(),
                    None if part_lse is None else part_lse.data_ptr(), None, None, B, S, kvh,
                    hq // kvh, hd,
                    kdec.SPLIT_KEYS, 1, 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            timed = [n for n in libs if n != "stamps"]
            ms = {n: [] for n in timed}
            for _ in range(2):
                for n in timed + timed[::-1]:
                    ms[n].append(chip_smoke.time_cold(lambda: call(libs[n]), 100, flush))
            print(f"{label} (B {B}, S {S}, {hq}/{kvh} heads of {hd}): " + "; ".join(
                      f"{n} {statistics.median(t):.5f}" for n, t in ms.items()) + " ms", flush=True)

            lib = libs["stamps"]
            for _ in range(3):
                if lib.clear_stamps():
                    raise RuntimeError("clear_stamps failed")
                flush()
                call(lib)
                torch.cuda.synchronize()
            n_cta = kvh * B * len(kdec.split_bounds(S))
            buf = np.zeros((min(n_cta, STAMP_BUFFER), 4), dtype=np.uint64)
            lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
            if lib.read_stamps(buf.ctypes.data, len(buf)):
                raise RuntimeError("read_stamps failed")
            ran = buf[buf[:, 0] > 0].astype(np.int64)  # CTAs of splits a row does not have exit early
            print(f"  one cold launch, {len(ran)} CTAs walked: exits spread over "
                  f"{(ran[:, 0].max() - ran[:, 0].min()) / 1e3:.3f} us; median cycles of warp 0: first tile "
                  f"landed {np.median(ran[:, 1]):.0f} (p90 {np.percentile(ran[:, 1], 90):.0f}), rest of "
                  f"its walk {np.median(ran[:, 2]):.0f}, barrier and reduction {np.median(ran[:, 3]):.0f}",
                  flush=True)
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")


if __name__ == "__main__":
    main()
