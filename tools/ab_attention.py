"""Compare two builds of the attention kernels side by side on one GPU.

    python3 tools/ab_attention.py BASELINE_CSRC_DIR [--rounds 2]

Builds ``flash_attention.cu``, ``decode_attention.cu`` and
``paged_decode_attention.cu`` from ``BASELINE_CSRC_DIR`` (for example the
``src/repro_torch/kernels/csrc`` of an earlier commit, unpacked with ``git
archive``; its C entries must have the signatures of commit a710f62: the
decode entries with the split scratch, the paged one without the view's
length) with the port's nvcc flags, one nvcc each, in parallel, and this
checkout's through the port's wrappers.  Then:

  * checks that the two builds of both decode kernels agree within the bf16
    tolerance (``chip_smoke.bf16_close``) at every (hd 32, 64, 128; G 1, 2,
    4, 8), and at every timed shape: bit for bit at G 16, within the bf16
    tolerance at G 1 and for the flash kernel;
  * times every shape of ``chip_smoke``'s attention table in turns
    (baseline, current, current, baseline per round) with
    ``chip_smoke.time_cold`` (profiler device time, cold L2): decode at
    stablelm-1.6b's serve shapes (G 1) and on a 4096-key cache at its heads
    and at glm4-9b's (G 16), dense and paged, and the flash kernel;
  * times the host's cost of one flash call (the C entry alone, 200
    enqueues) for both builds.

Prints the card's name and power limit beside the times; exits 1 if a
check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpaged  # noqa: E402

# stablelm-1.6b at the serve's shapes (chip_smoke.py): 8 rows, 32 heads of 64,
# the first batch halfway through its generation
B, S, HEADS, HD = 8, 182, 32, 64
LENGTHS = [68, 87, 88, 55, 112, 70, 60, 106]


def build_baseline(csrc: Path, out_dir: Path, names) -> dict[str, ctypes.CDLL]:
    """The baseline build of each named source, one nvcc each, in parallel."""
    procs = {}
    for name in names:
        out = out_dir / f"lib{name}_baseline.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def entry(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int):
    """The C entry ``<name>_bf16``."""
    fn = getattr(lib, f"{name}_bf16")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def checked(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


class Baseline:
    """The baseline build's three kernels, called as its wrappers did: the
    split scratch for G 16 only (16 rows), none below; the paged walk over
    all n_logical * bs positions."""

    NAMES = ("decode_attention", "paged_decode_attention", "flash_attention")

    def __init__(self, csrc: Path, tmp: Path):
        libs = build_baseline(csrc, tmp, self.NAMES)
        self.dense = entry(libs["decode_attention"], "decode_attention", 7, 7)
        self.paged = entry(libs["paged_decode_attention"], "paged_decode_attention", 8, 8)
        self.flash = entry(libs["flash_attention"], "flash_attention", 4, 8)

    @staticmethod
    def scratch(q, S, kvh):
        B_, hq, hd = q.shape
        if hq // kvh != 16:
            return None, None
        return kdec.split_scratch(B_, S, kvh, 16, hd, q.device)

    def decode(self, q, k, v, ln):
        out = torch.empty_like(q)
        B_, hq, hd = q.shape
        S_, kvh = k.shape[1], k.shape[2]
        po, pl = self.scratch(q, S_, kvh)
        checked(self.dense(q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(), out.data_ptr(),
                           ptr(po), ptr(pl), B_, S_, kvh, hq // kvh, hd, kdec.SPLIT_KEYS, 1,
                           float(1.0 / math.sqrt(hd)), stream()))
        return out

    def paged_decode(self, q, kp, vp, table, ln):
        out = torch.empty_like(q)
        B_, hq, hd = q.shape
        bs, kvh = kp.shape[1], kp.shape[2]
        po, pl = self.scratch(q, table.shape[1] * bs, kvh)
        checked(self.paged(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                           ln.data_ptr(), out.data_ptr(), ptr(po), ptr(pl), B_, table.shape[1], bs,
                           kvh, hq // kvh, hd, kdec.SPLIT_KEYS, 1, float(1.0 / math.sqrt(hd)),
                           stream()))
        return out

    def flash_attention(self, q, k, v):
        out = torch.empty_like(q)
        B_, Sq, Hq, hd = q.shape
        checked(self.flash(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B_, Sq,
                           k.shape[1], Hq, k.shape[2], hd, 1, 0, float(1.0 / math.sqrt(hd)),
                           stream()))
        return out


def paged_case(gen, dev, q, k, v, bs):
    """k, v [B, S, KVH, hd] scattered into a pool of shuffled blocks of bs."""
    B_, S_, kvh, hd = k.shape
    n_log = -(-S_ // bs)
    pad = n_log * bs - S_
    table = torch.randperm(B_ * n_log, generator=gen, device=dev).int().reshape(B_, n_log)
    pools = []
    for t in (k, v):
        full = torch.cat([t, t.new_zeros((B_, pad, kvh, hd))], 1).reshape(B_ * n_log, bs, kvh, hd)
        pool = torch.empty_like(full)
        pool[table.long().reshape(-1)] = full
        pools.append(pool)
    return pools[0], pools[1], table


def close_at_every_group(base: Baseline, dev) -> tuple[list[str], float]:
    """The (hd, G <= 8) pairs, dense or paged, at which the two builds differ
    past the bf16 tolerance, and the largest difference seen."""
    gen = torch.Generator(device=dev).manual_seed(1)
    B_, S_, KVH = 4, 300, 4
    lengths = torch.tensor([300, 17, 1, 256], dtype=torch.int32, device=dev)
    differ, worst = [], 0.0
    for hd in (32, 64, 128):
        for G in (1, 2, 4, 8):
            q = torch.randn((B_, KVH * G, hd), generator=gen, device=dev).bfloat16()
            k = torch.randn((B_, S_, KVH, hd), generator=gen, device=dev).bfloat16()
            v = torch.randn((B_, S_, KVH, hd), generator=gen, device=dev).bfloat16()
            kp, vp, table = paged_case(gen, dev, q, k, v, 16)
            for label, a, b in (
                ("dense", base.decode(q, k, v, lengths), kdec.decode_attention(q, k, v, lengths)),
                ("paged", base.paged_decode(q, kp, vp, table, lengths),
                 kpaged.paged_decode_attention(q, kp, vp, table, lengths)),
            ):
                ok, err, _ = chip_smoke.bf16_close(b, a)
                worst = max(worst, err)
                if not ok:
                    differ.append(f"{label} hd={hd} G={G}")
    return differ, worst


def host_us(fn, args, n: int = 200) -> float:
    """Host microseconds per call of a C entry (enqueue only)."""
    for _ in range(5):
        checked(fn(*args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        checked(fn(*args))
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline_csrc", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_attention: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = chip_smoke.L2Flush(dev)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        base = Baseline(args.baseline_csrc, Path(tmp))
        build.build_all(Baseline.NAMES)
        differ, worst = close_at_every_group(base, dev)
        if differ:
            failures.append("G <= 8 differs at " + ", ".join(differ))
        print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
        print(f"decode, dense and paged, at hd 32/64/128 x G 1/2/4/8: "
              f"{'within the bf16 tolerance' if not differ else 'DIFFER at ' + ', '.join(differ)} "
              f"(max|diff| {worst:.3g})", flush=True)

        # (label, baseline call, current call, bitwise expected) at each timed shape
        cases = []
        for S_, lens, hq, kvh, hd, G_label in (
                (S, LENGTHS, HEADS, HEADS, HD, "G 1, stablelm serve shapes"),
                (chip_smoke.LONG_S, chip_smoke.LONG_LENGTHS, HEADS, HEADS, HD,
                 "G 1, stablelm heads, long cache"),
                (max(chip_smoke.GLM_LENGTHS) + 8, chip_smoke.GLM_LENGTHS, 32, 2, 128,
                 "G 16, glm4-9b heads"),
                (chip_smoke.LONG_S, chip_smoke.LONG_LENGTHS, 32, 2, 128, "G 16, glm4-9b heads, long cache")):
            q, k, v = rn(B, hq, hd), rn(B, S_, kvh, hd), rn(B, S_, kvh, hd)
            ln_ = torch.tensor(lens, dtype=torch.int32, device=dev)
            kp, vp, table = paged_case(gen, dev, q, k, v, 16)
            bitwise = hq // kvh == 16  # the G 16 walk is numerically unchanged
            cases.append((f"decode {G_label} B {B} S {S_} lengths {min(lens)}..{max(lens)}",
                          lambda q=q, k=k, v=v, n=ln_: base.decode(q, k, v, n),
                          lambda q=q, k=k, v=v, n=ln_: kdec.decode_attention(q, k, v, n), bitwise))
            cases.append((f"paged decode {G_label}, bs 16",
                          lambda q=q, kp=kp, vp=vp, t=table, n=ln_: base.paged_decode(q, kp, vp, t, n),
                          lambda q=q, kp=kp, vp=vp, t=table, n=ln_: kpaged.paged_decode_attention(q, kp, vp, t, n),
                          bitwise))
        for label, B_, S_, hq, kvh, hd in chip_smoke.FLASH_SHAPES:
            q, k, v = rn(B_, S_, hq, hd), rn(B_, S_, kvh, hd), rn(B_, S_, kvh, hd)
            cases.append((f"flash {label} B {B_} S {S_} {hq}/{kvh} hd {hd}",
                          lambda q=q, k=k, v=v: base.flash_attention(q, k, v),
                          lambda q=q, k=k, v=v: kflash.flash_attention(q, k, v), False))

        times = {}
        for label, f_base, f_cur, bitwise in cases:
            a, b = f_base(), f_cur()
            if bitwise:
                ok, detail = torch.equal(a, b), "bitwise equal"
            else:
                ok, err, out = chip_smoke.bf16_close(b, a)
                detail = f"within the bf16 tolerance (max|diff| {err:.3g}, {out:.2%} outside)"
            if not ok:
                failures.append(f"{label}: not {detail}")
            print(f"{label}: {detail if ok else 'NOT ' + detail}", flush=True)
            ts = {"baseline": [], "current": []}
            for _ in range(args.rounds):
                for tag, fn in (("baseline", f_base), ("current", f_cur), ("current", f_cur),
                                ("baseline", f_base)):
                    ts[tag].append(chip_smoke.time_cold(fn, 100, flush))
            times[label] = ts
            print("  " + "; ".join(f"{tag} ms {' '.join(f'{t:.5f}' for t in v_)} (median "
                                   f"{statistics.median(v_):.5f}, min {min(v_):.5f})"
                                   for tag, v_ in ts.items()), flush=True)

        # the host's cost of one flash call, C entry alone
        q, k, v = rn(8, 104, 32, 64), rn(8, 104, 32, 64), rn(8, 104, 32, 64)
        out = torch.empty_like(q)
        c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 8, 104, 104, 32, 32, 64,
                  1, 0, 0.125, stream())
        cur = kflash._lib(torch.bfloat16)
        us = {tag: [] for tag in ("baseline", "current")}
        for _ in range(3):
            for tag, fn in (("baseline", base.flash), ("current", cur), ("current", cur),
                            ("baseline", base.flash)):
                us[tag].append(host_us(fn, c_args))
        print("flash C entry, host us per call (B 8, S 104, 32 heads of 64): " + "; ".join(
            f"{tag} {' '.join(f'{u:.2f}' for u in v_)}" for tag, v_ in us.items()))
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    if failures:
        print("FAILED: " + "; ".join(failures))
        sys.exit(1)


if __name__ == "__main__":
    main()
