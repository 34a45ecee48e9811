"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printed on its own line(s); any failure raises and the script
exits non-zero without the final result line:

  1. device — the card's name and power limit (nvidia-smi) and torch's name;
  2. build  — compiles the port's four CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (one nvcc per source, started together) and prints the
     build seconds and ptxas' registers / shared memory / spills;
  3. kernels vs their plain PyTorch versions at the serve's full-width shapes
     (stablelm-1.6b: d 2048, V 100352, 32 heads of 64; the prefill flash
     kernel also at glm4-9b's 32 query heads over 2 KV heads of 128 and at
     a 2048-token prompt with either's heads; both decode kernels also at
     glm4-9b's G 16, hd 128, at the serve's lengths, and at either's heads
     on a 4096-key cache split over the sequence; both also at qwen2.5-32b's
     G 5 and internlm2-20b's G 6, hd 128, dense and paged at block sizes 16,
     3 and 1, at the serve's lengths and on the 4096-key cache) plus edge
     cases; each gate must also reject faults planted on the same inputs;
     the paged kernel is also held bit for bit to the dense kernel on the
     gathered cache;
  4. serve  — ``CollaborativeEngine.serve`` of 32 Poisson requests through
     full-width stablelm-1.6b (24 layers, random weights from a seed),
     cached decode, 16 tokens each; the launch counts of the exit, decode
     and flash kernels over this run must be non-zero; then one full-width
     ``stage_decode`` with the kernels forced off and on, compared, and
     against the f32-score plain attention (six layers norm-wise, and each
     layer's attention output element-wise) and two planted faults; one
     full-width ``stage_prefill`` with the kernels forced off and on, and
     two planted faults; the same serve with full batches; and a short serve
     under ``torch.profiler`` (device busy share, device time by kernel);
     the first serve again with a span tracer and a metrics collector
     attached: bitwise the untraced serve's tokens, exits and delays, delays
     reconciled with the span trees, every tree closed, the Perfetto export
     valid, and each (stage, phase) row of the roofline join measured and
     within its H100 bound (utilization <= 1);
  5. paged serve — the same serve with ``cache_layout="paged"`` (block 16,
     no prefix sharing): launches the paged kernel and not the dense one and
     must give the dense serve's tokens and exits; prefill row-invariance
     measured; a shared-prefix serve with sharing on (prefix hits, every pool
     drained) against its dense twin; ``block_copy`` on a full-width pool;
  6. control loop — full-width stablelm-1.6b, 16 requests of 8 tokens,
     under a ``slowdown`` scenario (held past the serve's end) with a
     ``ReconfigController`` and threshold-aware packing: at least one
     reconfiguration, every request done, and the slowed replica's capacity
     estimate at least halfway to its slowed rate; then the ``failure``
     scenario (stateless, one token each, traced): every request done and
     every span tree closed;
  7. glm4-9b — stablelm's weights freed, full-width glm4-9b (40 layers, d
     4096, 32 query heads over 2 KV heads of 128, random weights from a seed)
     serves 16 Poisson requests, 8 tokens each, dense and then paged (block
     16): every request completes, each serve launches its kernels, and the
     paged serve's tokens and exits equal the dense serve's;
  8. times  — each kernel at the serve's shapes (device time from the
     profiler, cold L2) beside its bound, its plain version and one library
     yardstick (none computes the paged function in one call; the exit head
     and its yardstick timed in turns, medians of 4); the flash kernel also
     at glm4-9b's heads and at 2048-token prompts (at B 8 in turns with
     SDPA, medians of 4, each reading with its launches' spread), both
     decode kernels also at glm4-9b's shapes, on the 4096-key cache at
     either's heads, and at G 5 and G 6 at the serve's lengths and on the
     4096-key cache.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits 2.
"""
from __future__ import annotations

import gc
import json
import math
from collections import Counter
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

N_REQUESTS, GEN_LEN, BATCH = 32, 16, 8
BLOCK = 16  # the paged serve's block size
SEED = 0
KERNELS = ("exit_confidence", "decode_attention", "paged_decode_attention", "flash_attention")
GLM_REQUESTS, GLM_GEN = 16, 8  # the glm4-9b serves
# flash_attention's timed shapes: (label, B, S, Hq, KVH, hd)
FLASH_SHAPES = (
    ("stablelm-1.6b's first prefill batch", 8, 104, 32, 32, 64),
    ("the same batch at glm4-9b's heads", 8, 104, 32, 2, 128),
    ("one 2048-token prompt", 1, 2048, 32, 32, 64),
    ("one 2048-token prompt at glm4-9b's heads", 1, 2048, 32, 2, 128),
)
GLM_LENGTHS = [112, 105, 120, 97, 116, 110, 101, 114]  # glm4-9b decode rows
# a long cache: several splits of the decode walk per row
LONG_S = 4096
LONG_LENGTHS = [4096, 3000, 3581, 3317, 4010, 3122, 3808, 3456]
# (query heads, KV heads, head dim) of the JAX package's qwen2.5-32b (G 5)
# and internlm2-20b (G 6); the port's registry does not hold them yet
GQA_HEADS = {"qwen2.5-32b": (40, 8, 128), "internlm2-20b": (48, 8, 128)}
CTRL_REQUESTS, CTRL_GEN = 16, 8  # the control-loop serves


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_launches(run) -> dict[str, list[float]]:
    """The duration in us of each launch, by name, of the kernels, copies
    and memsets that ``run`` enqueues, as the profiler records them."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    # device-side events only: the CPU ops that launched them carry the same
    # time again
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(e.key, []).append(e.self_device_time_total)
    return out


def launch_summary(stats: dict) -> str:
    """One line of ``time_cold``'s ``stats``: per timed name, its launches
    and their min / median / max us, and the overwrites the same profile
    recorded."""
    return "; ".join(
        [f"{kernel_name(key)[:40]} x{len(d)} {min(d):.2f}/{np.median(d):.2f}/{max(d):.2f} us"
         for key, d in stats["launches"].items()] + [f"overwrites recorded x{stats['overwrites']}"])


class L2Flush:
    """A 64 MB buffer whose overwrite evicts the L2 between timed launches,
    and the names the profiler gives the overwrite's kernels, once a profile
    of the overwrites alone has recorded them."""

    def __init__(self, dev):
        self.buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        self.names: set[str] = set()

    def __call__(self) -> None:
        self.buf.zero_()


def time_cold(fn, iters: int, flush: L2Flush, tries: int = 3, stats: dict | None = None) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each after the L2 is
    overwritten (the real caller finds it cold).  The time is the sum of the
    kernels' own durations, so the host's time in the wrapper is not in it.
    The overwrites are left out by name, within the same profile: the names
    that a profile of the overwrites alone records at least ``iters / 2``
    times.  (Taking off the time of a second profile of the overwrites
    instead lets their spread between profiles into the result, and that
    spread can exceed a short kernel's whole time.)  The profiler loses a
    few launches of a profile now and then (5 of 50 of the exit head's, for
    one), so each kernel counts as its mean over the launches recorded times
    its launches per call.  A profile is taken again that recorded fewer
    than half of the overwrites or of a timed kernel's launches: one whose
    overwrites went unrecognised once counted a 64 MB overwrite into a
    reading.  Late in a long process a profile of the overwrites alone has
    recorded fewer than half of them three times in a row; the names of the
    last profile that did record them (``flush.names``, the same kernels
    every time) then stand in.  ``stats``, when given, receives each timed
    name's per-launch durations (us) and the number of overwrites the
    profile recorded (see ``launch_summary``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def both():
        for _ in range(iters):
            flush()
            fn()

    def alone():
        for _ in range(iters):
            flush()

    for _ in range(tries):
        recorded = {key: len(v) for key, v in device_launches(alone).items()}
        overwrites = {key for key, n in recorded.items() if 2 * n >= iters}
        if overwrites:
            flush.names = overwrites
            break
    else:
        if not flush.names:
            raise RuntimeError(f"the profiler lost the overwrites' device events {tries} times: "
                               f"{recorded} of {iters}")
        print(f"  info time_cold: {tries} profiles of the overwrites alone recorded {recorded} of "
              f"{iters}; the names of an earlier profile stand in", flush=True)
        overwrites = flush.names
    for _ in range(tries):
        every = device_launches(both)
        timed = {key: v for key, v in every.items() if key not in overwrites}
        n_over = sum(len(v) for key, v in every.items() if key in overwrites)
        if timed and 2 * n_over >= iters and all(2 * len(v) >= iters for v in timed.values()):
            t = sum(sum(v) / len(v) * max(1, round(len(v) / iters)) for v in timed.values())
            if t > 0:
                if stats is not None:
                    stats.update(launches=timed, overwrites=n_over)
                return t / 1e3
    raise RuntimeError(f"the profiler lost the timed function's device events {tries} times: "
                       f"{ {key: len(v) for key, v in timed.items()} } of {iters} calls, "
                       f"{n_over} overwrites")


def bf16_close(a: torch.Tensor, b: torch.Tensor) -> tuple[bool, float, float]:
    """Element-wise |a - b| <= 1e-2 + 1.6e-2 |b|: (all within, max|a - b|,
    share of elements outside)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    outside = diff > 1e-2 + 1.6e-2 * b.abs()
    return not bool(outside.any()), float(diff.max()), float(outside.float().mean())


def conf_close(c: torch.Tensor, cr: torch.Tensor) -> tuple[bool, float, float]:
    """conf within atol 1e-3 AND rtol 1e-4 (what f32 summation order gives):
    at V = 100352 the atol alone passes a head that drops dozens of vocab
    tiles.  (both within, max abs error, max relative error)."""
    err = (c - cr).abs()
    abs_err, rel_err = float(err.max()), float((err / cr.abs()).max())
    return abs_err <= 1e-3 and rel_err <= 1e-4, abs_err, rel_err


def kernel_name(raw: str) -> str:
    """The `..._kernel` name inside a mangled entry: a run of digits giving
    the length of the name that follows (a hash may precede the digits)."""
    for m in re.finditer(r"\d+", raw):
        run, end = m.group(), m.end()
        for i in range(len(run)):
            n = int(run[i:])
            name = raw[end:end + n]
            if len(name) == n and name.endswith("_kernel"):
                return name
    return raw


def ptxas_lines(log: str):
    """(kernel<template args>, registers / smem / spills) per compiled entry."""
    name, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            raw = m.group(1)
            args = ",".join(re.findall(r"Li(\d+)E", raw))
            name, spill = f"{kernel_name(raw)}<{args}>", ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            used = line.split(":", 1)[1].strip()
            yield name, f"{used}; {spill}"


def paged_prefix_prompts(rng, vocab: int, n_groups: int, group: int, n_long: int):
    """Groups of short requests sharing a 48-token prompt prefix (system-prompt
    style) plus a few long-context requests: a copy of
    ``benchmarks/decode_throughput.py``'s ``_paged_prompts``."""
    prompts = []
    for _ in range(n_groups):
        common = rng.integers(0, vocab, size=48).astype(np.int32)
        for _ in range(group):
            own = rng.integers(0, vocab, size=int(rng.integers(8, 24)))
            prompts.append(np.concatenate([common, own.astype(np.int32)]))
    for _ in range(n_long):
        prompts.append(rng.integers(0, vocab, size=384).astype(np.int32))
    return prompts


def check(name: str, ok: bool, detail: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA device",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.control import (ControllerConfig, ReconfigController, Telemetry,
                                     TelemetryConfig, busiest_replica, get_scenario, node_slowdown)
    from repro_torch.core.profiles import profile_from_arch
    from repro_torch.core.thresholds import synthetic_validation
    from repro_torch.core.topology import NetworkSpec, build_edge_network
    from repro_torch.core.types import DtoHyperParams
    from repro_torch.data import RequestConfig, poisson_requests
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import exit_confidence as kexit
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import paged_decode_attention as kpaged
    from repro_torch.models import model as model_lib
    from repro_torch.obs import (MetricsCollector, SpanTracer, chrome_trace, decompose,
                                 roofline_utilization, validate_chrome_trace)
    from repro_torch.roofline.constants import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.serving import CollaborativeEngine

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain head runs in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ----------------------------------------------------------
    phase("device")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}", flush=True)

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    build.build_all(KERNELS)
    print(f"built in {time.perf_counter() - t0:.1f} s wall (one nvcc per source, in parallel)")
    for name, (secs, log) in build.build_reports.items():
        print(f"  {name}: nvcc {secs:.1f} s")
        for kernel, used in ptxas_lines(log):
            print(f"    {kernel}: {used}")
    sys.stdout.flush()

    cfg = get_config("stablelm-1.6b")
    d, V, Hq, KVH, hd = cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rcfg = RequestConfig(mean_prompt_len=64, seed=SEED)
    prompts = [tok for _, tok in poisson_requests(cfg, rcfg, duration=60.0)][:N_REQUESTS]
    if len(prompts) != N_REQUESTS:
        raise RuntimeError(f"request stream gave {len(prompts)} prompts")
    max_len = max(len(p) for p in prompts) + GEN_LEN
    # decode-attention inputs at the serve's shapes: the first batch's rows
    # halfway through their generation
    dec_lengths = [len(p) + GEN_LEN // 2 for p in prompts[:BATCH]]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # -- 3. kernels vs plain versions ----------------------------------------
    phase("kernels vs plain versions")
    max_err = {}

    def head_inputs(B, d_, V_):
        """Logits ~ N(0, 1) with row b's target column raised by 8: a clear
        top-1 margin, and a confidence well below 1 at V = 100352."""
        h = torch.randn((B, d_), generator=gen, device=dev)
        w = torch.randn((d_, V_), generator=gen, device=dev) / math.sqrt(d_)
        tgt = torch.randperm(V_, generator=gen, device=dev)[:B]
        w[:, tgt] += 8.0 * (h / h.norm(dim=1, keepdim=True) ** 2).T
        h, w = h.bfloat16(), w.bfloat16()
        top2 = (h.double() @ w.double()).topk(2, dim=1).values
        if not bool(torch.all(top2[:, 0] - top2[:, 1] > 0.05)):
            raise RuntimeError("head inputs lack a clear top-1 margin")
        return h, w

    for B in (1, BATCH):
        h, w = head_inputs(B, d, V)
        c, i = kexit.exit_confidence(h, w)
        cr, ir = ref.exit_confidence_ref(h, w)
        ok, err, rel = conf_close(c, cr)
        check(f"exit_confidence B={B} d={d} V={V}", ok and torch.equal(i, ir),
              f"conf max|err| {err:.3g} (atol 1e-3), max rel err {rel:.3g} (rtol 1e-4; conf "
              f"{[round(x, 4) for x in cr.tolist()]}), argmax equal {torch.equal(i, ir)}")
        max_err["exit_confidence"] = max(max_err.get("exit_confidence", 0.0), err)
    # a planted fault on the same inputs: the last vocab tile (256 columns)
    # never read.  The conf gate must reject it.
    c_f, _ = kexit.exit_confidence(h, w[:, : V - 256].contiguous())
    ok, err, rel = conf_close(c_f, cr)
    check("exit_confidence gate rejects a dropped vocab tile", not ok,
          f"conf max|err| {err:.3g} (atol 1e-3 alone would {'pass' if err <= 1e-3 else 'reject'} "
          f"it), max rel err {rel:.3g} (rtol 1e-4)")
    h, w = head_inputs(13, 128, 2056)  # vocab not a multiple of the 256-column tile, two row blocks
    c, i = kexit.exit_confidence(h, w)
    cr, ir = ref.exit_confidence_ref(h, w)
    ok, err, rel = conf_close(c, cr)
    check("exit_confidence ragged V=2056 B=13", ok and torch.equal(i, ir),
          f"conf max|err| {err:.3g}, max rel err {rel:.3g}")
    wt = torch.randn((64, 3000), generator=gen, device=dev) * 0.01
    ht = torch.randn((3, 64), generator=gen, device=dev)
    col = 4.0 * ht.sum(0) / ht.sum(0).norm()
    wt[:, 40], wt[:, 41], wt[:, 2900] = col, col, col
    _, it = kexit.exit_confidence(ht.bfloat16(), wt.bfloat16())
    check("exit_confidence vocab tie", bool(torch.all(it == 40)), f"argmax {it.tolist()} (want 40)")
    hp = torch.cat([h[:3], torch.zeros((5, 128), dtype=h.dtype, device=dev)])
    c8, i8 = kexit.exit_confidence(hp, w)
    c3, i3 = kexit.exit_confidence(h[:3].contiguous(), w)
    check("exit_confidence padded rows", torch.equal(c8[:3], c3) and torch.equal(i8[:3], i3),
          "real rows unchanged by 5 zero rows")

    def dec_inputs(B, S, hq, kvh, hd_, lengths):
        q = torch.randn((B, hq, hd_), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, S, kvh, hd_), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, S, kvh, hd_), generator=gen, device=dev).bfloat16()
        return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)

    dec_cases = [
        ("serve shapes", (BATCH, max_len, Hq, KVH, hd, dec_lengths)),
        ("GQA G=4", (4, 300, 32, 8, 64, [300, 17, 1, 256])),
        ("hd=32 G=8", (2, 1000, 8, 1, 32, [999, 513])),
        ("hd=128 G=2", (3, 512, 8, 4, 128, [512, 129, 64])),
    ]
    # Each case against the plain version (bf16 scores, as the JAX reference)
    # at atol 2e-2, and element-wise at the bf16 tolerance against the
    # f32-score plain version, whose rounding is the kernel's.
    for label, (B, S, hq, kvh, hd_, lengths) in dec_cases:
        q, k, v, ln = dec_inputs(B, S, hq, kvh, hd_, lengths)
        o = kdec.decode_attention(q, k, v, ln)
        orf = ref.decode_attention_ref(q, k, v, ln)
        of32 = ref.decode_attention_f32_scores_ref(q, k, v, ln)
        err = float((o.float() - orf.float()).abs().max())
        ok32, err32, _ = bf16_close(o, of32)
        check(f"decode_attention {label} B={B} S={S} Hq={hq} KVH={kvh} hd={hd_}",
              err <= 2e-2 and ok32, f"max|err| {err:.3g} (tol 2e-2); against the f32-score plain "
              f"version max|diff| {err32:.3g} (rtol 1.6e-2, atol 1e-2)")
        if label == "serve shapes":
            max_err["decode_attention"] = err
            # a planted fault on the same inputs: the current token dropped
            o_f = kdec.decode_attention(q, k, v, ln - 1)
            ok_f, err_f, out_f = bf16_close(o_f, of32)
            err_f_plain = float((o_f.float() - orf.float()).abs().max())
            check("decode_attention gate rejects the current token dropped (lengths - 1)", not ok_f,
                  f"max|diff| {err_f:.3g}, {out_f:.2%} of elements outside (against the plain "
                  f"version max|err| {err_f_plain:.3g}, atol 2e-2)")
    q, k, v, ln = dec_inputs(BATCH, max_len, Hq, KVH, hd, dec_lengths)
    q, k = (q.float() * 3).bfloat16(), (k.float() * 3).bfloat16()  # scores ~ N(0, 81)
    truth = ref.decode_attention_ref(q.double(), k.double(), v.double(), ln)
    e_k = float((kdec.decode_attention(q, k, v, ln).double() - truth).abs().max())
    e_p = float((ref.decode_attention_ref(q, k, v, ln).double() - truth).abs().max())
    print(f"  info decode_attention with large scores, max|err| vs f64: kernel {e_k:.3g}, "
          f"plain {e_p:.3g} (the plain version rounds scores to bf16, the kernel does not)")
    q, k, v, ln = dec_inputs(3, 64, 4, 4, 64, [0, 30, 64])
    o = kdec.decode_attention(q, k, v, ln)
    orf = ref.decode_attention_ref(q, k, v, ln)
    check("decode_attention length-zero row", bool(torch.all(o[0] == 0))
          and float((o[1:].float() - orf[1:].float()).abs().max()) <= 2e-2,
          "row 0 is zeros, rows 1-2 within 2e-2")

    # paged decode attention: physical blocks shuffled, the columns past each
    # row's length at the trailing trash block
    def paged_inputs(B, hq, kvh, hd_, bs, lengths, n_logical):
        NB = B * n_logical + 1
        perm = torch.randperm(NB - 1, generator=gen, device=dev).int()
        table = torch.full((B, n_logical), NB - 1, dtype=torch.int32, device=dev)
        for b, n in enumerate(lengths):
            used = -(-n // bs)
            table[b, :used] = perm[b * n_logical : b * n_logical + used]
        q = torch.randn((B, hq, hd_), generator=gen, device=dev).bfloat16()
        kp = torch.randn((NB, bs, kvh, hd_), generator=gen, device=dev).bfloat16()
        vp = torch.randn((NB, bs, kvh, hd_), generator=gen, device=dev).bfloat16()
        return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32, device=dev)

    def gathered(pool, table, seq_len):
        return pool[table.long()].reshape(table.shape[0], -1, *pool.shape[2:])[:, :seq_len].contiguous()

    def paged_gate(out, q, kp, vp, table, ln, seq_len):
        """Element-wise at the bf16 tolerance against the f32-score plain
        version on the gathered cache, and bitwise against the dense kernel
        on it: (both hold, max|diff| to the f32-score plain, bitwise)."""
        kg, vg = gathered(kp, table, seq_len), gathered(vp, table, seq_len)
        lnc = ln.clamp(max=seq_len)
        ok32, err32, _ = bf16_close(out, ref.decode_attention_f32_scores_ref(q, kg, vg, lnc))
        bitwise = torch.equal(out, kdec.decode_attention(q, kg, vg, lnc))
        return ok32 and bitwise, err32, bitwise

    n_log = {bs: -(-max_len // bs) for bs in (BLOCK, 3, 1)}
    paged_main = None
    for bs in (BLOCK, 3, 1):
        args = paged_inputs(BATCH, Hq, KVH, hd, bs, dec_lengths, n_log[bs])
        o = kpaged.paged_decode_attention(*args, seq_len=max_len)
        ok, err32, bitwise = paged_gate(o, *args, max_len)
        err = float((o.float() - ref.paged_decode_attention_ref(*args, seq_len=max_len).float()).abs().max())
        check(f"paged_decode_attention serve shapes bs={bs} n_logical={n_log[bs]} B={BATCH} Hq={Hq} hd={hd}",
              ok and err <= 2e-2, f"against the f32-score plain version on the gathered cache max|diff| "
              f"{err32:.3g} (rtol 1.6e-2, atol 1e-2); bitwise equal to the dense kernel {bitwise}; "
              f"against the plain version max|err| {err:.3g} (tol 2e-2)")
        if bs == BLOCK:
            max_err["paged_decode_attention"] = err
            paged_main = args
    # planted faults on the main case's inputs, each held to the true table's
    # gathered cache: one table entry at the neighbouring block, and the last
    # partial block of every row dropped
    q, kp, vp, table, ln = paged_main
    kg, vg = gathered(kp, table, max_len), gathered(vp, table, max_len)
    want32 = ref.decode_attention_f32_scores_ref(q, kg, vg, ln)
    neighbour = table.clone()
    neighbour[0, 1] = (neighbour[0, 1] + 1) % (kp.shape[0] - 1)
    for fault, out in (
        ("row 0's second block read from its neighbour",
         kpaged.paged_decode_attention(q, kp, vp, neighbour, ln, seq_len=max_len)),
        ("the last partial block dropped (lengths cut to whole blocks)",
         kpaged.paged_decode_attention(q, kp, vp, table, ln // BLOCK * BLOCK, seq_len=max_len)),
    ):
        ok_f, err_f, out_f = bf16_close(out, want32)
        check(f"paged_decode_attention gate rejects a planted fault: {fault}", not ok_f,
              f"max|diff| {err_f:.3g}, {out_f:.2%} of elements outside")
    # a length-0 row, an all-trash padded row, and seq_len short of n_logical * bs
    q, kp, vp, table, ln = paged_inputs(4, Hq, KVH, hd, BLOCK, [1, 37, 5, 150], 10)
    ln[0] = 0
    table[2] = kp.shape[0] - 1
    o = kpaged.paged_decode_attention(q, kp, vp, table, ln, seq_len=140)
    ok, err32, bitwise = paged_gate(o, q, kp, vp, table, ln, 140)
    check("paged_decode_attention edge rows (length 0, all-trash padded row, seq_len 140 < 160)",
          ok and bool(torch.all(o[0] == 0)), f"row 0 zeros {bool(torch.all(o[0] == 0))}; "
          f"max|diff| {err32:.3g} to the f32-score plain; bitwise to dense {bitwise}")

    # both decode kernels at glm4-9b's shapes: 16 query heads over each of 2
    # KV heads of 128 (two CTAs per KV head)
    glm = get_config("glm4-9b")
    g_hq, g_kvh, g_hd = glm.num_heads, glm.num_kv_heads, glm.head_dim
    g_len = max(GLM_LENGTHS) + 8
    q, k, v, ln = dec_inputs(BATCH, g_len, g_hq, g_kvh, g_hd, GLM_LENGTHS)
    o = kdec.decode_attention(q, k, v, ln)
    err = float((o.float() - ref.decode_attention_ref(q, k, v, ln).float()).abs().max())
    ok32, err32, _ = bf16_close(o, ref.decode_attention_f32_scores_ref(q, k, v, ln))
    check(f"decode_attention glm4-9b G={g_hq // g_kvh} B={BATCH} S={g_len} Hq={g_hq} KVH={g_kvh} "
          f"hd={g_hd}", err <= 2e-2 and ok32, f"max|err| {err:.3g} (tol 2e-2); against the "
          f"f32-score plain version max|diff| {err32:.3g} (rtol 1.6e-2, atol 1e-2)")
    n_log_g = -(-g_len // BLOCK)
    args = paged_inputs(BATCH, g_hq, g_kvh, g_hd, BLOCK, GLM_LENGTHS, n_log_g)
    o = kpaged.paged_decode_attention(*args, seq_len=g_len)
    ok, err32, bitwise = paged_gate(o, *args, g_len)
    err = float((o.float() - ref.paged_decode_attention_ref(*args, seq_len=g_len).float()).abs().max())
    check(f"paged_decode_attention glm4-9b G={g_hq // g_kvh} bs={BLOCK} n_logical={n_log_g}",
          ok and err <= 2e-2, f"against the f32-score plain version on the gathered cache "
          f"max|diff| {err32:.3g}; bitwise equal to the dense kernel {bitwise}; against the plain "
          f"version max|err| {err:.3g} (tol 2e-2)")

    # both decode kernels on a long cache (S 4096), at glm4-9b's heads (G 16)
    # and at stablelm-1.6b's (G 1): several splits of the walk per row, added
    # by the combine; planted faults on the same inputs: the last split of
    # every row dropped, and the combine skipped
    split = kdec.SPLIT_KEYS
    n_log_long = -(-LONG_S // BLOCK)
    long_heads = {"glm4-9b": (g_hq, g_kvh, g_hd), "stablelm-1.6b": (Hq, KVH, hd)}
    long_paged = {}
    for name, (hq, kvh, hd_) in long_heads.items():
        G = hq // kvh
        q, k, v, ln = dec_inputs(BATCH, LONG_S, hq, kvh, hd_, LONG_LENGTHS)
        o = kdec.decode_attention(q, k, v, ln)
        want32 = ref.decode_attention_f32_scores_ref(q, k, v, ln)
        err = float((o.float() - ref.decode_attention_ref(q, k, v, ln).float()).abs().max())
        ok32, err32, _ = bf16_close(o, want32)
        check(f"decode_attention {name} long cache G={G} B={BATCH} S={LONG_S} Hq={hq} KVH={kvh} "
              f"hd={hd_} lengths {min(LONG_LENGTHS)}..{max(LONG_LENGTHS)} "
              f"({len(kdec.split_bounds(min(LONG_LENGTHS)))}-{len(kdec.split_bounds(max(LONG_LENGTHS)))} "
              f"splits of {split})", err <= 2e-2 and ok32,
              f"max|err| {err:.3g} (tol 2e-2); against the f32-score plain version max|diff| {err32:.3g} "
              f"(rtol 1.6e-2, atol 1e-2)")
        skipped = torch.zeros_like(q)
        kdec._launch(q, k, v, ln, skipped, combine=False)
        for fault, out in (("the last split of every row dropped",
                            kdec.decode_attention(q, k, v, (ln - 1) // split * split)),
                           ("the combine over splits skipped", skipped)):
            ok_f, err_f, out_f = bf16_close(out, want32)
            check(f"decode_attention {name} long-cache gate rejects a planted fault: {fault}", not ok_f,
                  f"max|diff| {err_f:.3g}, {out_f:.2%} of elements outside")
        del q, k, v
        long_paged[name] = paged_inputs(BATCH, hq, kvh, hd_, BLOCK, LONG_LENGTHS, n_log_long)
        o = kpaged.paged_decode_attention(*long_paged[name], seq_len=LONG_S)
        ok, err32, bitwise = paged_gate(o, *long_paged[name], LONG_S)
        check(f"paged_decode_attention {name} long cache G={G} bs={BLOCK} n_logical={n_log_long}", ok,
              f"against the f32-score plain version on the gathered cache max|diff| {err32:.3g}; "
              f"bitwise equal to the dense kernel {bitwise}")
        q, kp, vp, table, ln = long_paged[name]
        skipped = torch.zeros_like(q)
        kpaged._launch(q, kp, vp, table, ln, skipped, LONG_S, combine=False)
        want32 = ref.decode_attention_f32_scores_ref(q, gathered(kp, table, LONG_S),
                                                     gathered(vp, table, LONG_S), ln)
        ok_f, err_f, out_f = bf16_close(skipped, want32)
        check(f"paged_decode_attention {name} long-cache gate rejects a planted fault: the combine "
              f"over splits skipped", not ok_f, f"max|diff| {err_f:.3g}, {out_f:.2%} of elements outside")

    # both decode kernels at G 5 and G 6 (hd 128), at the serve's lengths and
    # on the long cache: dense against the plain version (atol 2e-2) and the
    # f32-score plain version (element-wise, bf16 tolerance); paged at bs 16,
    # 3 and 1 against the f32-score plain version on the gathered cache and
    # bit for bit against the dense kernel on it
    gqa_lengths = (("serve lengths", max_len, dec_lengths), ("long cache", LONG_S, LONG_LENGTHS))
    for name, (hq, kvh, hd_) in GQA_HEADS.items():
        G = hq // kvh
        for label, S, lengths in gqa_lengths:
            q, k, v, ln = dec_inputs(BATCH, S, hq, kvh, hd_, lengths)
            o = kdec.decode_attention(q, k, v, ln)
            err = float((o.float() - ref.decode_attention_ref(q, k, v, ln).float()).abs().max())
            ok32, err32, _ = bf16_close(o, ref.decode_attention_f32_scores_ref(q, k, v, ln))
            check(f"decode_attention {name} G={G} {label} B={BATCH} S={S} Hq={hq} KVH={kvh} hd={hd_}",
                  err <= 2e-2 and ok32, f"max|err| {err:.3g} (tol 2e-2); against the f32-score plain "
                  f"version max|diff| {err32:.3g} (rtol 1.6e-2, atol 1e-2)")
            del q, k, v
            for bs in (BLOCK, 3, 1):
                args = paged_inputs(BATCH, hq, kvh, hd_, bs, lengths, -(-S // bs))
                o = kpaged.paged_decode_attention(*args, seq_len=S)
                ok, err32, bitwise = paged_gate(o, *args, S)
                check(f"paged_decode_attention {name} G={G} {label} bs={bs}", ok,
                      f"against the f32-score plain version on the gathered cache max|diff| "
                      f"{err32:.3g}; bitwise equal to the dense kernel {bitwise}")
                del args

    # prefill flash attention: element-wise at tests/test_kernels.py's bf16
    # tolerance (atol 2e-2) against the plain version on the same inputs
    def flash_inputs(B, Sq, Sk, hq, kvh, hd_):
        return (torch.randn((B, Sq, hq, hd_), generator=gen, device=dev).bfloat16(),
                torch.randn((B, Sk, kvh, hd_), generator=gen, device=dev).bfloat16(),
                torch.randn((B, Sk, kvh, hd_), generator=gen, device=dev).bfloat16())

    def flash_gate(out, want):
        """(within atol 2e-2, max|err|, share of elements outside)."""
        diff = (out.float() - want.float()).abs()
        return bool(diff.max() <= 2e-2), float(diff.max()), float((diff > 2e-2).float().mean())

    flash_cases = [(label, (B, S, S, hq, kvh, hd_), True, None)
                   for label, B, S, hq, kvh, hd_ in FLASH_SHAPES]
    flash_cases += [
        ("Sk > Sq, causal", (2, 128, 384, 4, 4, 128), True, None),
        ("not causal", (1, 128, 128, 2, 2, 64), False, None),
        ("window 100", (1, 256, 256, 4, 4, 64), True, 100),
        ("Sq = 1", (2, 1, 50, 8, 2, 32), True, None),
        ("S not a multiple of 64", (3, 77, 77, 8, 2, 32), True, None),
    ]
    for label, shape, causal, window in flash_cases:
        q, k, v = flash_inputs(*shape)
        o = kflash.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        ok, err, out_share = flash_gate(o, want)
        B, Sq, Sk, hq, kvh, hd_ = shape
        check(f"flash_attention {label} B={B} Sq={Sq} Sk={Sk} Hq={hq} KVH={kvh} hd={hd_}", ok,
              f"max|err| {err:.3g} (atol 2e-2), {out_share:.2%} of elements outside")
        if label == FLASH_SHAPES[0][0]:
            max_err["flash_attention"] = err
        if label == FLASH_SHAPES[1][0]:
            glm_flash = (q, k, v, want)
        if label == FLASH_SHAPES[3][0]:
            long_flash = (q, k, v, want)
    # planted faults on the kernel's inputs at glm4-9b's heads, each held to
    # the plain version on the true inputs
    q, k, v, want = glm_flash
    for fault, (kf, vf) in (
        ("K/V shifted by one position (every query sees the next key)",
         (torch.roll(k, -1, dims=1), torch.roll(v, -1, dims=1))),
        ("Sk cut to the last whole tile (the ragged tail dropped)",
         (k[:, : k.shape[1] // 64 * 64].contiguous(), v[:, : v.shape[1] // 64 * 64].contiguous())),
        ("the KV heads permuted at G 16 (the wrong head map)",
         (k.flip(2).contiguous(), v.flip(2).contiguous())),
    ):
        ok, err, out_share = flash_gate(kflash.flash_attention(q, kf, vf), want)
        check(f"flash_attention gate rejects a planted fault: {fault}", not ok,
              f"max|err| {err:.3g}, {out_share:.2%} of elements outside")
    # and at 2048 tokens with glm4-9b's heads: the last 128-key tile dropped
    q, k, v, want = long_flash
    ok, err, out_share = flash_gate(kflash.flash_attention(q, k[:, :-128].contiguous(),
                                                           v[:, :-128].contiguous()), want)
    check("flash_attention gate rejects a planted fault at 2048 tokens: the last key tile dropped",
          not ok, f"max|err| {err:.3g}, {out_share:.2%} of elements outside")

    # -- 4. full-width serve -------------------------------------------------
    phase("full-width serve")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    profile = profile_from_arch(cfg)
    topo = build_edge_network(seed=0, profile=profile, spec=NetworkSpec(num_eds=4, es_per_stage=(2, 2)))
    engine = CollaborativeEngine(
        params, cfg, topo, profile, synthetic_validation(seed=1, profile=profile),
        DtoHyperParams(), seed=SEED, device=dev,
    )
    engine.configuration_phase()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    print(f"stablelm-1.6b full width: {cfg.num_layers} layers, d {d}, {Hq} heads x {hd}, "
          f"d_ff {cfg.d_ff}, vocab {V}; {n_params / 1e9:.3f} B params; set-up "
          f"{time.perf_counter() - t0:.1f} s; thresholds {engine.thresholds}")
    print(f"prompts: {N_REQUESTS}, lengths {min(map(len, prompts))}..{max(map(len, prompts))} "
          f"(mean {np.mean([len(p) for p in prompts]):.1f}), max_len {max_len}", flush=True)
    def zero_counts():
        kexit.exit_confidence.launches = 0
        kdec.decode_attention.launches = 0
        kpaged.paged_decode_attention.launches = 0
        kflash.flash_attention.launches = 0

    def read_counts():
        return {"exit_confidence": kexit.exit_confidence.launches,
                "decode_attention": kdec.decode_attention.launches,
                "paged_decode_attention": kpaged.paged_decode_attention.launches,
                "flash_attention": kflash.flash_attention.launches}

    torch.cuda.reset_peak_memory_stats()
    engine.rng = np.random.default_rng(SEED)
    zero_counts()
    t0 = time.perf_counter()
    stats = engine.serve(prompts, batch_size=BATCH, gen_len=GEN_LEN, decode_mode="cached")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    s = stats.summary()
    print(f"serve wall {wall:.3f} s; generated tokens {s['generated_tokens']}; "
          f"{s['generated_tokens'] / wall:.1f} tokens/s (real wall); completed {s['num_completed']}; "
          f"batches {s['num_batches']}; exit histogram {s['exit_histogram']}")
    print(f"kernel launches in the serve: {launches}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check("serve completed", s["num_completed"] == N_REQUESTS, f"{s['num_completed']} of {N_REQUESTS}")
    seqs = stats.gen_tokens
    check("serve tokens in vocab", all(0 <= t < V for g in seqs for t in g)
          and all(1 <= len(g) <= GEN_LEN for g in seqs), f"{len(seqs)} sequences")
    for name in ("exit_confidence", "decode_attention", "flash_attention"):
        check(f"{name} launched on the main path", launches[name] > 0, f"{launches[name]} launches")
    dense_seqs = stats.sequences_by_rid()

    # the same serve observed: a span tracer and a metrics collector on the
    # engine's instrumentation stream.  The tracer asks for the wall time of
    # every stage batch, and the engine then synchronizes after each one.
    engine.rng = np.random.default_rng(SEED)
    tracer, metrics = SpanTracer(), MetricsCollector()
    zero_counts()
    t0 = time.perf_counter()
    obs_stats = engine.serve(prompts, batch_size=BATCH, gen_len=GEN_LEN, decode_mode="cached",
                             tracer=tracer, metrics=metrics)
    torch.cuda.synchronize()
    wall_traced = time.perf_counter() - t0
    obs_launches = read_counts()
    delay_h = metrics.registry.histogram("delay_s")
    print(f"observed serve: wall {wall_traced:.3f} s traced against {wall:.3f} s untraced (the serve "
          f"above; its first call of each shape included); kernel launches {obs_launches}; metrics: "
          f"{metrics.registry.counter('batches').value:.0f} batches, simulated delay p50 "
          f"{delay_h.quantile(0.5) * 1e3:.2f} ms p95 {delay_h.quantile(0.95) * 1e3:.2f} ms", flush=True)
    for name in ("exit_confidence", "decode_attention", "flash_attention"):
        check(f"{name} launched in the observed serve", obs_launches[name] > 0,
              f"{obs_launches[name]} launches")
    same = (obs_stats.rids == stats.rids and obs_stats.exit_stage == stats.exit_stage
            and obs_stats.gen_tokens == stats.gen_tokens and obs_stats.delays == stats.delays)
    check("observed serve bitwise equal to the untraced serve", same,
          f"rids, exits, tokens and simulated delays of {len(obs_stats.rids)} requests")
    dec = decompose(tracer, obs_stats)
    check("observed serve's delays reconcile with its span trees", dec["reconciles"]
          and dec["num_requests"] == N_REQUESTS,
          f"max residual {dec['max_residual_s']!r} s over {dec['num_requests']} requests; mean "
          f"components (ms) " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in
                                          dec["mean_components_s"].items()))
    open_trees = {rid: errs for rid in obs_stats.rids if (errs := tracer.check_tree(rid))}
    check("observed serve's span trees all closed", not open_trees,
          f"{len(open_trees)} of {len(obs_stats.rids)} trees with violations "
          f"{list(open_trees.values())[:2]}")
    payload = chrome_trace(tracer)
    errs = validate_chrome_trace(payload)
    check("observed serve's Perfetto export validates", errs == [],
          f"{len(payload['traceEvents'])} events; {errs[:3]}")
    rows = roofline_utilization(tracer, cfg)
    print(f"  roofline join ({torch.cuda.get_device_name(0)}; bound from the H100 SXM peaks, "
          f"{PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s):")
    print(f"  {'row':16} {'calls':>6} {'live/rows':>11} {'tokens':>7} {'GFLOP':>9} {'GB':>8} "
          f"{'measured ms':>12} {'bound ms':>9} {'ms/call':>8} {'bound/call':>10} {'util':>7}")
    for key, r in rows.items():
        print(f"  {key:16} {r['calls']:6d} {r['live_rows']:5d}/{r['device_rows']:<5d} "
              f"{r['device_tokens']:7d} {r['analytic_gflops']:9.1f} {r['analytic_gbytes']:8.2f} "
              f"{r['measured_wall_s'] * 1e3:12.3f} {r['bound_s'] * 1e3:9.3f} "
              f"{r['measured_wall_s'] * 1e3 / r['calls']:8.3f} {r['bound_s'] * 1e3 / r['calls']:10.4f} "
              f"{r['utilization']:7.4f}")
    sys.stdout.flush()
    bad = [key for key, r in rows.items() if not (r["measured_wall_s"] > 0 and r["utilization"] <= 1.0)]
    check("every (stage, phase) row measured and within its H100 bound",
          len(rows) == 2 * cfg.num_stages and not bad,
          f"{len(rows)} rows (want {2 * cfg.num_stages}); outside: {bad}; sum of measured walls "
          f"{sum(r['measured_wall_s'] for r in rows.values()):.3f} s of the {wall_traced:.3f} s serve")
    del tracer, metrics, payload

    # one stage_decode at full width, kernels forced off and on
    programs = engine.programs
    toks = np.random.default_rng(SEED).integers(0, V, (BATCH, 64)).astype(np.int32)
    x1, _ = programs.stage_prefill(1, programs.embed(toks), max_len)
    store = programs.init_slot_caches(2, BATCH + 1, max_len)
    _, caches = programs.stage_prefill(2, x1, max_len)
    slots = np.arange(BATCH)
    programs.slot_write(store, caches, slots)
    x_dec = x1[:, -1:].contiguous()
    outs = {}
    for backend in ("torch", "cuda"):
        ops.set_backend(backend)
        try:
            st = tuple({k: t.clone() for k, t in dct.items()} for dct in store)
            y = programs.stage_decode(2, x_dec, st, slots)
            outs[backend] = (y, programs.exit_head(2, y))
        finally:
            ops.set_backend("auto")
    y_t, (c_t, i_t) = outs["torch"]
    y_c, (c_c, i_c) = outs["cuda"]

    def rel_norm(a, b):
        return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float()))

    # Element-wise, kernel and plain version differ past the bf16 tolerance
    # where the residual stream cancels: the plain version rounds the
    # attention scores to bf16 (as the JAX reference does), the kernel keeps
    # them in f32, and six layers carry that apart.  This comparison is
    # therefore norm-wise at the bf16 rtol, plus equal exit-head tokens.
    _, dmax, outside = bf16_close(y_c, y_t)
    rel = rel_norm(y_c, y_t)
    check("stage_decode torch vs cuda (stage 2, 6 layers)", rel <= 1.6e-2 and torch.equal(i_c, i_t),
          f"norm-wise rel {rel:.3g} (tol 1.6e-2); exit-head argmax equal {torch.equal(i_c, i_t)}; "
          f"element-wise max|diff| {dmax:.3g} at max|y| {float(y_t.float().abs().max()):.3g}, "
          f"{outside:.2%} of elements outside rtol 1.6e-2/atol 1e-2; "
          f"exit conf max|diff| {float((c_c - c_t).abs().max()):.3g}")

    # The gate with a margin: the same stage with the f32-score plain
    # version in place of the kernel.  It shares the kernel's f32 scores;
    # the kernel also rounds P to bf16 for P.V, as the Pallas body does
    # (against each warp's running max), so the attention outputs differ by
    # up to one bf16 ulp in many elements.  Six bf16 layers carry those
    # flips past the element-wise tolerance where the residual stream
    # cancels, so the gate is norm-wise at two bf16 ulps (2^-7) plus equal
    # exit-head tokens.  Planted faults on the same inputs must fail it.
    # Beside it, a gate with the kernel gate's margin: each layer's attention
    # output element-wise at the bf16 tolerance against the f32-score plain
    # version on that layer's own inputs (`layers` collects the verdicts).
    def stage_with(decode_fn, layers=None):
        kept = ops.decode_attention

        def recorded(q_, k_, v_, n_):
            o_ = decode_fn(q_, k_, v_, n_)
            if layers is not None:
                layers.append(bf16_close(o_, ref.decode_attention_f32_scores_ref(q_, k_, v_, n_)))
            return o_

        ops.decode_attention = recorded
        try:
            st = tuple({k: t.clone() for k, t in dct.items()} for dct in store)
            y = programs.stage_decode(2, x_dec, st, slots)
            return y, programs.exit_head(2, y)[1]
        finally:
            ops.decode_attention = kept

    def stage_gate(y, i):
        rel_ = rel_norm(y, y_f)
        _, dmax_, outside_ = bf16_close(y, y_f)
        ok_ = rel_ <= 2**-7 and torch.equal(i, i_f)
        return ok_, (f"norm-wise rel {rel_:.3g} (tol 2^-7 = {2**-7:.3g}), exit-head argmax equal "
                     f"{torch.equal(i, i_f)}; element-wise max|diff| {dmax_:.3g}, {outside_:.2%} of "
                     f"elements outside rtol 1.6e-2/atol 1e-2")

    n_layers = cfg.stage_periods()[1]

    def layer_gate(layers):
        ok_ = len(layers) == n_layers and all(ok for ok, _, _ in layers)
        return ok_, (f"{sum(ok for ok, _, _ in layers)} of {len(layers)} layers' attention outputs "
                     f"within the bf16 tolerance of the f32-score plain version on their own inputs "
                     f"(want {n_layers}); max|diff| {max(e for _, e, _ in layers):.3g}, up to "
                     f"{max(s for _, _, s in layers):.2%} of a layer's elements outside")

    y_f, i_f = stage_with(ref.decode_attention_f32_scores_ref)
    kernel_layers = []
    stage_with(kdec.decode_attention, kernel_layers)
    verdicts = [("stage_decode f32-score plain vs cuda (stage 2, 6 layers)", True,
                 *stage_gate(y_c, i_c)),
                ("stage_decode each layer's attention, cuda vs f32-score plain", True,
                 *layer_gate(kernel_layers))]
    faults = {
        "current token dropped (lengths - 1)":
            lambda q_, k_, v_, n_: kdec.decode_attention(q_, k_, v_, n_ - 1),
        f"query head {Hq - 1} of {Hq} zeroed":
            lambda q_, k_, v_, n_: kdec.decode_attention(q_, k_, v_, n_).index_fill(
                1, torch.tensor([Hq - 1], device=dev), 0),
    }
    for fault, fn in faults.items():
        fault_layers = []
        y_, i_ = stage_with(fn, fault_layers)
        verdicts.append((f"stage_decode gate rejects a planted fault: {fault}", False,
                         *stage_gate(y_, i_)))
        verdicts.append((f"stage_decode per-layer gate rejects a planted fault: {fault}", False,
                         *layer_gate(fault_layers)))
    _, detail = stage_gate(y_t, i_t)
    print(f"  info stage_decode plain (bf16 scores) against the f32-score plain: {detail}")
    plain_layers = []
    stage_with(ref.decode_attention_ref, plain_layers)
    print(f"  info the plain version (bf16 scores) in the per-layer gate: {layer_gate(plain_layers)[1]}")
    for name, want, ok, detail in verdicts:  # every reading printed before any raises
        print(f"  {'ok  ' if ok == want else 'FAIL'} {name}: {detail}", flush=True)
    failed = [name for name, want, ok, _ in verdicts if ok != want]
    if failed:
        raise AssertionError(f"stage_decode gate: {failed}")

    # one stage_prefill at full width (stage 2, 6 layers), kernels forced off
    # (chunked_attention) and on (the flash kernel): norm-wise at the bf16
    # rtol plus equal exit-head tokens at each row's last prompt position.
    # Faults planted inside the stage, on the flash kernel's inputs or
    # output, must fail the same gate.
    def prefill_with(backend, flash_fn=None):
        kept = ops.flash_attention
        ops.set_backend(backend)
        if flash_fn is not None:
            ops.flash_attention = flash_fn
        try:
            y, _ = programs.stage_prefill(2, x1, max_len)
            return y, programs.exit_head(2, y[:, -1:].contiguous())[1]
        finally:
            ops.flash_attention = kept
            ops.set_backend("auto")

    yp_t, ip_t = prefill_with("torch")
    n0 = kflash.flash_attention.launches
    yp_c, ip_c = prefill_with("cuda")
    per_pass = kflash.flash_attention.launches - n0

    def prefill_gate(y, i):
        rel_ = rel_norm(y, yp_t)
        _, dmax_, outside_ = bf16_close(y, yp_t)
        ok_ = rel_ <= 1.6e-2 and torch.equal(i, ip_t)
        return ok_, (f"norm-wise rel {rel_:.3g} (tol 1.6e-2), exit-head argmax at the last prompt "
                     f"position equal {torch.equal(i, ip_t)}; element-wise max|diff| {dmax_:.3g} at "
                     f"max|y| {float(yp_t.float().abs().max()):.3g}, {outside_:.2%} of elements "
                     f"outside rtol 1.6e-2/atol 1e-2")

    verdicts = [(f"stage_prefill torch vs cuda (stage 2, 6 layers, B {BATCH}, S {x1.shape[1]}; "
                 f"{per_pass} flash launches)", True, *prefill_gate(yp_c, ip_c))]
    prefill_faults = {
        "K/V shifted by one position":
            lambda q_, k_, v_, **kw: kflash.flash_attention(
                q_, torch.roll(k_, -1, dims=1), torch.roll(v_, -1, dims=1), **kw),
        f"query head {Hq - 1} of {Hq} zeroed":
            lambda q_, k_, v_, **kw: kflash.flash_attention(q_, k_, v_, **kw).index_fill(
                2, torch.tensor([Hq - 1], device=dev), 0),
    }
    for fault, fn in prefill_faults.items():
        verdicts.append((f"stage_prefill gate rejects a planted fault: {fault}", False,
                         *prefill_gate(*prefill_with("cuda", fn))))
    for name, want, ok, detail in verdicts:
        print(f"  {'ok  ' if ok == want else 'FAIL'} {name}: {detail}", flush=True)
    failed = [name for name, want, ok, _ in verdicts if ok != want]
    check("stage_prefill launched the flash kernel", per_pass == cfg.stage_periods()[1],
          f"{per_pass} launches for {cfg.stage_periods()[1]} layers")
    if failed:
        raise AssertionError(f"stage_prefill gate: {failed}")

    # the same serve with arrivals fast enough to fill every batch
    engine.rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    stats = engine.serve(prompts, arrival_rate=1e4, batch_size=BATCH, gen_len=GEN_LEN,
                         decode_mode="cached")
    torch.cuda.synchronize()
    wall_full = time.perf_counter() - t0
    s_full = stats.summary()
    full_seqs = stats.sequences_by_rid()
    print(f"serve at arrival_rate 1e4 (full batches): wall {wall_full:.3f} s; "
          f"{s_full['generated_tokens'] / wall_full:.1f} tokens/s; batches {s_full['num_batches']}; "
          f"padded rows {s_full['padded_row_frac']:.1%}", flush=True)

    # where a serve's time goes: a short profiled serve (the profiler's own
    # overhead is inside its wall time, so the busy share is a lower bound)
    engine.rng = np.random.default_rng(SEED)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        engine.serve(prompts[:BATCH], batch_size=BATCH, gen_len=4, decode_mode="cached")
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    # device-side rows only, as in device_launches
    by_kernel = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in by_kernel)
    if busy_us == 0:
        print("profiled serve: device time not measured (the profiler recorded no device events)")
    else:
        print(f"profiled serve ({BATCH} requests, 4 tokens): wall {wall_prof:.3f} s, device busy "
              f"{busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall_prof:.1%} of wall")
        for key, t in sorted(by_kernel, key=lambda kv: -kv[1])[:8]:
            print(f"  {t / busy_us:6.1%}  {t / 1e3:9.3f} ms  {key[:90]}")
        flash_us = sum(t for key, t in by_kernel if "flash_wgmma_kernel" in key)
        print(f"  flash_attention kernel: {flash_us / 1e3:.3f} ms = {flash_us / busy_us:.2%} of device "
              f"time")
    sys.stdout.flush()

    # -- 5. paged serve --------------------------------------------------------
    phase("paged serve")
    n_slots = max(2 * BATCH, 4)  # the engine's default ring
    periods = cfg.stage_periods()[0]
    kv_row = 2 * KVH * hd * 2  # K and V bytes of one cached position
    pool_bytes = periods * (n_slots * n_log[BLOCK] + 1) * BLOCK * kv_row
    dense_bytes = periods * (n_slots + 1) * max_len * kv_row
    # the dense serve again right before the paged one: the host-bound wall
    # time moves between runs, so the two are compared side by side
    # (peak memory above what was allocated before each serve: the weights
    # and what earlier phases hold)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine.rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    engine.serve(prompts, batch_size=BATCH, gen_len=GEN_LEN, decode_mode="cached")
    torch.cuda.synchronize()
    dense_wall, dense_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine.rng = np.random.default_rng(SEED)
    zero_counts()
    t0 = time.perf_counter()
    stats = engine.serve(prompts, batch_size=BATCH, gen_len=GEN_LEN, decode_mode="cached",
                         cache_layout="paged", block_size=BLOCK, prefix_sharing=False)
    torch.cuda.synchronize()
    wall_paged = time.perf_counter() - t0
    launches_paged = read_counts()
    s_p = stats.summary()
    print(f"paged serve (block {BLOCK}, no prefix sharing): wall {wall_paged:.3f} s "
          f"(the dense serve just before it {dense_wall:.3f} s, {s['generated_tokens'] / dense_wall:.1f} "
          f"tokens/s); {s_p['generated_tokens'] / wall_paged:.1f} tokens/s; "
          f"batches {s_p['num_batches']} (dense {s['num_batches']}); peak device memory above the "
          f"{base / 2**30:.2f} GiB held before the serve {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f}"
          f" GiB (dense {dense_peak / 2**30:.3f} GiB); "
          f"K/V bytes per replica of a {periods}-layer stage: pool {pool_bytes / 2**20:.1f} MiB "
          f"({n_slots * n_log[BLOCK]} blocks + trash), dense slots {dense_bytes / 2**20:.1f} MiB; "
          f"block occupancy peak {s_p['block_occupancy_peak']:.3f}")
    print(f"kernel launches in the paged serve: {launches_paged}", flush=True)
    check("paged serve launched the paged kernel", launches_paged["paged_decode_attention"] > 0,
          f"{launches_paged['paged_decode_attention']} launches")
    check("paged serve launched no dense decode kernel", launches_paged["decode_attention"] == 0,
          f"{launches_paged['decode_attention']} launches")
    diverged = [r for r, v in stats.sequences_by_rid().items() if dense_seqs.get(r) != v]
    check("paged serve tokens and exits equal the dense serve's", not diverged
          and len(dense_seqs) == N_REQUESTS, f"{len(diverged)} of {N_REQUESTS} requests differ")

    # prefill row-invariance: one prompt alone and as row 3 of a batch of 8;
    # and a 48-token prefix's K/V inside two prompts of other lengths
    def prefill_kv(tok_rows):
        x = programs.embed(tok_rows)
        kvs = []
        for stage in range(1, cfg.num_stages + 1):
            x, caches = programs.stage_prefill(stage, x, max_len)
            kvs.append((caches[0]["k"], caches[0]["v"]))
        return kvs

    rng_p = np.random.default_rng(SEED + 1)
    batch8 = rng_p.integers(0, V, (BATCH, 64)).astype(np.int32)
    alone, inside = prefill_kv(batch8[3:4]), prefill_kv(batch8)
    row_inv = all(torch.equal(a[:, 0], b[:, 3]) for (ka, va), (kb, vb) in zip(alone, inside)
                  for a, b in ((ka, kb), (va, vb)))
    prefix = rng_p.integers(0, V, 48)
    long_a = np.concatenate([prefix, rng_p.integers(0, V, 20)]).astype(np.int32)[None]
    long_b = np.concatenate([prefix, rng_p.integers(0, V, 9)]).astype(np.int32)[None]
    kv_a, kv_b = prefill_kv(long_a), prefill_kv(long_b)
    prefix_inv = all(torch.equal(a[:, :, :48], b[:, :, :48]) for (ka, va), (kb, vb) in zip(kv_a, kv_b)
                     for a, b in ((ka, kb), (va, vb)))
    print(f"prefill K/V of a 64-token prompt alone vs as row 3 of 8, all {cfg.num_stages} stages: "
          f"{'bitwise equal' if row_inv else 'NOT bitwise equal'}; a 48-token prefix's K/V in a 68- "
          f"vs a 57-token prompt: {'bitwise equal' if prefix_inv else 'NOT bitwise equal'}", flush=True)

    # batching alone: the same prompts served dense at two arrival rates form
    # other batches (prefill and decode GEMMs of other row counts)
    moved = [r for r, v in full_seqs.items() if dense_seqs.get(r) != v]
    print(f"dense serve at arrival_rate 1e4 against the default rate: {len(moved)} of {N_REQUESTS} "
          f"requests differ (the batches differ, the cache layout does not)", flush=True)

    # the shared-prefix serve: sharing on, against the same prompts served dense
    shared = paged_prefix_prompts(np.random.default_rng(SEED + 2), V, n_groups=4, group=6, n_long=2)
    engine.rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    dense_sh = engine.serve(shared, arrival_rate=1e4, batch_size=BATCH, gen_len=GEN_LEN,
                            decode_mode="cached")
    torch.cuda.synchronize()
    wall_dense_sh = time.perf_counter() - t0
    # at every admission, each shared block the request reads is compared
    # with what its own prefill computed for those positions
    from repro_torch.serving import engine as engine_mod

    admitted, shared_reads = [], [0, 0, 0.0]  # blocks compared, blocks differing, max|diff|
    real_alloc, real_write = engine_mod.BlockAllocator.alloc, programs.paged_slot_write

    def recording_alloc(self, tokens):
        res = real_alloc(self, tokens)
        admitted.append(res)
        return res

    def checking_write(pool, state, new_caches, wtab, slots):
        # after the write: a block shared within this batch is written by it
        real_write(pool, state, new_caches, wtab, slots)
        rows, admitted[:] = list(admitted), []
        for i, res in enumerate(rows):
            for j, (blk, hit) in enumerate(zip(res.table, res.shared)):
                if hit:
                    diff = max(float((pool_d[key][:, blk].float()
                                      - new_d[key][:, i, j * BLOCK:(j + 1) * BLOCK].float()).abs().max())
                               for pool_d, new_d in zip(pool, new_caches) for key in pool_d)
                    shared_reads[0] += 1
                    shared_reads[1] += diff > 0
                    shared_reads[2] = max(shared_reads[2], diff)

    engine_mod.BlockAllocator.alloc, programs.paged_slot_write = recording_alloc, checking_write
    engine.rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    try:
        paged_sh = engine.serve(shared, arrival_rate=1e4, batch_size=BATCH, gen_len=GEN_LEN,
                                cache_layout="paged", block_size=BLOCK, prefix_sharing=True)
    finally:
        engine_mod.BlockAllocator.alloc = real_alloc
        del programs.paged_slot_write
    torch.cuda.synchronize()
    wall_paged_sh = time.perf_counter() - t0
    s_sh = paged_sh.summary()
    print(f"shared-prefix serve ({len(shared)} prompts: 4 groups of 6 sharing 48 tokens, 2 of 384): "
          f"dense wall {wall_dense_sh:.3f} s, paged wall {wall_paged_sh:.3f} s (with the shared-block "
          f"comparison); prefix hits "
          f"{s_sh['prefix_hit_blocks']} of {s_sh['prefix_total_blocks']} prompt blocks; block "
          f"occupancy mean {s_sh['block_occupancy_mean']:.3f}, peak {s_sh['block_occupancy_peak']:.3f}; "
          f"peak in flight {s_sh['peak_in_flight']} (dense {dense_sh.summary()['peak_in_flight']})")
    check("shared-prefix serve hit the prefix map", s_sh["prefix_hit_blocks"] > 0,
          f"{s_sh['prefix_hit_blocks']} hits")
    drained = [v for v, a in paged_sh.allocators.items() if a.live_handles() or any(a.refcounts())]
    check("shared-prefix serve drained every pool", paged_sh.allocators and not drained,
          f"{len(paged_sh.allocators)} allocators, {len(drained)} with live handles or references")
    dense_sh_seqs = dense_sh.sequences_by_rid()
    diverged = [r for r, v in paged_sh.sequences_by_rid().items() if dense_sh_seqs.get(r) != v]
    detail = (f"{len(diverged)} of {len(shared)} requests differ from the dense serve; "
              f"{shared_reads[1]} of {shared_reads[0]} shared-block reads differ from the reading "
              f"request's own prefill, by up to {shared_reads[2]:.3g}")
    if shared_reads[1] == 0:
        check("shared-prefix serve tokens and exits equal the dense serve's (every shared block "
              "holds the reader's own prefill)", not diverged, detail)
    else:
        print(f"  info shared-prefix serve against the dense serve: {detail} (the prefill of "
              f"another batch shape wrote those blocks, and it is not bitwise the same)", flush=True)

    # block_copy on one full-width stage pool: the copy-on-write device half
    pool, _ = programs.init_paged_slot_caches(2, n_slots + 1, n_slots * n_log[BLOCK] + 1, BLOCK, max_len)
    for dct in pool:
        for t in dct.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    before = [{k: t.clone() for k, t in dct.items()} for dct in pool]
    src, dst = np.array([0, 5, 17, 100]), np.array([5, 40, 191, 3])  # block 5 read and written
    programs.block_copy(pool, src, dst)
    rest = np.setdiff1d(np.arange(pool[0]["k"].shape[1]), dst)
    copied = all(torch.equal(t[:, dst], b[k][:, src]) for dct, b in zip(pool, before) for k, t in dct.items())
    kept = all(torch.equal(t[:, rest], b[k][:, rest]) for dct, b in zip(pool, before) for k, t in dct.items())
    check(f"block_copy on a full-width pool {tuple(pool[0]['k'].shape)}", copied and kept,
          f"copied blocks equal their sources {copied}; the other blocks untouched {kept}")
    del pool, before

    # -- 6. control loop --------------------------------------------------------
    # the closed DTO-EE loop at full width: the busiest stage-1 replica
    # throttles to 15% of nameplate at 0.2 of the arrival span and stays so
    # past the serve's end (the full-width stages overload this network, so
    # the serve runs several times the arrival span: a recovery at
    # ``get_scenario``'s 2 spans would hand the estimate back to nameplate
    # before the end); the telemetry folds every batch's service into the
    # engine's capacity EWMA, and the controller re-plans p and the
    # thresholds every sixth of the span
    phase("control loop")
    ctrl_prompts = prompts[:CTRL_REQUESTS]
    rate = float(engine.topo.phi_ext.sum())
    span = CTRL_REQUESTS / rate
    scn = node_slowdown(engine.topo, 0.2 * span, 10 * span, p=engine.p)
    victim, factor = scn.events[0].node, scn.events[0].factor
    mu0 = float(engine.topo.mu[victim])
    if victim != busiest_replica(engine.topo, engine.p):
        raise RuntimeError("the slowdown scenario did not pick the busiest stage-1 replica")
    into_victim = float(engine.p[engine.topo.edge_dst == victim].sum())
    ctrl = ReconfigController(Telemetry(engine.topo, TelemetryConfig(window_s=span / 6)),
                              ControllerConfig(interval=span / 6))
    engine.rng = np.random.default_rng(SEED)
    zero_counts()
    t0 = time.perf_counter()
    c_stats = engine.serve(ctrl_prompts, batch_size=BATCH, gen_len=CTRL_GEN, decode_mode="cached",
                           batch_policy="threshold", scenario=scn, controller=ctrl)
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t0
    c_counts = read_counts()
    c_sum = c_stats.summary()
    cap = c_sum["capacity_estimates"][victim]
    actions = dict(Counter(e["action"] for e in ctrl.log))
    print(f"slowdown serve ({CTRL_REQUESTS} requests, {CTRL_GEN} tokens, arrival rate {rate:.3f}/s, "
          f"replica {victim} at {factor} of {mu0:.1f} GFLOP/s from {scn.events[0].time:.4f} s): wall "
          f"{c_wall:.3f} s; reconfigurations {c_stats.num_reconfigs} at "
          f"{[round(t, 4) for t in c_stats.reconfig_times]} s; controller log {actions}; capacity "
          f"estimate of replica {victim} {cap:.2f} GFLOP/s; strategy mass into it {into_victim:.3f} "
          f"before, {float(engine.p[engine.topo.edge_dst == victim].sum()):.3f} after; padded rows "
          f"{c_sum['padded_row_frac']:.1%}; thresholds {engine.thresholds}; simulated makespan "
          f"{max(c_stats.dones) - min(c_stats.arrivals):.2f} s; kernel launches {c_counts}", flush=True)
    check("control loop reconfigured", c_stats.num_reconfigs >= 1, f"{c_stats.num_reconfigs} installs")
    check("control loop completed every request", c_sum["num_completed"] == CTRL_REQUESTS,
          f"{c_sum['num_completed']} of {CTRL_REQUESTS}")
    check("slowed replica's capacity estimate moved toward its slowed rate",
          cap <= (1 + factor) / 2 * mu0, f"{cap:.3f} GFLOP/s, at most halfway from {mu0:.3f} "
          f"(nameplate) to {factor * mu0:.3f} (slowed)")
    for name in ("exit_confidence", "decode_attention", "flash_attention"):
        check(f"{name} launched in the slowdown serve", c_counts[name] > 0, f"{c_counts[name]} launches")

    # fail-stop of the busiest safe stage-1 replica at 0.25 of the span, on
    # the stateless single-shot plane, arrivals 4x faster so that the victim
    # holds queued work when it dies
    scn = get_scenario("failure", engine.topo, p=engine.p, horizon=span / 4, seed=SEED)
    dead = scn.events[0].node
    f_tracer = SpanTracer()
    engine.rng = np.random.default_rng(SEED)
    zero_counts()
    t0 = time.perf_counter()
    f_stats = engine.serve(ctrl_prompts, arrival_rate=4 * rate, batch_size=BATCH, scenario=scn,
                           tracer=f_tracer)
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t0
    f_counts = read_counts()
    dec = decompose(f_tracer, f_stats)
    open_trees = [rid for rid in f_stats.rids if f_tracer.check_tree(rid)]
    print(f"failure serve ({CTRL_REQUESTS} requests, one token, replica {dead} dead at "
          f"{scn.events[0].time:.4f} s): wall {f_wall:.3f} s; re-executed {f_stats.resubmitted}, "
          f"{dec['num_with_lost_time']} with lost time; exits {f_stats.summary()['exit_histogram']}; "
          f"kernel launches {f_counts}", flush=True)
    check("failure serve completed every request", len(f_stats.delays) == CTRL_REQUESTS
          and dead not in set(engine.topo.edge_dst.tolist()),
          f"{len(f_stats.delays)} of {CTRL_REQUESTS}; replica {dead} dropped from the view")
    check("failure serve's span trees all closed", not open_trees and dec["reconciles"],
          f"{len(open_trees)} trees with violations; max residual {dec['max_residual_s']!r} s")
    for name in ("exit_confidence", "flash_attention"):
        check(f"{name} launched in the failure serve", f_counts[name] > 0, f"{f_counts[name]} launches")
    del f_tracer

    # -- 7. glm4-9b --------------------------------------------------------------
    phase("glm4-9b serve")
    w_lm = params["lm_head"]  # phase 8 times the exit head on stablelm's LM head
    del engine, programs, params, store, caches, outs, x1, x_dec, y_t, y_c, y_f, yp_t, yp_c
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g_params = model_lib.init_params(glm, torch.Generator(device=dev).manual_seed(SEED), dev)
    g_profile = profile_from_arch(glm)
    g_engine = CollaborativeEngine(
        g_params, glm,
        build_edge_network(seed=0, profile=g_profile, spec=NetworkSpec(num_eds=4, es_per_stage=(2, 2))),
        g_profile, synthetic_validation(seed=1, profile=g_profile), DtoHyperParams(), seed=SEED,
        device=dev,
    )
    g_engine.configuration_phase()
    torch.cuda.synchronize()
    g_n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(g_params))
    g_prompts = [tok for _, tok in poisson_requests(glm, rcfg, duration=60.0)][:GLM_REQUESTS]
    if len(g_prompts) != GLM_REQUESTS:
        raise RuntimeError(f"request stream gave {len(g_prompts)} prompts")
    print(f"glm4-9b full width: {glm.num_layers} layers, d {glm.d_model}, {g_hq} query heads over "
          f"{g_kvh} KV heads of {g_hd}, d_ff {glm.d_ff}, vocab {glm.vocab_size}; {g_n / 1e9:.3f} B "
          f"params; set-up {time.perf_counter() - t0:.1f} s; prompts {GLM_REQUESTS}, lengths "
          f"{min(map(len, g_prompts))}..{max(map(len, g_prompts))}", flush=True)
    g_runs = {}
    for layout, kw in (("dense", {}),
                       ("paged", {"cache_layout": "paged", "block_size": BLOCK, "prefix_sharing": False})):
        torch.cuda.reset_peak_memory_stats()
        g_engine.rng = np.random.default_rng(SEED)
        zero_counts()
        t0 = time.perf_counter()
        g_stats = g_engine.serve(g_prompts, arrival_rate=1e4, batch_size=BATCH, gen_len=GLM_GEN,
                                 decode_mode="cached", **kw)
        torch.cuda.synchronize()
        g_wall = time.perf_counter() - t0
        g_counts = read_counts()
        g_sum = g_stats.summary()
        g_runs[layout] = g_stats.sequences_by_rid()
        print(f"glm4-9b {layout} serve: wall {g_wall:.3f} s; generated tokens {g_sum['generated_tokens']}; "
              f"{g_sum['generated_tokens'] / g_wall:.1f} tokens/s; batches {g_sum['num_batches']}; exit "
              f"histogram {g_sum['exit_histogram']}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {g_counts}", flush=True)
        check(f"glm4-9b {layout} serve completed", g_sum["num_completed"] == GLM_REQUESTS,
              f"{g_sum['num_completed']} of {GLM_REQUESTS}")
        names = (("exit_confidence", "decode_attention", "flash_attention") if layout == "dense"
                 else ("paged_decode_attention",))
        for name in names:
            check(f"glm4-9b {layout} serve launched {name}", g_counts[name] > 0,
                  f"{g_counts[name]} launches")
    diverged = [r for r, v in g_runs["paged"].items() if g_runs["dense"].get(r) != v]
    check("glm4-9b paged serve tokens and exits equal the dense serve's",
          not diverged and len(g_runs["dense"]) == GLM_REQUESTS,
          f"{len(diverged)} of {GLM_REQUESTS} requests differ")
    del g_engine, g_params
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. times -------------------------------------------------------------
    phase("times (device time from the profiler, cold L2, mean over launches)")
    flush = L2Flush(dev)
    kernels_out = []

    h = torch.randn((BATCH, d), generator=gen, device=dev).bfloat16()

    def library_head():
        logits = torch.matmul(h, w_lm).float()
        return logits.max(-1).values, torch.logsumexp(logits, -1), logits.argmax(-1)

    # the kernel and its library yardstick in turns (kernel, library,
    # library, kernel, twice): the medians of 4 readings each
    head_ms = {"kernel": [], "library": []}
    for _ in range(2):
        for tag, fn in (("kernel", lambda: kexit.exit_confidence(h, w_lm)), ("library", library_head),
                        ("library", library_head), ("kernel", lambda: kexit.exit_confidence(h, w_lm))):
            head_ms[tag].append(time_cold(fn, 50, flush))
    t_k, t_l = (float(np.median(head_ms[tag])) for tag in ("kernel", "library"))
    t_p = time_cold(lambda: ref.exit_confidence_ref(h, w_lm), 10, flush)
    bytes_ = d * V * 2 + BATCH * d * 2 + BATCH * 8
    flops = 2 * BATCH * d * V
    b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
    print(f"exit_confidence B={BATCH} d={d} V={V}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"library (bf16 matmul + max/logsumexp/argmax) {t_l:.4f} ms, bound {max(b_bytes, b_ops):.4f} ms "
          f"({'bytes' if b_bytes >= b_ops else 'operations'}: {bytes_ / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    print("  in turns, ms: " + "; ".join(
        f"{tag} {' '.join(f'{t:.5f}' for t in ts)} (median {np.median(ts):.5f}, spread "
        f"{max(ts) - min(ts):.5f})" for tag, ts in head_ms.items()))
    h1 = h[:1].contiguous()
    t_k1 = time_cold(lambda: kexit.exit_confidence(h1, w_lm), 50, flush)
    print(f"exit_confidence B=1: kernel {t_k1:.4f} ms")
    kernels_out.append({
        "name": "exit_confidence", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/exit_confidence.cu",
        "replaces": "src/repro/kernels/exit_confidence.py:111",
        "launches": launches["exit_confidence"], "max_abs_err": max_err["exit_confidence"],
        "ms": t_k, "plain_ms": t_p, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations", "library_ms": t_l,
    })

    q, k, v, ln = dec_inputs(BATCH, max_len, Hq, KVH, hd, dec_lengths)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [B, KVH, S, hd] views
    mask = (torch.arange(max_len, device=dev)[None, :] < ln[:, None])[:, None, None, :]

    def library_decode():
        return F.scaled_dot_product_attention(q[:, :, None, :], kt, vt, attn_mask=mask)

    lib_err = float((library_decode()[:, :, 0].float()
                     - ref.decode_attention_ref(q, k, v, ln).float()).abs().max())
    t_k = time_cold(lambda: kdec.decode_attention(q, k, v, ln), 200, flush)
    t_p = time_cold(lambda: ref.decode_attention_ref(q, k, v, ln), 50, flush)
    t_l = time_cold(library_decode, 200, flush)
    tot = int(sum(dec_lengths))
    bytes_ = 2 * tot * KVH * hd * 2 + 2 * BATCH * Hq * hd * 2 + BATCH * 4
    flops = 4 * tot * Hq * hd
    b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
    print(f"decode_attention B={BATCH} S={max_len} Hq={Hq} KVH={KVH} hd={hd} lengths {dec_lengths}: "
          f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library (SDPA, length mask; max|diff| vs plain "
          f"{lib_err:.3g}) {t_l:.4f} ms, bound {max(b_bytes, b_ops):.5f} ms "
          f"({'bytes' if b_bytes >= b_ops else 'operations'}: {bytes_ / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
    kernels_out.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:124",
        "launches": launches["decode_attention"], "max_abs_err": max_err["decode_attention"],
        "ms": t_k, "plain_ms": t_p, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations", "library_ms": t_l,
    })

    # paged: the kernel at bs 16 and 1 on shuffled blocks, the plain version,
    # and for comparison the dense kernel and SDPA on the gathered cache
    # (SDPA timed with the gather: no single PyTorch call reads a block table)
    paged_ms = {}
    for bs in (BLOCK, 1):
        q, kp, vp, table, ln = paged_inputs(BATCH, Hq, KVH, hd, bs, dec_lengths, n_log[bs])
        paged_ms[bs] = time_cold(lambda: kpaged.paged_decode_attention(q, kp, vp, table, ln,
                                                                        seq_len=max_len), 200, flush)
        if bs == BLOCK:
            t_p = time_cold(lambda: ref.paged_decode_attention_ref(q, kp, vp, table, ln,
                                                                  seq_len=max_len), 50, flush)
            kg, vg = gathered(kp, table, max_len), gathered(vp, table, max_len)
            t_dense = time_cold(lambda: kdec.decode_attention(q, kg, vg, ln), 200, flush)
            mask = (torch.arange(max_len, device=dev)[None, :] < ln[:, None])[:, None, None, :]

            def gather_sdpa():
                kt = gathered(kp, table, max_len).transpose(1, 2)
                vt = gathered(vp, table, max_len).transpose(1, 2)
                return F.scaled_dot_product_attention(q[:, :, None, :], kt, vt, attn_mask=mask)

            t_sdpa = time_cold(gather_sdpa, 200, flush)
            blocks_read = sum(-(-n // bs) for n in dec_lengths)
            bytes_ = 2 * tot * KVH * hd * 2 + blocks_read * 4 + 2 * BATCH * Hq * hd * 2 + BATCH * 4
            flops = 4 * tot * Hq * hd
            b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
    print(f"paged_decode_attention B={BATCH} Hq={Hq} KVH={KVH} hd={hd} lengths {dec_lengths}, "
          f"shuffled blocks: kernel {paged_ms[BLOCK]:.4f} ms at bs {BLOCK} (n_logical {n_log[BLOCK]}), "
          f"{paged_ms[1]:.4f} ms at bs 1 (n_logical {n_log[1]}); plain {t_p:.4f} ms; dense kernel on "
          f"the gathered cache {t_dense:.4f} ms; gather + SDPA {t_sdpa:.4f} ms; bound "
          f"{max(b_bytes, b_ops):.5f} ms ({'bytes' if b_bytes >= b_ops else 'operations'}: "
          f"{bytes_ / 1e6:.2f} MB with {blocks_read} table entries, {flops / 1e6:.1f} MFLOP)")
    kernels_out.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_decode_attention.py:148",
        "launches": launches_paged["paged_decode_attention"],
        "max_abs_err": max_err["paged_decode_attention"],
        "ms": paged_ms[BLOCK], "plain_ms": t_p, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations", "library_ms": None,
    })

    # both decode kernels at G 5 and G 6 (hd 128), at the serve's lengths and
    # on the long cache
    for name, (hq, kvh, hd_) in GQA_HEADS.items():
        for label, S, lengths in gqa_lengths:
            q, k, v, ln = dec_inputs(BATCH, S, hq, kvh, hd_, lengths)
            args = paged_inputs(BATCH, hq, kvh, hd_, BLOCK, lengths, -(-S // BLOCK))
            iters = 200 if S == max_len else 100
            t_k = time_cold(lambda: kdec.decode_attention(q, k, v, ln), iters, flush)
            t_pg = time_cold(lambda: kpaged.paged_decode_attention(*args, seq_len=S), iters, flush)
            t_p = time_cold(lambda: ref.decode_attention_ref(q, k, v, ln), iters // 10, flush)
            mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None, None, :]
            t_l = time_cold(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=True), iters, flush)
            tot = int(sum(lengths))
            bytes_ = 2 * tot * kvh * hd_ * 2 + 2 * BATCH * hq * hd_ * 2 + BATCH * 4
            flops = 4 * tot * hq * hd_
            b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
            print(f"{name} decode G={hq // kvh} {label} B={BATCH} S={S} Hq={hq} KVH={kvh} hd={hd_} "
                  f"lengths {min(lengths)}..{max(lengths)}: decode_attention {t_k:.4f} ms, "
                  f"paged_decode_attention (bs {BLOCK}) {t_pg:.4f} ms, plain {t_p:.4f} ms, library "
                  f"(SDPA, length mask, GQA) {t_l:.4f} ms, bound {max(b_bytes, b_ops):.5f} ms "
                  f"({'bytes' if b_bytes >= b_ops else 'operations'}: {bytes_ / 1e6:.2f} MB, "
                  f"{flops / 1e6:.1f} MFLOP)", flush=True)
            del q, k, v, args

    # both decode kernels at glm4-9b's shapes (G 16, hd 128)
    q, k, v, ln = dec_inputs(BATCH, g_len, g_hq, g_kvh, g_hd, GLM_LENGTHS)
    t_k = time_cold(lambda: kdec.decode_attention(q, k, v, ln), 200, flush)
    args = paged_inputs(BATCH, g_hq, g_kvh, g_hd, BLOCK, GLM_LENGTHS, n_log_g)
    t_pg = time_cold(lambda: kpaged.paged_decode_attention(*args, seq_len=g_len), 200, flush)
    t_p = time_cold(lambda: ref.decode_attention_ref(q, k, v, ln), 50, flush)
    mask = (torch.arange(g_len, device=dev)[None, :] < ln[:, None])[:, None, None, :]
    t_l = time_cold(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True),
        200, flush)
    tot = int(sum(GLM_LENGTHS))
    bytes_ = 2 * tot * g_kvh * g_hd * 2 + 2 * BATCH * g_hq * g_hd * 2 + BATCH * 4
    flops = 4 * tot * g_hq * g_hd
    b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
    print(f"glm4-9b decode B={BATCH} S={g_len} Hq={g_hq} KVH={g_kvh} hd={g_hd} lengths {GLM_LENGTHS}: "
          f"decode_attention {t_k:.4f} ms, paged_decode_attention (bs {BLOCK}) {t_pg:.4f} ms, plain "
          f"{t_p:.4f} ms, library (SDPA, length mask, GQA) {t_l:.4f} ms, bound "
          f"{max(b_bytes, b_ops):.5f} ms ({'bytes' if b_bytes >= b_ops else 'operations'}: "
          f"{bytes_ / 1e6:.3f} MB, {flops / 1e6:.1f} MFLOP)")

    # both decode kernels on the long cache (S 4096), at glm4-9b's heads and
    # at stablelm-1.6b's
    for name, (hq, kvh, hd_) in long_heads.items():
        q, k, v, ln = dec_inputs(BATCH, LONG_S, hq, kvh, hd_, LONG_LENGTHS)
        t_k = time_cold(lambda: kdec.decode_attention(q, k, v, ln), 100, flush)
        t_pg = time_cold(lambda: kpaged.paged_decode_attention(*long_paged[name], seq_len=LONG_S),
                         100, flush)
        t_p = time_cold(lambda: ref.decode_attention_ref(q, k, v, ln), 10, flush)
        mask = (torch.arange(LONG_S, device=dev)[None, :] < ln[:, None])[:, None, None, :]
        t_l = time_cold(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True),
            100, flush)
        tot = int(sum(LONG_LENGTHS))
        bytes_ = 2 * tot * kvh * hd_ * 2 + 2 * BATCH * hq * hd_ * 2 + BATCH * 4
        flops = 4 * tot * hq * hd_
        b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
        print(f"{name} long-cache decode G={hq // kvh} B={BATCH} S={LONG_S} Hq={hq} KVH={kvh} hd={hd_} "
              f"lengths {LONG_LENGTHS}: decode_attention {t_k:.4f} ms, paged_decode_attention (bs "
              f"{BLOCK}) {t_pg:.4f} ms, plain {t_p:.4f} ms, library (SDPA, length mask, GQA) {t_l:.4f} "
              f"ms, bound {max(b_bytes, b_ops):.5f} ms ({'bytes' if b_bytes >= b_ops else 'operations'}: "
              f"{bytes_ / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
        del q, k, v

    # prefill flash attention at every timed shape; the first is the entry.
    # At the two B 8 shapes the kernel and SDPA are timed in turns (medians
    # of 4), each reading printed with its launches' spread: one reading in
    # a run has come out 2x off before.
    for n_shape, (label, B, S, hq, kvh, hd_) in enumerate(FLASH_SHAPES):
        q, k, v = flash_inputs(B, S, S, hq, kvh, hd_)

        def library_flash():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), is_causal=True, enable_gqa=True)

        lib_err = float((library_flash().transpose(1, 2).float()
                         - ref.flash_attention_ref(q, k, v).float()).abs().max())
        def kernel_flash():
            return kflash.flash_attention(q, k, v)

        turns = [("kernel", kernel_flash), ("library", library_flash)]
        if B == BATCH:
            turns = (turns + turns[::-1]) * 2
        readings = {"kernel": [], "library": []}
        for tag, fn in turns:
            st = {}
            readings[tag].append((time_cold(fn, 100, flush, stats=st), launch_summary(st)))
        t_k, t_l = (float(np.median([ms for ms, _ in readings[tag]])) for tag in ("kernel", "library"))
        t_p = time_cold(lambda: ref.flash_attention_ref(q, k, v), 10, flush)
        bytes_ = 2 * q.numel() * 2 + 2 * k.numel() * 2  # q and out, k and v
        flops = 4 * B * hq * hd_ * (S * (S + 1) // 2)  # QK^T and PV over the causal triangle
        b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
        print(f"flash_attention {label} B={B} S={S} Hq={hq} KVH={kvh} hd={hd_}: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, library (SDPA, is_causal, enable_gqa; max|diff| vs plain "
              f"{lib_err:.3g}) {t_l:.4f} ms, bound {max(b_bytes, b_ops):.5f} ms "
              f"({'bytes' if b_bytes >= b_ops else 'operations'}: {bytes_ / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)")
        for tag, rs in readings.items():
            for ms, summary in rs:
                print(f"  {tag} {ms:.5f} ms: {summary}")
        if n_shape == 0:
            kernels_out.append({
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:172",
                "launches": launches["flash_attention"], "max_abs_err": max_err["flash_attention"],
                "ms": t_k, "plain_ms": t_p, "bound_ms": max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations", "library_ms": t_l,
            })

    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
