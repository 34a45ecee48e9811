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
     3 and 1, at the serve's lengths and on the 4096-key cache; both also at
     G 32 and G 24 (64 and 48 query heads over 2 KV heads of 128), launched
     in chunks of at most 16 query heads per KV head, dense and paged at
     block sizes 16, 3 and 1); the exit head at all five LM heads (B 1, 8,
     32 and 65, the last in two passes over w), with fewer vocab columns
     than a unit per CTA and with a tie across a CTA boundary; plus edge cases;
     zamba2-2.7b's attention at head dim 80 (32 query heads over 32 KV
     heads) in all three attention kernels: decode dense and paged (bs 16
     and 1) at the zamba2 serve's lengths and on the 4096-key cache, flash
     at a prefill batch of B 8, S 104 and at a 2048-token prompt (with the
     f64 check); the exit head at zamba2-2.7b's (d 2560, V 32000) and
     xlstm-350m's (d 1024, V 50304) LM heads at B 1, 8 and 32 (these from
     a generator of their own, so every earlier gate keeps its inputs);
     from another generator of their own: flash at phi-3-vision-4.2b's
     head dim 96 (32 heads over 32; B 8, S 104 and a 2048-token prompt,
     with the f64 check, and in f32 at B 2, S 512), flash at mixtral-8x7b's
     heads (32 over 8 of 128) under its 4096-key window at 4160 and 8192
     tokens, both decode kernels at mixtral's G 4, hd 128 (dense and paged
     at bs 16, 3 and 1) at its serve's lengths and on the 4096-key cache,
     and the exit head at the LM heads of mixtral-8x7b (d 4096, V 32000),
     phi-3-vision-4.2b (d 3072, V 32064) and musicgen-medium (d 1536, V
     2048) at B 1, 8 and 32;
     each gate must also reject faults planted on the same inputs;
     the paged kernel is also held bit for bit to the dense kernel on the
     gathered cache;
  4. serve  — ``CollaborativeEngine.serve`` of 32 Poisson requests through
     full-width stablelm-1.6b (24 layers, random weights from a seed),
     cached decode, 16 tokens each; the launch counts of the exit, decode
     and flash kernels over this run must be non-zero, and the exit kernel's
     one per head call (every call at most 64 rows); then one full-width
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
  7. larger configs, one at a time, each after the previous model's
     weights are freed (the process's peak printed): full-width glm4-9b (40
     layers, d 4096, 32 query heads over 2 KV heads of 128) serves 16 Poisson
     requests, 8 tokens each; full-width deepseek-v2-lite-16b (27 layers, d
     2048, MLA of 16 heads with kv_lora 512 and rope 64, 64 experts top-6 + 2
     shared; ~16.2 B parameters) 16 requests of 8 tokens; full-width
     internlm2-20b (48 layers, d 6144, G 6) and qwen2.5-32b (64 layers, d
     5120, G 5, QKV bias; ~65.5 GB of bf16 weights) 8 requests of 8 tokens
     each.  Every model serves dense and then paged (block 16): every
     request completes, each serve launches the kernels of its path, the
     exit kernel once per head call (deepseek:
     the exit head only, and neither decode kernel nor flash, since MLA has
     none in the reference either), and the paged serve's tokens and exits
     equal the dense serve's; a short deepseek serve runs under the
     profiler (device busy share, device time by kernel); one full-width
     deepseek ``moe_attn`` layer
     (prefill B 2, S 16, then one ragged decode token) runs on the card and on
     the CPU with the same weights, norm-wise within 2^-7 and with the
     routers' top-6 choices agreeing on >= 99% of (token, choice) pairs;
     then full-width zamba2-2.7b (54 layers: 9 periods of five Mamba2 blocks
     and a dense attention block; the attention kernels at hd 80) and
     xlstm-350m (24 layers of mLSTM and sLSTM blocks, no attention: the exit
     head's kernel only, neither decode kernel nor flash), 16 requests of 8
     tokens each, dense and paged, a short serve of each profiled, and one
     full-width period of each one's recurrent blocks (zamba2's first Mamba2
     block; xlstm's mLSTM and sLSTM blocks) on the card and on the CPU with
     the same weights, norm-wise within 2^-7; then the three configs of
     the batched steps (``serving.steps.make_prefill_step`` /
     ``make_decode_step``), one at a time: full-width phi-3-vision-4.2b (32
     layers, hd 96; embeddings [4, 512, 3072]) and musicgen-medium (48
     layers, 5 stages; LayerNorm and the tanh-gelu MLP; embeddings [8, 256,
     1536]), each a prefill and 8 decode steps (flash once per layer of the
     prefill, the exit head once per head call, the decode kernel once per
     layer and step where the caches are full at a head dim it takes:
     musicgen's, not phi-3's hd 96 or mixtral's ring), and one
     full-width block of each prefilled on the card and on the CPU,
     norm-wise within 2^-7; mixtral-8x7b at full width and half depth (16
     layers, ~23.5 B parameters) served dense and paged through the engine
     (16 requests of 8 tokens; paged == dense), then one 4160-token prompt
     through the steps, whose prefill leaves a ring of the window's 4096
     slots that 8 decode steps wrap, held to a witness with full caches
     under the window mask (tokens equal, the last hidden norm-wise within
     2^-7);
  8. times  — each kernel at the serve's shapes (device time from the
     profiler, cold L2) beside its bound, its plain version and one library
     yardstick (none computes the paged function in one call; the exit head
     and its yardstick timed in turns at every model's LM head, at B 1, 8
     and 32, medians of 4, each beside its share of the bound); the flash
     kernel also at glm4-9b's heads and at 2048-token prompts (at B 8 in
     turns with SDPA, medians of 4, each reading with its launches'
     spread), both
     decode kernels also at glm4-9b's shapes, on the 4096-key cache at
     either's heads, and at G 5, 6, 24 and 32 at the serve's lengths and on
     the 4096-key cache; the exit head also at zamba2-2.7b's and
     xlstm-350m's LM heads; all three attention kernels at zamba2-2.7b's
     heads (hd 80): both decode kernels at its serve's lengths and on the
     4096-key cache, flash at its prefill batch (in turns with SDPA) and at
     a 2048-token prompt; the same at phi-3-vision's heads (hd 96), flash
     under mixtral's window at 4160 and 8192 tokens (SDPA given the band as
     a mask), both decode kernels at mixtral's G 4, and the exit head at the
     three new LM heads;
  8b. split partials — (``split_phase``, from a generator of its own) the
     decode kernel's optional f32 output and log-sum-exp at G 1, 4 and 16
     and head dims 64, 80 and 128, at the serve's lengths and on a 4096-key
     cache with a row of length 0 (against the f32-score plain version and
     the plain version; rounded, bit for bit the null-output call's); a
     4096-key cache cut into 2, 3 and 8 sequence shards on one card, each
     shard's partial by the kernel, combined (``ops.combine_partials``)
     against the unsplit kernel; the exit kernel's max logit, and
     stablelm-1.6b's LM head cut into 2, 4 and 16 vocab blocks, each
     block's partial by the kernel, combined
     (``ops.combine_exit_partials``) against the unsplit kernel (conf atol
     1e-3 and rtol 1e-4, the argmax exact, a planted tie across blocks kept
     at its first column); three planted faults, each rejected (a combine
     without the lse weights, shard lengths without the shard's offset, an
     argmax without its block's offset); and the decode kernel at
     stablelm's serve lengths and on the 4096-key cache and the exit head at
     stablelm's head (B 8) with the new outputs, in turns with the
     null-output calls, each within 3% of them; then phi-3-vision-4.2b's LM
     head cut into its 16 vocab blocks of 2004 columns (what a 16-wide
     "model" axis gives each device: rows of 4008 bytes, which the exit
     kernel copies in 8-byte cp.async pieces, ``exit_confidence.w_piece``)
     and into blocks of 2003, 2002 and 28059 columns (2-, 4- and 2-byte
     pieces), each
     block's partial against the plain version, each split's combine
     against the unsplit kernel (conf atol 1e-3 and rtol 1e-4, the argmax
     exact, row 0's top at a block's last column), a block read without its
     last column rejected; and one 2004-wide block timed at B 1, 8 and 32
     in turns with its library yardstick;
  9. train  — full-width stablelm-1.6b trained for 6 steps through
     ``training.make_train_step`` (f32 masters, B 8 x S 512, AdamW;
     ``train_phase``): finite losses and gradients, a nonzero gradient in
     every stage's Q/K/V projections (Q, K and V detached rejected), no
     kernel launched over the steps nor in a profiled 7th, one full-width
     period's gradients on the card against the CPU at 2^-7 (a zeroed
     gradient rejected), and step 6's state through ``CheckpointManager``
     bit for bit; prints the step's wall, tokens/s, peak memory and FLOP
     share.

  10. multi-device — (``multidevice_phase``) an NCCL group of world size 1
     and ``launch.mesh.make_host_mesh()`` on the card: (a) full-width
     stablelm-1.6b's batched prefill (B 8) and 8 decode steps with the
     parameters laid out by the ``as_serving`` specs and the batch and
     caches by theirs, against the same steps without a mesh: tokens and
     exit stages bit for bit, and the same nonzero launches of flash,
     decode and the exit head; (b) one full-width train step (B 8 x S 512,
     masters and AdamW state by ``param_specs``) against the step without a
     mesh: loss and grad norm bit for bit, masters at atol 1e-6 (a step
     that skipped its update is shown to fail that), its peak memory against
     the dry run's prediction for that cell on a 1 x 1 mesh within 15%; (c)
     the int8 compressed step on a (1,1,1) ("pod", "data", "model") mesh:
     finite loss, masters equal to AdamW's step from its own moments by hand
     at atol 1e-6, and the gradient those moments carry plus the int8
     residual equal to the uncompressed step's at 2^-7; (d) the dry run in a
     subprocess (started before phase 9, on the host's CPU): gates of
     stablelm-1.6b train_4k and decode_32k and mixtral-8x7b at all 32
     layers decode_32k on pod16x16, one measured cell (stablelm decode_32k)
     with its roofline row, and the 1 x 1 prediction of (b); and the cells
     whose decode gathered the sequence-split KV cache before the split-KV
     decode (``DAGGER_PEAKS``: nine archs' decode_32k, zamba2's and
     mixtral's long_500k) measured through the dry run's CLI (three cells
     at a time, started with phase 8): none bound by its collectives,
     none's peak above its earlier reading, stablelm decode_32k's
     collective term under 5 ms and phi-3-vision-4.2b's under 0.1 ms (its
     vocab-split head no longer gathered) with a peak of at most 7.5 GB; and
     xlstm-350m's train_4k and prefill_32k on pod16x16 through the CLI
     (started with phase 9, both at once, 240 s each), which the counted
     sLSTM scan lets finish.
  11. examples — ``examples/torch_quickstart.py`` (60 train steps) and
     ``examples/torch_failover_elastic.py`` on the card, each in a process
     of its own (the two at once), each ending in its closing line.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits 2.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
from collections import Counter
import re
import shutil
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
DEEPSEEK_REQUESTS, DEEPSEEK_GEN = 16, 8  # the deepseek-v2-lite-16b serves
LARGE_REQUESTS, LARGE_GEN = 8, 8  # the internlm2-20b and qwen2.5-32b serves
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
# (query heads, KV heads, head dim) of qwen2.5-32b (G 5) and internlm2-20b (G 6)
GQA_HEADS = {"qwen2.5-32b": (40, 8, 128), "internlm2-20b": (48, 8, 128)}
# G above the walk's 16 rows: the wrappers launch chunks of at most 16 query
# heads per KV head
WIDE_HEADS = {"G 32": (64, 2, 128), "G 24": (48, 2, 128)}
CTRL_REQUESTS, CTRL_GEN = 16, 8  # the control-loop serves
SSM_REQUESTS, SSM_GEN = 16, 8  # the zamba2-2.7b and xlstm-350m serves
# flash_attention at zamba2-2.7b's heads (hd 80): (label, B, S, Hq, KVH, hd)
ZAMBA_FLASH = (
    ("zamba2-2.7b's prefill batch", 8, 104, 32, 32, 80),
    ("one 2048-token prompt at zamba2-2.7b's heads", 1, 2048, 32, 32, 80),
)
# flash_attention at phi-3-vision-4.2b's heads (hd 96): (label, B, S, Hq, KVH, hd)
PHI_FLASH = (
    ("phi-3-vision-4.2b's prefill batch", 8, 104, 32, 32, 96),
    ("one 2048-token prompt at phi-3-vision-4.2b's heads", 1, 2048, 32, 32, 96),
)
# flash_attention at mixtral-8x7b's heads (G 4, hd 128) under its 4096-key
# window, which bites past 4096 tokens: (label, B, S, Hq, KVH, hd, window)
MIXTRAL_FLASH = (
    ("one 4160-token prompt at mixtral-8x7b's heads, window 4096", 1, 4160, 32, 8, 128, 4096),
    ("one 8192-token prompt at mixtral-8x7b's heads, window 4096", 1, 8192, 32, 8, 128, 4096),
)
MIXTRAL_LAYERS = 16  # mixtral-8x7b cut to half depth: ~23.5 B parameters, one H100
MIXTRAL_REQUESTS, MIXTRAL_GEN = 16, 8  # its engine serves
MIXTRAL_PROMPT, STEPS_DECODE = 4160, 8  # its batched steps: one prompt past the window
# the embeds configs' batched steps: (B, prompt length) of random embeddings
EMBEDS_STEPS = {"phi-3-vision-4.2b": (4, 512), "musicgen-medium": (8, 256)}
# the train phase: full-width stablelm-1.6b, f32 masters, AdamW
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 6
TRAIN_PERIOD_B, TRAIN_PERIOD_S = 2, 256  # the period held card vs CPU
# the multi-device phase: full-width stablelm-1.6b's batched steps on a 1 x 1
# mesh (prefill B 8 of MD_PROMPT tokens, then MD_DECODE decode steps)
MD_B, MD_PROMPT, MD_DECODE = 8, 128, 8
# its dry-run cells on pod16x16 (gates), the measured one, and the 1 x 1
# train cell whose predicted peak phase 10 (b) is held to within 15%
MD_GATES = (("stablelm-1.6b", "train_4k"), ("stablelm-1.6b", "decode_32k"),
            ("mixtral-8x7b", "decode_32k"))
MD_MEASURE = ("stablelm-1.6b", "decode_32k")
MD_PEAK_TOL = 0.15
# phase 10 (b): the sharded step's masters against the step without a mesh
# (f32 rounding apart: measured 6.41e-08 on the H100); (c): the compressed
# step's masters against AdamW's step by hand from its own moments
MD_MASTER_ATOL = 1e-6
# phase 10 (c): the gradient the compressed step's moments carry, plus its
# int8 residual, against the uncompressed step's, norm-wise per leaf (the
# training gradient tolerance)
MD_GRAD_RTOL = 2.0**-7
# the device functions of the port's kernels, as the profiler names them
KERNEL_FUNCTIONS = ("exit_tile_kernel", "exit_combine_kernel", "flash_wgmma_kernel",
                    "flash_simple_kernel", "decode_attention_kernel",
                    "paged_decode_attention_kernel", "combine_kernel")


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


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
            args = ",".join(re.findall(r"L[ib](\d+)E", raw))
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


def profiled_serve(engine, prompts, label: str, gen_len: int = 4):
    """A short serve of ``prompts`` under ``torch.profiler`` (the profiler's
    own overhead is inside its wall time, so the busy share is a lower
    bound): prints its wall, the device's busy share and the eight kernels
    with the most device time; returns ([(kernel, device us)], busy us).
    Only the device is recorded: the host ops' events of a recurrent
    model's serve take minutes to parse, and nothing here reads them."""
    engine.rng = np.random.default_rng(SEED)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(prompts, batch_size=BATCH, gen_len=gen_len, decode_mode="cached")
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    # device-side rows only, as in device_launches
    by_kernel = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in by_kernel)
    if busy_us == 0:
        print(f"{label} profiled serve: device time not measured (the profiler recorded no device "
              f"events)")
    else:
        print(f"{label} profiled serve ({len(prompts)} requests, {gen_len} tokens): wall {wall_prof:.3f} "
              f"s, device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall_prof:.1%} of wall")
        for key, t in sorted(by_kernel, key=lambda kv: -kv[1])[:8]:
            print(f"  {t / busy_us:6.1%}  {t / 1e3:9.3f} ms  {key[:90]}")
    sys.stdout.flush()
    return by_kernel, busy_us


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
    device_kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device {device_kind} "
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

    def head_inputs(B, d_, V_, g=gen):
        """Logits ~ N(0, 1) with row b's target column raised by 8: a clear
        top-1 margin, and a confidence well below 1 at V = 100352."""
        h = torch.randn((B, d_), generator=g, device=dev)
        w = torch.randn((d_, V_), generator=g, device=dev) / math.sqrt(d_)
        tgt = torch.randperm(V_, generator=g, device=dev)[:B]
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
    # the LM-head shapes of the three configs served after glm4-9b: each
    # held to the plain version at B 1 and at a full batch, and each gate
    # shown to reject the dropped tile.  Drawn from a generator of their
    # own, so every later phase's inputs stay what they were before these
    # gates came.
    head_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for arch in ("deepseek-v2-lite-16b", "internlm2-20b", "qwen2.5-32b"):
        acfg = get_config(arch)
        d_, V_ = acfg.d_model, acfg.vocab_size
        for B in (1, BATCH):
            h, w = head_inputs(B, d_, V_, head_gen)
            c, i = kexit.exit_confidence(h, w)
            cr, ir = ref.exit_confidence_ref(h, w)
            ok, err, rel = conf_close(c, cr)
            check(f"exit_confidence {arch}'s head B={B} d={d_} V={V_}", ok and torch.equal(i, ir),
                  f"conf max|err| {err:.3g} (atol 1e-3), max rel err {rel:.3g} (rtol 1e-4), argmax "
                  f"equal {torch.equal(i, ir)}")
            max_err["exit_confidence"] = max(max_err["exit_confidence"], err)
        c_f, _ = kexit.exit_confidence(h, w[:, : V_ - 256].contiguous())
        ok, err, rel = conf_close(c_f, cr)
        check(f"exit_confidence gate rejects a dropped vocab tile at d={d_} V={V_}", not ok,
              f"conf max|err| {err:.3g}, max rel err {rel:.3g}")
        del h, w, c_f
    # glm4-9b's head (d 4096, V 151552) at B 1 and 8 with the dropped-tile
    # fault, and every LM head at B 32 (one pass over w, N 32) and 65 (two
    # passes: 64 rows, then 1), from the same generator after the gates
    # above, so that their inputs stay as they were
    head_shapes = {arch: (get_config(arch).d_model, get_config(arch).vocab_size)
                   for arch in ("stablelm-1.6b", "glm4-9b", "deepseek-v2-lite-16b", "internlm2-20b",
                                "qwen2.5-32b")}
    for arch, (d_, V_) in head_shapes.items():
        for B in ((1, BATCH, 32, 65) if arch == "glm4-9b" else (32, 65)):
            h, w = head_inputs(B, d_, V_, head_gen)
            n0 = kexit.exit_confidence.launches
            c, i = kexit.exit_confidence(h, w)
            passes = kexit.exit_confidence.launches - n0
            cr, ir = ref.exit_confidence_ref(h, w)
            ok, err, rel = conf_close(c, cr)
            check(f"exit_confidence {arch}'s head B={B} d={d_} V={V_}",
                  ok and torch.equal(i, ir) and passes == -(-B // kexit.MAX_ROWS),
                  f"{passes} launches; conf max|err| {err:.3g} (atol 1e-3), max rel err {rel:.3g} "
                  f"(rtol 1e-4), argmax equal {torch.equal(i, ir)}")
            max_err["exit_confidence"] = max(max_err["exit_confidence"], err)
        if arch == "glm4-9b":
            c_f, _ = kexit.exit_confidence(h, w[:, : V_ - 256].contiguous())
            ok, err, rel = conf_close(c_f, cr)
            check(f"exit_confidence gate rejects a dropped vocab tile at d={d_} V={V_}", not ok,
                  f"conf max|err| {err:.3g}, max rel err {rel:.3g}")
            del c_f
        del h, w
    # fewer vocab columns than a 64-column unit per CTA (most CTAs' ranges
    # empty), and a tie across a CTA boundary: equal top logits at the last
    # column of one CTA's range, the first of the next and the first of the
    # last range
    for V_ in (120, 136):
        h, w = head_inputs(5, 64, V_, head_gen)
        c, i = kexit.exit_confidence(h, w)
        cr, ir = ref.exit_confidence_ref(h, w)
        ok, err, rel = conf_close(c, cr)
        n_ctas = kexit.grid_ctas(V_, kexit._ctas(dev))
        check(f"exit_confidence V={V_} < {kexit.UNIT} x {n_ctas} CTAs", ok and torch.equal(i, ir),
              f"conf max|err| {err:.3g}, max rel err {rel:.3g}, argmax equal {torch.equal(i, ir)}")
    ranges = [(lo, hi) for lo, hi in kexit.vocab_ranges(V, kexit.grid_ctas(V, kexit._ctas(dev)))
              if hi > lo]
    a_col, b_col = ranges[4][1] - 1, ranges[5][0]
    ht = torch.randn((5, 256), generator=head_gen, device=dev)
    wt = torch.randn((256, V), generator=head_gen, device=dev) * 0.01
    col = 4.0 * ht.sum(0) / ht.sum(0).norm()
    for c_ in (b_col, a_col, ranges[-1][0]):
        wt[:, c_] = col
    c, it = kexit.exit_confidence(ht.bfloat16(), wt.bfloat16())
    cr, ir = ref.exit_confidence_ref(ht.bfloat16(), wt.bfloat16())
    ok, err, rel = conf_close(c, cr)
    check(f"exit_confidence tie across the CTA boundary at column {b_col} (V={V})",
          bool(torch.all(it == a_col)) and torch.equal(it, ir) and ok,
          f"argmax {it.tolist()} (want {a_col}); conf max|err| {err:.3g}, max rel err {rel:.3g}")
    del ht, wt
    h, w = head_inputs(13, 128, 2056)  # vocab not a multiple of the 256-column tile
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

    def dec_inputs(B, S, hq, kvh, hd_, lengths, g=gen):
        q = torch.randn((B, hq, hd_), generator=g, device=dev).bfloat16()
        k = torch.randn((B, S, kvh, hd_), generator=g, device=dev).bfloat16()
        v = torch.randn((B, S, kvh, hd_), generator=g, device=dev).bfloat16()
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
    def paged_inputs(B, hq, kvh, hd_, bs, lengths, n_logical, g=gen):
        NB = B * n_logical + 1
        perm = torch.randperm(NB - 1, generator=g, device=dev).int()
        table = torch.full((B, n_logical), NB - 1, dtype=torch.int32, device=dev)
        for b, n in enumerate(lengths):
            used = -(-n // bs)
            table[b, :used] = perm[b * n_logical : b * n_logical + used]
        q = torch.randn((B, hq, hd_), generator=g, device=dev).bfloat16()
        kp = torch.randn((NB, bs, kvh, hd_), generator=g, device=dev).bfloat16()
        vp = torch.randn((NB, bs, kvh, hd_), generator=g, device=dev).bfloat16()
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

    # Both decode kernels at one model's heads (hq, kvh, hd): dense against
    # the plain version (atol 2e-2) and element-wise at the bf16 tolerance
    # against the f32-score plain version, in one launch per 16 query heads
    # of a KV head; paged at each block size against the plain version and
    # the f32-score plain version on the gathered cache, and bit for bit the
    # dense kernel on it.  Each planted fault runs on the gate's inputs and
    # must fall outside the bf16 tolerance: the dense ones as
    # fn(q, k, v, lengths), the paged ones as fn(q, pool_k, pool_v, table,
    # lengths, seq_len) at the first block size.
    split = kdec.SPLIT_KEYS

    def skip_combine(q, k, v, ln):
        out = torch.zeros_like(q)
        kdec._launch(q, k, v, ln, out, combine=False)
        return out

    def skip_combine_paged(q, kp, vp, table, ln, S):
        out = torch.zeros_like(q)
        kpaged._launch(q, kp, vp, table, ln, out, S, combine=False)
        return out

    def first_chunk(q_all, kvh, run):
        """Every chunk of 16 heads per KV head answered with the first
        chunk's query heads (a wrong head offset per chunk)."""
        B_, hq_, hd_ = q_all.shape
        G = hq_ // kvh

        def chunk(qc):
            g = qc.shape[1] // kvh
            return run(q_all.view(B_, kvh, G, hd_)[:, :, :g].reshape(B_, kvh * g, hd_).contiguous())

        return kdec.split_groups(q_all, kvh, chunk)

    def neighbour_block(q, kp, vp, table, ln, S):
        wrong = table.clone()
        wrong[0, 1] = (wrong[0, 1] + 1) % (kp.shape[0] - 1)
        return kpaged.paged_decode_attention(q, kp, vp, wrong, ln, seq_len=S)

    DROP_TOKEN = ("the current token dropped (lengths - 1)",
                  lambda q, k, v, ln: kdec.decode_attention(q, k, v, ln - 1))
    DROP_SPLIT = ("the last split of every row dropped",
                  lambda q, k, v, ln: kdec.decode_attention(q, k, v, (ln - 1) // split * split))
    SKIP_COMBINE = ("the combine over splits skipped", skip_combine)
    FIRST_CHUNK = ("every chunk answered with the first chunk's heads",
                   lambda q, k, v, ln: first_chunk(q, k.shape[2],
                                                   lambda q0: kdec.decode_attention(q0, k, v, ln)))
    NEIGHBOUR = ("row 0's second block read from its neighbour", neighbour_block)
    SKIP_COMBINE_PAGED = ("the combine over splits skipped", skip_combine_paged)
    FIRST_CHUNK_PAGED = ("every chunk answered with the first chunk's heads",
                         lambda q, kp, vp, table, ln, S: first_chunk(
                             q, kp.shape[2], lambda q0: kpaged.paged_decode_attention(
                                 q0, kp, vp, table, ln, seq_len=S)))

    def decode_gate(name, heads, S, lengths, g=gen, block_sizes=(BLOCK, 3, 1), dense_faults=(),
                    paged_faults=()):
        """Returns the max|err| to the plain versions: dense, and paged at
        the first block size."""
        hq, kvh, hd_ = heads
        G = hq // kvh
        shape = f"G={G} B={BATCH} S={S} Hq={hq} KVH={kvh} hd={hd_} lengths {min(lengths)}..{max(lengths)}"
        q, k, v, ln = dec_inputs(BATCH, S, hq, kvh, hd_, lengths, g)
        n0 = kdec.decode_attention.launches
        o = kdec.decode_attention(q, k, v, ln)
        chunks = kdec.decode_attention.launches - n0
        want32 = ref.decode_attention_f32_scores_ref(q, k, v, ln)
        errs = [float((o.float() - ref.decode_attention_ref(q, k, v, ln).float()).abs().max())]
        ok32, err32, _ = bf16_close(o, want32)
        check(f"decode_attention {name} {shape}", errs[0] <= 2e-2 and ok32 and chunks == -(-G // kdec.MMA_G),
              f"{chunks} launches; max|err| {errs[0]:.3g} (tol 2e-2); against the f32-score plain "
              f"version max|diff| {err32:.3g} (rtol 1.6e-2, atol 1e-2)")
        for fault, run in dense_faults:
            ok_f, err_f, out_f = bf16_close(run(q, k, v, ln), want32)
            check(f"decode_attention {name} gate rejects a planted fault: {fault}", not ok_f,
                  f"max|diff| {err_f:.3g}, {out_f:.2%} of elements outside")
        del q, k, v, o, want32
        for bs in block_sizes:
            args = paged_inputs(BATCH, hq, kvh, hd_, bs, lengths, -(-S // bs), g)
            o = kpaged.paged_decode_attention(*args, seq_len=S)
            ok, err32, bitwise = paged_gate(o, *args, S)
            err = float((o.float() - ref.paged_decode_attention_ref(*args, seq_len=S).float()).abs().max())
            check(f"paged_decode_attention {name} {shape} bs={bs}", ok and err <= 2e-2,
                  f"against the f32-score plain version on the gathered cache max|diff| {err32:.3g}; "
                  f"bitwise equal to the dense kernel {bitwise}; against the plain version max|err| "
                  f"{err:.3g} (tol 2e-2)")
            if bs == block_sizes[0]:
                errs.append(err)
                q, kp, vp, table, ln = args
                for fault, run in paged_faults:
                    ok_f, err_f, out_f = bf16_close(run(*args, S), ref.decode_attention_f32_scores_ref(
                        q, gathered(kp, table, S), gathered(vp, table, S), ln))
                    check(f"paged_decode_attention {name} bs={bs} gate rejects a planted fault: {fault}",
                          not ok_f, f"max|diff| {err_f:.3g}, {out_f:.2%} of elements outside")
                del q, kp, vp, table, ln
            del args, o
        return errs

    # glm4-9b's shapes: 16 query heads over each of 2 KV heads of 128 (two
    # CTAs per KV head)
    glm = get_config("glm4-9b")
    glm_heads = (glm.num_heads, glm.num_kv_heads, glm.head_dim)
    g_len = max(GLM_LENGTHS) + 8
    decode_gate("glm4-9b", glm_heads, g_len, GLM_LENGTHS, block_sizes=(BLOCK,))
    # a long cache (S 4096), at glm4-9b's heads (G 16) and at
    # stablelm-1.6b's (G 1): several 512-key splits of the walk per row,
    # added by the combine
    long_heads = {"glm4-9b": glm_heads, "stablelm-1.6b": (Hq, KVH, hd)}
    for name, heads in long_heads.items():
        decode_gate(f"{name} long cache", heads, LONG_S, LONG_LENGTHS, block_sizes=(BLOCK,),
                    dense_faults=(DROP_SPLIT, SKIP_COMBINE), paged_faults=(SKIP_COMBINE_PAGED,))
    # G 5 and G 6 (qwen2.5-32b's and internlm2-20b's heads, hd 128), and
    # above 16 query heads per KV head (G 32 and 24, one launch per chunk of
    # at most 16 heads), at the serve's lengths and on the long cache
    gqa_lengths = (("serve lengths", max_len, dec_lengths), ("long cache", LONG_S, LONG_LENGTHS))
    for name, heads in GQA_HEADS.items():
        for label, S, lengths in gqa_lengths:
            decode_gate(f"{name} {label}", heads, S, lengths)
    for name, heads in WIDE_HEADS.items():
        for label, S, lengths in gqa_lengths:
            decode_gate(f"{name} {label}", heads, S, lengths, dense_faults=(FIRST_CHUNK,),
                        paged_faults=(FIRST_CHUNK_PAGED,))

    # prefill flash attention: element-wise at tests/test_kernels.py's bf16
    # tolerance (atol 2e-2) against the plain version on the same inputs
    def flash_inputs(B, Sq, Sk, hq, kvh, hd_, g=gen):
        return (torch.randn((B, Sq, hq, hd_), generator=g, device=dev).bfloat16(),
                torch.randn((B, Sk, kvh, hd_), generator=g, device=dev).bfloat16(),
                torch.randn((B, Sk, kvh, hd_), generator=g, device=dev).bfloat16())

    def flash_gate(out, want):
        """(within atol 2e-2, max|err|, share of elements outside)."""
        diff = (out.float() - want.float()).abs()
        return bool(diff.max() <= 2e-2), float(diff.max()), float((diff > 2e-2).float().mean())

    def flash_rows_gate(out, want):
        """(every query row, over its heads, within 2^-6 norm-wise, the
        largest row's rel err).  Under a window of thousands of keys an
        output's rms is ~sqrt(e / W) (0.026 at W 4096), near atol 2e-2,
        while a band cut or grown by r keys moves a row by ~sqrt(r / W)
        norm-wise (0.18 for one 128-key tile at W 4096)."""
        d = torch.linalg.vector_norm((out.float() - want.float()).flatten(2), dim=-1)
        rel = d / torch.linalg.vector_norm(want.float().flatten(2), dim=-1)
        return bool(rel.max() <= 2**-6), float(rel.max())

    def flash_f64(q, k, v, causal, window):
        """The plain version's masks and positions, every step in f64; past
        2048 queries in chunks of 1024 query rows (each row's softmax is its
        own), so the f64 scores of an 8192-token prompt stay a few GB."""
        B, Sq, Hq, hd_ = q.shape
        if Sq > 2048:
            return torch.cat([flash_f64_rows(q[:, i:i + 1024], k, v, causal, window, i)
                              for i in range(0, Sq, 1024)], dim=1)
        return flash_f64_rows(q, k, v, causal, window)

    def flash_f64_rows(q, k, v, causal, window, q0=0):
        B, Sq, Hq, hd_ = q.shape
        Sk, kvh = k.shape[1], k.shape[2]
        s = torch.einsum("bqkgd,bskd->bkgqs", q.double().reshape(B, Sq, kvh, Hq // kvh, hd_),
                         k.double()) / math.sqrt(hd_)
        q_pos = torch.arange(q0, q0 + Sq, device=dev)[:, None]
        k_pos = torch.arange(Sk, device=dev)[None, :]
        keep = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            keep &= q_pos >= k_pos
        if window is not None:
            keep &= k_pos > q_pos - window
        p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", p, v.double()).reshape(B, Sq, Hq, hd_)

    flash_cases = [(label, (B, S, S, hq, kvh, hd_), True, None)
                   for label, B, S, hq, kvh, hd_ in FLASH_SHAPES]
    flash_cases += [
        ("Sk > Sq, causal", (2, 128, 384, 4, 4, 128), True, None),
        ("not causal", (1, 128, 128, 2, 2, 64), False, None),
        ("window 100", (1, 256, 256, 4, 4, 64), True, 100),
        ("Sq = 1", (2, 1, 50, 8, 2, 32), True, None),
        ("S not a multiple of 64", (3, 77, 77, 8, 2, 32), True, None),
    ]
    def flash_case(label, shape, causal=True, window=None, g=gen, f32_scores=False):
        """The kernel against the plain version at atol 2e-2 and, since the
        plain version rounds the scores to bf16 as the reference does and
        the kernel keeps them in f32, no farther than it from the f64
        answer.  Returns (q, k, v, the plain version's output, max|err|).
        With ``f32_scores`` the element-wise gate's plain version runs on
        the inputs in f32 (its scores, probabilities and mix in f32, within
        1e-6 of the f64 answer), that output is returned, and every query
        row is also held to it at 2^-6 norm-wise (``flash_rows_gate``):
        over a band of thousands of keys the bf16 scores alone move an
        output by up to 0.02 (1000- and 4096-key windows on an H100: the
        bf16-score plain version 0.013-0.021 from f64, the kernel
        0.008-0.009), about an output's own size."""
        q, k, v = flash_inputs(*shape, g)
        o = kflash.flash_attention(q, k, v, causal=causal, window=window)
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        want = (ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
                if f32_scores else plain)
        ok, err, out_share = flash_gate(o, want)
        B, Sq, Sk, hq, kvh, hd_ = shape
        check(f"flash_attention {label} B={B} Sq={Sq} Sk={Sk} Hq={hq} KVH={kvh} hd={hd_}", ok,
              f"max|err| {err:.3g} (atol 2e-2) to the {'f32-score ' if f32_scores else ''}plain "
              f"version, {out_share:.2%} of elements outside")
        if f32_scores:
            ok_r, rel_r = flash_rows_gate(o, want)
            check(f"flash_attention {label}: every query row within 2^-6 norm-wise of the f32-score "
                  "plain version", ok_r, f"max row rel err {rel_r:.3g} (tol 2^-6 = {2**-6:.3g})")
        exact = flash_f64(q, k, v, causal, window)
        err_k, err_p = (float((x.double() - exact).abs().max()) for x in (o, plain))
        check(f"flash_attention {label}: no farther from the f64 answer than the plain version",
              err_k <= err_p, f"max|kernel - f64| {err_k:.3g}, max|plain - f64| {err_p:.3g}")
        del plain, exact
        return q, k, v, want, err

    for label, shape, causal, window in flash_cases:
        q, k, v, want, err = flash_case(label, shape, causal, window)
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

    # zamba2-2.7b's attention at head dim 80 (32 query heads over 32 KV heads,
    # G 1) in all three attention kernels, and the exit head at the LM heads
    # of zamba2-2.7b and xlstm-350m: inputs from a generator of their own,
    # so that every gate above and every later phase keeps its inputs.
    # Decode at the zamba2 serve's lengths and on the 4096-key cache, dense
    # and paged (bs 16 and 1, bit for bit the dense kernel on the gathered
    # cache); flash at a full prefill batch and a 2048-token prompt, with the
    # f64 check; each gate shown to reject a planted fault on its inputs.
    zcfg, xcfg = get_config("zamba2-2.7b"), get_config("xlstm-350m")
    z_hq, z_kvh, z_hd = zcfg.num_heads, zcfg.num_kv_heads, zcfg.head_dim
    z_prompts = [tok for _, tok in poisson_requests(zcfg, rcfg, duration=60.0)][:SSM_REQUESTS]
    z_max_len = max(map(len, z_prompts)) + SSM_GEN
    z_lengths = [len(p) + SSM_GEN // 2 for p in z_prompts[:BATCH]]
    z_decode = (("serve lengths", z_max_len, z_lengths), ("long cache", LONG_S, LONG_LENGTHS))
    gen80 = torch.Generator(device=dev).manual_seed(SEED + 2)
    z_heads = (z_hq, z_kvh, z_hd)
    for label, S, lengths in z_decode:
        faults = (((DROP_TOKEN,), (NEIGHBOUR,)) if label == "serve lengths" else
                  ((DROP_SPLIT, SKIP_COMBINE), (SKIP_COMBINE_PAGED,)))
        errs = decode_gate(f"zamba2-2.7b {label}", z_heads, S, lengths, gen80, (BLOCK, 1), *faults)
        if label == "serve lengths":
            max_err["decode_attention hd 80"], max_err["paged_decode_attention hd 80"] = errs
    for n_shape, (label, B, S, hq, kvh, hd_) in enumerate(ZAMBA_FLASH):
        q, k, v, want, err = flash_case(label, (B, S, S, hq, kvh, hd_), g=gen80)
        if n_shape == 0:
            max_err["flash_attention hd 80"] = err
            fault, kf, vf = ("K/V shifted by one position", torch.roll(k, -1, dims=1),
                             torch.roll(v, -1, dims=1))
        else:
            fault, kf, vf = ("the last key tile dropped", k[:, :-128].contiguous(),
                             v[:, :-128].contiguous())
        ok, err, out_share = flash_gate(kflash.flash_attention(q, kf, vf), want)
        check(f"flash_attention hd={hd_} {label} gate rejects a planted fault: {fault}", not ok,
              f"max|err| {err:.3g}, {out_share:.2%} of elements outside")
        del q, k, v, kf, vf, want
    for arch, acfg in (("zamba2-2.7b", zcfg), ("xlstm-350m", xcfg)):
        d_, V_ = acfg.d_model, acfg.vocab_size
        for B in (1, BATCH, 32):
            h, w = head_inputs(B, d_, V_, gen80)
            c, i = kexit.exit_confidence(h, w)
            cr, ir = ref.exit_confidence_ref(h, w)
            ok, err, rel = conf_close(c, cr)
            check(f"exit_confidence {arch}'s head B={B} d={d_} V={V_} ({kexit.grid_ctas(V_, kexit._ctas(dev))} "
                  f"CTAs over {-(-V_ // kexit.UNIT)} units)", ok and torch.equal(i, ir),
                  f"conf max|err| {err:.3g} (atol 1e-3), max rel err {rel:.3g} (rtol 1e-4), argmax "
                  f"equal {torch.equal(i, ir)}")
            max_err[f"exit_confidence {arch}"] = max(max_err.get(f"exit_confidence {arch}", 0.0), err)
        c_f, _ = kexit.exit_confidence(h, w[:, : V_ - 256].contiguous())
        ok, err, rel = conf_close(c_f, cr)
        check(f"exit_confidence gate rejects a dropped vocab tile at d={d_} V={V_}", not ok,
              f"conf max|err| {err:.3g}, max rel err {rel:.3g}")
        del h, w, c_f

    # The kernels of the three configs served through the batched steps
    # (mixtral-8x7b, phi-3-vision-4.2b, musicgen-medium), from a generator of
    # their own, so that every gate above and every later phase keeps its
    # inputs:
    # - flash at phi-3-vision's heads (32 over 32 of 96) at a prefill batch
    #   of B 8, S 104 and a 2048-token prompt, with the f64 check, and in f32
    #   at B 2, S 512 (atol 2e-5);
    # - flash at the prefill shapes the later phases give it: the embeds
    #   configs' batched steps and mixtral's first engine prefill batch;
    # - flash at mixtral's heads (32 over 8 of 128, G 4) under its 4096-key
    #   window at 4160 and 8192 tokens, where the window bites, held to the
    #   f32-score plain version element-wise and row by row norm-wise
    #   (``flash_case``), and to the f64 answer;
    # - both decode kernels at mixtral's G 4, hd 128 (the engine serve's
    #   shape) at its serve's lengths and on the 4096-key cache, paged at bs
    #   16, 3 and 1;
    # - the exit head at the three LM heads, B 1, 8 and 32 and the batched
    #   steps' B.
    # Each gate is shown to reject a planted fault on its inputs.
    xcfg_full, pcfg, gcfg = (get_config(a) for a in ("mixtral-8x7b", "phi-3-vision-4.2b",
                                                     "musicgen-medium"))
    gen96 = torch.Generator(device=dev).manual_seed(SEED + 3)
    for n_shape, (label, B, S, hq, kvh, hd_) in enumerate(PHI_FLASH):
        q, k, v, want, err = flash_case(label, (B, S, S, hq, kvh, hd_), g=gen96)
        if n_shape == 0:
            max_err["flash_attention hd 96"] = err
            fault, kf, vf = ("K/V shifted by one position", torch.roll(k, -1, dims=1),
                             torch.roll(v, -1, dims=1))
        else:
            fault, kf, vf = ("the last key tile dropped", k[:, :-128].contiguous(),
                             v[:, :-128].contiguous())
        ok, err, out_share = flash_gate(kflash.flash_attention(q, kf, vf), want)
        check(f"flash_attention hd={hd_} {label} gate rejects a planted fault: {fault}", not ok,
              f"max|err| {err:.3g}, {out_share:.2%} of elements outside")
        del q, k, v, kf, vf, want
    # flash at the prefill shapes of the main path's new runs, not at a
    # gate above: the embeds configs' batched steps (phi-3-vision B 4, S 512,
    # 32 heads of 96; musicgen B 8, S 256, 24 heads of 64) and mixtral's
    # first engine prefill batch (G 4 under the window, which does not bite)
    x_heads = (xcfg_full.num_heads, xcfg_full.num_kv_heads, xcfg_full.head_dim)
    x_prompts = [tok for _, tok in poisson_requests(xcfg_full, rcfg, duration=60.0)][:MIXTRAL_REQUESTS]
    x_first = max(map(len, x_prompts[:BATCH]))
    path_flash = [(f"{arch}'s batched-steps prefill", (B_, S_, S_, c.num_heads, c.num_kv_heads,
                                                       c.head_dim), None)
                  for arch, (B_, S_) in EMBEDS_STEPS.items() for c in (get_config(arch),)]
    path_flash.append(("mixtral-8x7b's first engine prefill batch",
                       (BATCH, x_first, x_first, *x_heads), xcfg_full.sliding_window))
    for label, shape, window in path_flash:
        q, k, v, want, err = flash_case(label, shape, True, window, g=gen96)
        ok, err_f, out_share = flash_gate(kflash.flash_attention(q, torch.roll(k, -1, dims=1),
                                                                 torch.roll(v, -1, dims=1),
                                                                 window=window), want)
        check(f"flash_attention {label} gate rejects a planted fault: K/V shifted by one position",
              not ok, f"max|err| {err_f:.3g}, {out_share:.2%} of elements outside")
        del q, k, v, want
    q, k, v = (t.float() for t in flash_inputs(2, 512, 512, 32, 32, 96, gen96))
    want = ref.flash_attention_ref(q, k, v)
    err = float((kflash.flash_attention(q, k, v) - want).abs().max())
    err_f = float((kflash.flash_attention(q, torch.roll(k, -1, dims=1), torch.roll(v, -1, dims=1))
                   - want).abs().max())
    check("flash_attention f32 hd=96 B=2 S=512 Hq=32 KVH=32 (CUDA cores)", err <= 2e-5 < err_f,
          f"max|err| {err:.3g} (atol 2e-5); K/V shifted by one position: max|err| {err_f:.3g}, "
          f"rejected {err_f > 2e-5}")
    del q, k, v, want
    for n_shape, (label, B, S, hq, kvh, hd_, window) in enumerate(MIXTRAL_FLASH):
        q, k, v, want, err = flash_case(label, (B, S, S, hq, kvh, hd_), True, window, g=gen96,
                                        f32_scores=True)
        if n_shape == 0:
            max_err["flash_attention window"] = err
        # the planted faults: the band one 128-key tile short or long (at
        # 4160 tokens the long one reaches key 0, as no window would)
        for fault, w_f in (("the window one 128-key tile short", window - 128),
                           ("the window one 128-key tile long", window + 128)):
            o_f = kflash.flash_attention(q, k, v, window=w_f)
            ok, err_f, out_share = flash_gate(o_f, want)
            ok_r, rel_r = flash_rows_gate(o_f, want)
            check(f"flash_attention {label} gate rejects a planted fault: {fault}", not (ok and ok_r),
                  f"max|err| {err_f:.3g}, {out_share:.2%} of elements outside; max row rel err "
                  f"{rel_r:.3g}")
            del o_f
        del q, k, v, want
    x_max_len = max(map(len, x_prompts)) + MIXTRAL_GEN
    x_lengths = [len(p) + MIXTRAL_GEN // 2 for p in x_prompts[:BATCH]]
    x_decode = (("serve lengths", x_max_len, x_lengths), ("long cache", LONG_S, LONG_LENGTHS))
    for label, S, lengths in x_decode:
        faults = (((DROP_TOKEN,), (NEIGHBOUR,)) if label == "serve lengths" else
                  ((DROP_SPLIT, SKIP_COMBINE), (SKIP_COMBINE_PAGED,)))
        errs = decode_gate(f"mixtral-8x7b {label}", x_heads, S, lengths, gen96, (BLOCK, 3, 1), *faults)
        if label == "serve lengths":
            max_err["decode_attention G 4"], max_err["paged_decode_attention G 4"] = errs
    for arch, acfg in (("mixtral-8x7b", xcfg_full), ("phi-3-vision-4.2b", pcfg),
                       ("musicgen-medium", gcfg)):
        d_, V_ = acfg.d_model, acfg.vocab_size
        # B 1, 8 and 32, and the batched steps' B
        for B in sorted({1, BATCH, 32, EMBEDS_STEPS.get(arch, (1,))[0]}):
            h, w = head_inputs(B, d_, V_, gen96)
            c, i = kexit.exit_confidence(h, w)
            cr, ir = ref.exit_confidence_ref(h, w)
            ok, err, rel = conf_close(c, cr)
            check(f"exit_confidence {arch}'s head B={B} d={d_} V={V_} ({kexit.grid_ctas(V_, kexit._ctas(dev))} "
                  f"CTAs over {-(-V_ // kexit.UNIT)} units)", ok and torch.equal(i, ir),
                  f"conf max|err| {err:.3g} (atol 1e-3), max rel err {rel:.3g} (rtol 1e-4), argmax "
                  f"equal {torch.equal(i, ir)}")
            max_err[f"exit_confidence {arch}"] = max(max_err.get(f"exit_confidence {arch}", 0.0), err)
        c_f, _ = kexit.exit_confidence(h, w[:, : V_ - 256].contiguous())
        ok, err, rel = conf_close(c_f, cr)
        check(f"exit_confidence gate rejects a dropped vocab tile at d={d_} V={V_}", not ok,
              f"conf max|err| {err:.3g}, max rel err {rel:.3g}")
        del h, w, c_f

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

    @contextlib.contextmanager
    def head_calls():
        """The batch rows of every exit-head call on the model's path
        (``ops.exit_confidence``) while active."""
        rows, real = [], ops.exit_confidence

        def counted(h_, w_):
            rows.append(h_.shape[0])
            return real(h_, w_)

        ops.exit_confidence = counted
        try:
            yield rows
        finally:
            ops.exit_confidence = real

    def check_head_passes(label, rows, n_launches):
        """Every head call of a serve has at most 64 rows, so each is one
        pass over w: one launch per call."""
        check(f"{label}: one exit_confidence launch per head call (one pass over w)",
              bool(rows) and max(rows) <= kexit.MAX_ROWS and n_launches == len(rows),
              f"{n_launches} launches for {len(rows)} head calls of "
              f"{min(rows, default=0)}..{max(rows, default=0)} rows")

    torch.cuda.reset_peak_memory_stats()
    engine.rng = np.random.default_rng(SEED)
    zero_counts()
    t0 = time.perf_counter()
    with head_calls() as serve_head_rows:
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
    check_head_passes("serve", serve_head_rows, launches["exit_confidence"])
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

    # where a serve's time goes: a short profiled serve
    by_kernel, busy_us = profiled_serve(engine, prompts[:BATCH], "stablelm-1.6b")
    if busy_us:
        flash_us = sum(t for key, t in by_kernel if "flash_wgmma_kernel" in key)
        print(f"  flash_attention kernel: {flash_us / 1e3:.3f} ms = {flash_us / busy_us:.2%} of device "
              f"time", flush=True)

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

    # -- 7. the larger configs, one at a time -----------------------------------
    # Each model at full width with random weights from the seed, after the
    # previous model's weights are freed; served dense and then paged (block
    # 16, no prefix sharing), the kernels' launches counted over each serve
    # (the counts set to 0 just before it, read just after).  Each model's LM
    # head is kept for phase 8's exit-head times.
    heads = {"stablelm-1.6b": params["lm_head"]}
    del engine, programs, params, store, caches, outs, x1, x_dec, y_t, y_c, y_f, yp_t, yp_c

    def free(label: str) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label} freed: peak device memory of the process so far "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; still allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    free("stablelm-1.6b")

    serve_counts = {}  # model -> layout -> the kernels' launches in that serve

    def serve_model(mcfg, n_requests: int, gen_len: int, dense_names, paged_names, zero_names=()):
        """Build ``mcfg`` at full width, serve ``n_requests`` Poisson prompts
        of ``gen_len`` tokens dense and then paged at full batches: every
        request completes, each of ``*_names`` launched in its serve, each
        of ``zero_names`` in neither, and paged == dense in tokens and exits.
        Each serve's launches land in ``serve_counts``.  Returns (engine,
        params, prompts)."""
        label = mcfg.name
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m_params = model_lib.init_params(mcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        m_profile = profile_from_arch(mcfg)
        m_engine = CollaborativeEngine(
            m_params, mcfg,
            build_edge_network(seed=0, profile=m_profile, spec=NetworkSpec(num_eds=4, es_per_stage=(2, 2))),
            m_profile, synthetic_validation(seed=1, profile=m_profile), DtoHyperParams(), seed=SEED,
            device=dev,
        )
        m_engine.configuration_phase()
        torch.cuda.synchronize()
        n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(m_params))
        m_prompts = [tok for _, tok in poisson_requests(mcfg, rcfg, duration=60.0)][:n_requests]
        if len(m_prompts) != n_requests:
            raise RuntimeError(f"request stream gave {len(m_prompts)} prompts")
        attn = (f"MLA {mcfg.mla.num_heads} heads (kv_lora {mcfg.mla.kv_lora_rank}, rope "
                f"{mcfg.mla.qk_rope_head_dim})" if mcfg.mla is not None else
                f"{mcfg.num_heads} query heads over {mcfg.num_kv_heads} KV heads of {mcfg.head_dim}"
                if mcfg.uses_attention else "no attention")
        ffn = (f"MoE {mcfg.moe.num_experts} experts top-{mcfg.moe.top_k} + {mcfg.moe.num_shared} "
               f"shared, expert d_ff {mcfg.moe.d_ff_expert}" if mcfg.moe is not None else f"d_ff {mcfg.d_ff}")
        print(f"{label} full width: {mcfg.num_layers} layers (period {'/'.join(mcfg.period)}), d "
              f"{mcfg.d_model}, {attn}, {ffn}, vocab "
              f"{mcfg.vocab_size}; {n / 1e9:.3f} B params ({n * 2 / 1e9:.1f} GB in bf16); set-up "
              f"{time.perf_counter() - t0:.1f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; prompts {n_requests}, lengths "
              f"{min(map(len, m_prompts))}..{max(map(len, m_prompts))}", flush=True)
        runs = {}
        for layout, kw in (("dense", {}),
                           ("paged", {"cache_layout": "paged", "block_size": BLOCK, "prefix_sharing": False})):
            torch.cuda.reset_peak_memory_stats()
            m_engine.rng = np.random.default_rng(SEED)
            zero_counts()
            t0 = time.perf_counter()
            with head_calls() as m_head_rows:
                m_stats = m_engine.serve(m_prompts, arrival_rate=1e4, batch_size=BATCH,
                                         gen_len=gen_len, decode_mode="cached", **kw)
                torch.cuda.synchronize()
            m_wall = time.perf_counter() - t0
            m_counts = read_counts()
            serve_counts.setdefault(label, {})[layout] = m_counts
            m_sum = m_stats.summary()
            runs[layout] = m_stats.sequences_by_rid()
            print(f"{label} {layout} serve: wall {m_wall:.3f} s; generated tokens "
                  f"{m_sum['generated_tokens']}; {m_sum['generated_tokens'] / m_wall:.1f} tokens/s; batches "
                  f"{m_sum['num_batches']}; exit histogram {m_sum['exit_histogram']}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {m_counts}",
                  flush=True)
            check(f"{label} {layout} serve completed", m_sum["num_completed"] == n_requests,
                  f"{m_sum['num_completed']} of {n_requests}")
            for name in dense_names if layout == "dense" else paged_names:
                check(f"{label} {layout} serve launched {name}", m_counts[name] > 0,
                      f"{m_counts[name]} launches")
            for name in zero_names:
                check(f"{label} {layout} serve launched no {name}", m_counts[name] == 0,
                      f"{m_counts[name]} launches")
            check_head_passes(f"{label} {layout} serve", m_head_rows, m_counts["exit_confidence"])
        diverged = [r for r, v in runs["paged"].items() if runs["dense"].get(r) != v]
        check(f"{label} paged serve tokens and exits equal the dense serve's",
              not diverged and len(runs["dense"]) == n_requests,
              f"{len(diverged)} of {n_requests} requests differ")
        return m_engine, m_params, m_prompts

    phase("glm4-9b serve")
    g_engine, g_params, _ = serve_model(glm, GLM_REQUESTS, GLM_GEN,
                                     ("exit_confidence", "decode_attention", "flash_attention"),
                                     ("paged_decode_attention",))
    heads["glm4-9b"] = g_params["lm_head"]
    del g_engine, g_params
    free("glm4-9b")

    # deepseek-v2-lite-16b: MLA attention and an MoE FFN in every layer.  The
    # reference has no kernel for MLA (its prefill is the plain
    # chunked_attention, its decode the absorbed-latent einsums), so only
    # the exit head's kernel runs; the decode and flash kernels must not.
    phase("deepseek-v2-lite-16b serve")
    dcfg = get_config("deepseek-v2-lite-16b")
    gqa = ("decode_attention", "paged_decode_attention", "flash_attention")
    d_engine, d_params, d_prompts = serve_model(dcfg, DEEPSEEK_REQUESTS, DEEPSEEK_GEN,
                                                ("exit_confidence",), ("exit_confidence",),
                                                zero_names=gqa)
    profiled_serve(d_engine, d_prompts[:BATCH], "deepseek-v2-lite-16b")
    heads["deepseek-v2-lite-16b"] = d_params["lm_head"]

    # one full-width moe_attn layer (stage 1, period 0) on the card and on
    # the CPU with the same weights: a prefill of B 2, S 16, then one ragged
    # decode token.  Norm-wise at 2^-7 (two bf16 ulps; the two devices sum
    # the bf16 products in other orders), and the routers' top-k choices
    # compared token by token, recorded at the router.
    from repro_torch.models import moe as moe_lib

    blk = model_lib._period(d_params["stages"][0]["blocks"][0], 0)
    xs = (torch.randn((2, 16, dcfg.d_model), generator=gen, device=dev).bfloat16(),
          torch.randn((2, 1, dcfg.d_model), generator=gen, device=dev).bfloat16())
    real_router = moe_lib.router_probs

    def moe_layer(where: str):
        p_ = blk if where == "card" else model_lib.params_to(blk, "cpu")
        x_, xd_ = (t.to(p_["norm1"]["scale"].device) for t in xs)
        picked = []

        def recording(logits, dims):
            out = real_router(logits, dims)
            picked.append(out[1].cpu())
            return out

        moe_lib.router_probs = recording
        try:
            pos = torch.arange(16, dtype=torch.int32, device=x_.device)
            y, cache, _ = model_lib._block_apply("moe_attn", p_, x_, dcfg, pos, "prefill", 17)
            cache = dict(cache, pos=torch.full((2,), 16, dtype=torch.int32, device=x_.device))
            yd, _ = model_lib._block_decode("moe_attn", p_, xd_, cache, dcfg, ragged=True)
        finally:
            moe_lib.router_probs = real_router
        return y.cpu(), yd.cpu(), torch.cat(picked)

    t0 = time.perf_counter()
    y_card, yd_card, idx_card = moe_layer("card")
    y_cpu, yd_cpu, idx_cpu = moe_layer("cpu")
    same_sets = [set(a.tolist()) == set(b.tolist()) for a, b in zip(idx_card, idx_cpu)]
    shared = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(idx_card, idx_cpu))
    agree = shared / idx_card.numel()
    rel_p, rel_d = rel_norm(y_card, y_cpu), rel_norm(yd_card, yd_cpu)
    check(f"deepseek-v2-lite-16b one moe_attn layer, card vs CPU (prefill B 2 S 16, one ragged "
          f"decode token; {time.perf_counter() - t0:.1f} s)",
          rel_p <= 2**-7 and rel_d <= 2**-7 and agree >= 0.99,
          f"norm-wise rel prefill {rel_p:.3g}, decode {rel_d:.3g} (tol 2^-7 = {2**-7:.3g}); top-"
          f"{dcfg.moe.top_k} expert choices agree on {agree:.2%} of {idx_card.numel()} (token, choice) "
          f"pairs (want >= 99%), {sum(same_sets)} of {len(same_sets)} tokens with the same set; "
          f"element-wise max|diff| prefill {float((y_card.float() - y_cpu.float()).abs().max()):.3g} at "
          f"max|y| {float(y_cpu.float().abs().max()):.3g}")
    # the same ratios over the block's own contribution y - x, without the
    # residual stream both sides share: printed, not gated
    own_p = rel_norm(y_card.float() - xs[0].cpu().float(), y_cpu.float() - xs[0].cpu().float())
    own_d = rel_norm(yd_card.float() - xs[1].cpu().float(), yd_cpu.float() - xs[1].cpu().float())
    print(f"  over y - x (attention + MoE alone): norm-wise rel prefill {own_p:.3g}, decode {own_d:.3g}",
          flush=True)
    del d_engine, d_params, blk, xs
    free("deepseek-v2-lite-16b")

    # internlm2-20b (G 6) and qwen2.5-32b (G 5, QKV bias): GQA at hd 128,
    # every kernel on the path
    for arch in ("internlm2-20b", "qwen2.5-32b"):
        phase(f"{arch} serve")
        mcfg = get_config(arch)
        m_engine, m_params, _ = serve_model(mcfg, LARGE_REQUESTS, LARGE_GEN,
                                            ("exit_confidence", "decode_attention", "flash_attention"),
                                            ("paged_decode_attention", "flash_attention"))
        heads[arch] = m_params["lm_head"]
        del m_engine, m_params
        free(arch)

    # zamba2-2.7b (Mamba2 blocks and a dense attention block per period: the
    # attention kernels at hd 80) and xlstm-350m (mLSTM and sLSTM blocks, no
    # attention: the exit head's kernel only; the decode and flash kernels
    # must not run), each served dense and paged, a short serve profiled,
    # and one full-width period of its recurrent blocks on the card and on
    # the CPU with the same weights (stage 1, period 0: zamba2's first Mamba2
    # block, xlstm's mLSTM and sLSTM blocks): a prefill of B 2, S 16, then
    # one ragged decode token, norm-wise at 2^-7 (two bf16 ulps; the two
    # devices sum and round in other orders).
    # - Block by block: each block gets the card's input to it on both
    #   devices and decodes from a copy of the card's prefilled cache.
    # - The period chained (xlstm): each device's mLSTM output and caches
    #   feed its own sLSTM.  Its gap is held to a witness on the CPU alone:
    #   the CPU's sLSTM fed the card's mLSTM outputs against itself fed its
    #   own.  The two agree within 2^-7 when the chain's gap is the sLSTM's
    #   response to the input gap; the same witness on the card is printed.
    def block_run(kind, mcfg, p_, x_, xd_, cache=None):
        """One block on p_'s device: the prefill, and one ragged decode
        token from a copy of ``cache`` (a prefilled cache) or of its own
        prefilled cache.  Returns (y, yd, its own prefilled cache)."""
        d_ = p_["norm"]["scale"].device
        pos = torch.arange(16, dtype=torch.int32, device=d_)
        y, own, _ = model_lib._block_apply(kind, p_, x_.to(d_), mcfg, pos, "prefill", 17)
        c = {key: t.to(d_).clone() for key, t in (own if cache is None else cache).items()}
        c["pos"] = torch.full((2,), 16, dtype=torch.int32, device=d_)
        yd, _ = model_lib._block_decode(kind, p_, xd_.to(d_), c, mcfg, ragged=True)
        return y, yd, own

    def recurrent_period(mcfg, m_params, blocks):
        """Block by block: [(kind, rel prefill, rel decode)], card vs CPU.
        With two blocks or more, also the chained period: {"chain", "witness
        cpu", "witness card": (rel prefill, rel decode)}."""
        x0 = layer_inputs[mcfg.name]
        p = {}
        for j in blocks:
            p_card = model_lib._period(m_params["stages"][0]["blocks"][j], 0)
            p[j] = {"card": p_card, "cpu": model_lib.params_to(p_card, "cpu")}
        rows, (x_, xd_) = [], x0
        for j in blocks:
            kind = mcfg.period[j]
            y_c, yd_c, cache_c = block_run(kind, mcfg, p[j]["card"], x_, xd_)
            y_h, yd_h, _ = block_run(kind, mcfg, p[j]["cpu"], x_, xd_, cache_c)
            rows.append((kind, rel_norm(y_c.cpu(), y_h), rel_norm(yd_c.cpu(), yd_h)))
            x_, xd_ = y_c, yd_c  # the card's outputs feed the next block on both devices
        if len(blocks) < 2:
            return rows, None
        ins = {where: x0 for where in ("card", "cpu")}  # (y, yd) into the next block
        for j in blocks[:-1]:
            for where in ins:
                ins[where] = block_run(mcfg.period[j], mcfg, p[j][where], *ins[where])[:2]
        last, kind = blocks[-1], mcfg.period[blocks[-1]]
        out = {f"{where} fed {fed}": block_run(kind, mcfg, p[last][where], *ins[fed])[:2]
               for where, fed in (("card", "card"), ("cpu", "cpu"), ("cpu", "card"), ("card", "cpu"))}
        own = {where: out[f"{where} fed {where}"] for where in ("card", "cpu")}

        def gap(a, b):
            return tuple(rel_norm(u.cpu(), w.cpu()) for u, w in zip(a, b))

        return rows, {"input": gap(ins["card"], ins["cpu"]),
                      "chain": gap(own["card"], own["cpu"]),
                      "witness cpu": gap(out["cpu fed card"], own["cpu"]),
                      "witness card": gap(own["card"], out["card fed cpu"])}

    layer_inputs = {}
    for arch, blocks in (("zamba2-2.7b", (0,)), ("xlstm-350m", (0, 1))):
        phase(f"{arch} serve")
        mcfg = get_config(arch)
        if mcfg.uses_attention:
            names = (("exit_confidence", "decode_attention", "flash_attention"),
                     ("paged_decode_attention", "flash_attention"), ())
        else:
            names = (("exit_confidence",), ("exit_confidence",), gqa)
        m_engine, m_params, m_prompts = serve_model(mcfg, SSM_REQUESTS, SSM_GEN, *names)
        profiled_serve(m_engine, m_prompts[:BATCH], arch)
        heads[arch] = m_params["lm_head"]
        layer_inputs[arch] = (
            torch.randn((2, 16, mcfg.d_model), generator=gen80, device=dev).bfloat16(),
            torch.randn((2, 1, mcfg.d_model), generator=gen80, device=dev).bfloat16())
        t0 = time.perf_counter()
        rows, chained = recurrent_period(mcfg, m_params, blocks)
        kinds = " + ".join(row[0] for row in rows)
        check(f"{arch} one {kinds} period, card vs CPU, block by block (prefill B 2 S 16, one "
              f"ragged decode token; {time.perf_counter() - t0:.1f} s)",
              all(rp <= 2**-7 and rd <= 2**-7 for _, rp, rd in rows),
              "; ".join(f"{bk}: norm-wise rel prefill {rp:.3g}, decode {rd:.3g}" for bk, rp, rd in rows)
              + f" (tol 2^-7 = {2**-7:.3g})")
        if chained is not None:
            (cp, cd), (wp, wd) = chained["chain"], chained["witness cpu"]
            check(f"{arch} one {kinds} period chained, card vs CPU, against the witness on the CPU "
                  f"alone (its {rows[-1][0]} fed the card's {rows[-2][0]} outputs against fed its own)",
                  abs(cp - wp) <= 2**-7 and abs(cd - wd) <= 2**-7,
                  "; ".join(f"{label}: norm-wise rel prefill {gp:.3g}, decode {gd:.3g}"
                            for label, (gp, gd) in chained.items())
                  + f" (|chain - witness cpu| tol 2^-7 = {2**-7:.3g})")
        del m_engine, m_params
        free(arch)

    # The three configs served through the batched prefill / decode steps
    # (``serving.steps.make_prefill_step`` / ``make_decode_step``), each at
    # full width, one at a time.  Each run's kernel launches are counted
    # (the counts set to 0 just before it, read just after): flash once per
    # layer in a prefill, the exit head once per head call (every call under
    # 64 rows), the decode kernel once per layer and step where the caches
    # are full at a head dim it takes (musicgen), and no paged one.
    from repro_torch.serving import make_decode_step, make_prefill_step

    step_counts = {}  # model -> the kernels' launches in its steps run
    steps_gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def run_steps(mcfg, m_params, batch, next_batch, max_len, label):
        """``make_prefill_step`` on ``batch``, then ``STEPS_DECODE``
        ``make_decode_step`` calls on ``next_batch(out)``; checks the
        launches, that every cache position advanced and that every output is
        finite and in range.  Returns (outputs per call, counts, wall); the
        prefill's output also holds ``slot_pos_after_prefill``, a copy of its
        first ring's slot positions (None without a ring), since the decode
        steps update the caches in place."""
        thr = torch.full((len(mcfg.exit_stages),), 0.5, device=dev)
        prefill, decode = make_prefill_step(mcfg, max_len), make_decode_step(mcfg)
        zero_counts()
        outs = []
        with head_calls() as rows:
            t0 = time.perf_counter()
            out = prefill(m_params, batch, thr)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            ring = out["caches"][0][0].get("slot_pos")
            outs.append(dict(out, slot_pos_after_prefill=None if ring is None else ring.clone()))
            steps_s = []
            for _ in range(STEPS_DECODE):
                t1 = time.perf_counter()
                out = decode(m_params, next_batch(out), out["caches"], thr)
                torch.cuda.synchronize()
                steps_s.append(time.perf_counter() - t1)
                outs.append(out)
            wall = time.perf_counter() - t0
        counts = read_counts()
        B, n_calls = outs[0]["token"].shape[0], 1 + STEPS_DECODE
        n_heads = len(mcfg.exit_stages) + 1
        print(f"{label} batched steps: prefill {t_pre:.3f} s, {STEPS_DECODE} decode steps "
              f"{wall - t_pre:.3f} s (the first {steps_s[0] * 1e3:.1f} ms, the median "
              f"{float(np.median(steps_s)) * 1e3:.1f} ms), "
              f"{B * n_calls} tokens in {wall:.3f} s ({B * n_calls / wall:.1f} tokens/s); peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {counts}; "
              f"exit stages of the last call {outs[-1]['exit_stage'].tolist()}", flush=True)
        check(f"{label} steps launched flash once per layer of the prefill",
              counts["flash_attention"] == mcfg.num_layers, f"{counts['flash_attention']} launches")
        # the one-token decode takes the decode kernel where its caches are
        # full (no ring shorter than max_len) at a head dim it takes, once
        # per layer and step per chunk of MMA_G query heads per KV head
        dims = mcfg.attn_dims()
        takes = ((dims.sliding_window is None or dims.sliding_window >= max_len)
                 and dims.head_dim in ops.DECODE_HEAD_DIMS)
        want = mcfg.num_layers * STEPS_DECODE * -(-dims.groups // kdec.MMA_G) if takes else 0
        check(f"{label} steps launched the decode kernel {want} times (full caches at a head "
              f"dim it takes; else the plain one-token attention) and no paged one",
              counts["decode_attention"] == want and counts["paged_decode_attention"] == 0,
              f"{counts}")
        check_head_passes(f"{label} steps", rows, counts["exit_confidence"])
        check(f"{label} steps: every head of every call ran", len(rows) == n_calls * n_heads,
              f"{len(rows)} head calls for {n_calls} calls x {n_heads} heads")
        S = batch["embeds" if "embeds" in batch else "tokens"].shape[1]
        pos_ok = all(bool(torch.all(c["pos"] == S + STEPS_DECODE))
                     for stage in outs[-1]["caches"] for c in stage)
        fine = all(bool(torch.isfinite(o["exit_conf"]).all()) and bool(((o["exit_conf"] >= 0)
                   & (o["exit_conf"] <= 1)).all()) and bool(((o["token"] >= 0)
                   & (o["token"] < mcfg.vocab_size)).all()) for o in outs)
        check(f"{label} steps: outputs finite and in range, every cache at position {S + STEPS_DECODE}",
              pos_ok and fine, f"positions advanced {pos_ok}; conf in [0, 1] and tokens in the vocab "
              f"{fine}")
        step_counts[label] = counts
        return outs, counts, wall

    def block_card_vs_cpu(mcfg, m_params, label):
        """Stage 1's first block (attention + FFN) prefilled on the card with
        the kernels (flash) and on the CPU with the plain versions, same
        weights and input (B 2, S 160: two 128-row query tiles), norm-wise
        at 2^-7 on the output and on the K cache."""
        blk = model_lib._period(m_params["stages"][0]["blocks"][0], 0)
        x = torch.randn((2, 160, mcfg.d_model), generator=steps_gen, device=dev).bfloat16()
        pos = torch.arange(160, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        n0 = kflash.flash_attention.launches
        y_c, c_c, _ = model_lib._block_apply("attn", blk, x, mcfg, pos, "prefill", 161)
        torch.cuda.synchronize()
        n_flash = kflash.flash_attention.launches - n0
        y_h, c_h, _ = model_lib._block_apply("attn", model_lib.params_to(blk, "cpu"), x.cpu(),
                                             mcfg, pos.cpu(), "prefill", 161)
        rel_y, rel_k = rel_norm(y_c.cpu(), y_h), rel_norm(c_c["k"].cpu(), c_h["k"])
        check(f"{label} one full-width block ({mcfg.norm}, {mcfg.num_heads} heads of "
              f"{mcfg.head_dim}, {mcfg.ffn} FFN with {mcfg.act}), card (flash) vs CPU (plain), "
              f"prefill B 2 S 160 ({time.perf_counter() - t0:.1f} s)",
              rel_y <= 2**-7 and rel_k <= 2**-7 and n_flash == 1,
              f"norm-wise rel output {rel_y:.3g}, K cache {rel_k:.3g} (tol 2^-7 = {2**-7:.3g}); "
              f"flash launches on the card {n_flash}")

    for arch, (B_, S_) in EMBEDS_STEPS.items():
        phase(f"{arch} through the batched steps")
        mcfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m_params = model_lib.init_params(mcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(m_params))
        print(f"{arch} full width: {mcfg.num_layers} layers, {mcfg.num_stages} stages (exits after "
              f"{mcfg.exit_stages}), d {mcfg.d_model}, {mcfg.num_heads} heads of {mcfg.head_dim}, "
              f"{mcfg.norm}, {mcfg.ffn} FFN d_ff {mcfg.d_ff} ({mcfg.act}), vocab {mcfg.vocab_size}, "
              f"embeddings in; {n / 1e9:.3f} B params ({n * 2 / 1e9:.1f} GB in bf16); set-up "
              f"{time.perf_counter() - t0:.1f} s; batch B {B_}, S {S_}", flush=True)

        def embeds(s_len, B=B_, d_=mcfg.d_model):
            return {"embeds": (torch.randn((B, s_len, d_), generator=steps_gen, device=dev) * 0.1)
                    .bfloat16()}

        run_steps(mcfg, m_params, embeds(S_), lambda out: embeds(1), S_ + STEPS_DECODE, arch)
        block_card_vs_cpu(mcfg, m_params, arch)
        heads[arch] = m_params["lm_head"]
        del m_params
        free(arch)

    # mixtral-8x7b at full width and half depth (16 layers, 4 periods per
    # stage; the full 32 layers need ~93 GB): served dense and paged through
    # the engine (full caches: max_len lies far within the window), then one
    # 4160-token prompt through the batched steps, whose prefill leaves a
    # ring of the window's 4096 slots (positions 64..4159) that the 8 decode
    # steps wrap.  Witness, block by block: each decode block's attention
    # (``attention.gqa_decode``) on the ring run's input to it, against a
    # full max_len cache of the prefill's keys and values under the window
    # mask (the reference's other branch), carried through the 8 steps.
    # The ring keeps its keys in slot order, a rotation of the positions, so
    # P V sums the same terms in another order: the outputs are held to the
    # ring's at the bf16 tolerance and at 2^-7 norm-wise, and the gate is
    # shown to reject the witness's window one 128-key tile short.
    phase("mixtral-8x7b (16 layers) serve and batched steps")
    xcfg = dataclasses.replace(xcfg_full, num_layers=MIXTRAL_LAYERS)
    x_engine, x_params, _ = serve_model(xcfg, MIXTRAL_REQUESTS, MIXTRAL_GEN,
                                        ("exit_confidence", "decode_attention", "flash_attention"),
                                        ("paged_decode_attention", "flash_attention"))
    del x_engine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x_tokens = torch.randint(0, xcfg.vocab_size, (1, MIXTRAL_PROMPT), generator=steps_gen, device=dev)
    from repro_torch.models import attention as attention_lib

    real_cache, real_attn = model_lib._cache_from_kv, attention_lib.gqa_decode
    prefill_kv, ring_attn = [], []  # per layer (k, v, dims); per decode block (params, x, dims, out)

    def recording_cache(k_, v_, dims, len_):
        prefill_kv.append((k_.clone(), v_.clone(), dims))
        return real_cache(k_, v_, dims, len_)

    def recording_attn(p_, x_, cache_, dims):
        out_, c_ = real_attn(p_, x_, cache_, dims)
        ring_attn.append((p_, x_.clone(), dims, out_.clone()))
        return out_, c_

    model_lib._cache_from_kv, attention_lib.gqa_decode = recording_cache, recording_attn
    try:
        ring_outs, _, _ = run_steps(xcfg, x_params, {"tokens": x_tokens},
                                    lambda out: {"tokens": out["token"][:, None]},
                                    MIXTRAL_PROMPT + STEPS_DECODE, "mixtral-8x7b")
    finally:
        model_lib._cache_from_kv, attention_lib.gqa_decode = real_cache, real_attn
    x_len, x_W, n_layers = MIXTRAL_PROMPT + STEPS_DECODE, xcfg.sliding_window, xcfg.num_layers
    attn_rel, attn_close, fault = [], True, None
    for layer, (k_, v_, dims) in enumerate(prefill_kv):
        full = real_cache(k_, v_, dataclasses.replace(dims, sliding_window=None), x_len)
        for t in range(STEPS_DECODE):
            p_, x_, dims_, out_ring = ring_attn[t * n_layers + layer]
            if layer == 0 and t == STEPS_DECODE - 1:
                short = dict(full, k=full["k"].clone(), v=full["v"].clone())
                o_f, _ = real_attn(p_, x_, short,
                                   dataclasses.replace(dims_, sliding_window=x_W - 128))
                fault = (bf16_close(o_f, out_ring)[0] and rel_norm(o_f, out_ring) <= 2**-7,
                         rel_norm(o_f, out_ring))
                del short, o_f
            out_w, full = real_attn(p_, x_, full, dims_)
            attn_close &= bf16_close(out_w, out_ring)[0]
            attn_rel.append(rel_norm(out_w, out_ring))
        witness_k = tuple(full["k"].shape)
        del full
    ring_c = ring_outs[-1]["caches"][0][0]
    slot_pos = ring_outs[0]["slot_pos_after_prefill"]
    check("mixtral-8x7b steps: the prefill left a ring of the window's slots, wrapped by decode",
          tuple(ring_c["k"].shape[2:3]) == (x_W,) and witness_k[1] == x_len
          and bool(torch.equal(torch.sort(slot_pos[0]).values,
                               torch.arange(MIXTRAL_PROMPT - x_W, MIXTRAL_PROMPT, device=dev,
                                            dtype=torch.int32)))
          and bool(torch.equal(torch.sort(ring_c["slot_pos"][0]).values,
                               torch.arange(x_len - x_W, x_len, device=dev, dtype=torch.int32))),
          f"ring k {tuple(ring_c['k'].shape)}, after prefill positions "
          f"{int(slot_pos[0].min())}..{int(slot_pos[0].max())}, after decode "
          f"{int(ring_c['slot_pos'][0].min())}..{int(ring_c['slot_pos'][0].max())}; witness k "
          f"{witness_k}")
    n_blocks = STEPS_DECODE * n_layers
    check("mixtral-8x7b steps: each decode block's ring attention against the full-cache witness "
          "under the window mask, on the ring run's inputs",
          len(prefill_kv) == n_layers and len(ring_attn) == len(attn_rel) == n_blocks and attn_close
          and max(attn_rel) <= 2**-7,
          f"{len(attn_rel)} of {n_blocks} blocks, max norm-wise rel {max(attn_rel):.3g} (tol 2^-7), "
          f"all at the bf16 tolerance element-wise {attn_close}")
    check("mixtral-8x7b steps: the witness gate rejects a planted fault: the window one 128-key "
          "tile short (layer 0, the last step)", fault is not None and not fault[0],
          f"norm-wise rel {fault[1]:.3g}" if fault else "not run")
    heads["mixtral-8x7b"] = x_params["lm_head"]
    del x_params, ring_outs, ring_c, prefill_kv, ring_attn
    free("mixtral-8x7b")

    # -- 8. times -------------------------------------------------------------
    phase("times (device time from the profiler, cold L2, mean over launches)")
    # phase 10 (d)'s † cells on the host's CPU, beside the device timings
    dagger_proc = start_dagger_sweep()
    flush = L2Flush(dev)
    kernels_out = []

    def time_head(w_lm, B):
        """The exit head at B rows on one model's LM head: the kernel and its
        library yardstick in turns (kernel, library, library, kernel,
        twice; the medians of 4 readings each), the bound, and at B 8 the
        plain version."""
        d_, V_ = w_lm.shape
        h = torch.randn((B, d_), generator=gen, device=dev).bfloat16()

        def library_head():
            logits = torch.matmul(h, w_lm).float()
            return logits.max(-1).values, torch.logsumexp(logits, -1), logits.argmax(-1)

        def kernel_head():
            return kexit.exit_confidence(h, w_lm)

        head_ms = {"kernel": [], "library": []}
        for _ in range(2):
            for tag, fn in (("kernel", kernel_head), ("library", library_head),
                            ("library", library_head), ("kernel", kernel_head)):
                head_ms[tag].append(time_cold(fn, 50, flush))
        t_k, t_l = (float(np.median(head_ms[tag])) for tag in ("kernel", "library"))
        t_p = time_cold(lambda: ref.exit_confidence_ref(h, w_lm), 10, flush) if B == BATCH else None
        bytes_ = d_ * V_ * 2 + B * d_ * 2 + B * 8
        flops = 2 * B * d_ * V_
        b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
        bound = max(b_bytes, b_ops)
        plain = f", plain {t_p:.4f} ms" if t_p is not None else ""
        print(f"exit_confidence B={B} d={d_} V={V_}: kernel {t_k:.4f} ms at {bound / t_k:.1%} of the "
              f"bound, library (bf16 matmul + max/logsumexp/argmax) {t_l:.4f} ms at {bound / t_l:.1%} "
              f"(kernel / library {t_k / t_l:.3f}){plain}, bound {bound:.4f} ms "
              f"({'bytes' if b_bytes >= b_ops else 'operations'}: {bytes_ / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)")
        print("  in turns, ms: " + "; ".join(
            f"{tag} {' '.join(f'{t:.5f}' for t in ts)} (median {np.median(ts):.5f}, spread "
            f"{max(ts) - min(ts):.5f})" for tag, ts in head_ms.items()), flush=True)
        return t_k, t_p, t_l, bound, "bytes" if b_bytes >= b_ops else "operations"

    # every LM head at B 1, 8 and 32, medians of 4 in turns.  The entries:
    # stablelm-1.6b's head (launches in its serve), the heads of zamba2-2.7b,
    # xlstm-350m and mixtral-8x7b (launches in their dense serves), and those
    # of phi-3-vision-4.2b and musicgen-medium (launches in their steps runs)
    head_entries = {"stablelm-1.6b": ("exit_confidence", launches["exit_confidence"],
                                      max_err["exit_confidence"])}
    for arch, tag in (("zamba2-2.7b", "zamba2"), ("xlstm-350m", "xlstm"), ("mixtral-8x7b", "mixtral"),
                      ("phi-3-vision-4.2b", "phi3"), ("musicgen-medium", "musicgen")):
        counts = serve_counts[arch]["dense"] if arch in serve_counts else step_counts[arch]
        head_entries[arch] = (f"exit_confidence_{tag}_head", counts["exit_confidence"],
                              max_err[f"exit_confidence {arch}"])
    for arch in ("stablelm-1.6b", "glm4-9b", "deepseek-v2-lite-16b", "internlm2-20b", "qwen2.5-32b",
                 "zamba2-2.7b", "xlstm-350m", "mixtral-8x7b", "phi-3-vision-4.2b", "musicgen-medium"):
        print(f"{arch}'s LM head:")
        w_lm = heads.pop(arch)
        for B in (1, BATCH, 32):
            t_k, t_p, t_l, bound, bound_by = time_head(w_lm, B)
            if arch in head_entries and B == BATCH:
                name, n_launch, err = head_entries[arch]
                kernels_out.append({
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/exit_confidence.cu",
                    "replaces": "src/repro/kernels/exit_confidence.py:111",
                    "launches": n_launch, "max_abs_err": err,
                    "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": t_l,
                })
        del w_lm

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

    def time_decode(name, heads, S, lengths, g=gen):
        """Both decode kernels (paged at bs 16 on shuffled blocks), their
        plain versions, SDPA (length mask, GQA) and the bounds at one
        model's heads, printed; returns the numbers."""
        hq, kvh, hd_ = heads
        q, k, v, ln = dec_inputs(BATCH, S, hq, kvh, hd_, lengths, g)
        args = paged_inputs(BATCH, hq, kvh, hd_, BLOCK, lengths, -(-S // BLOCK), g)
        iters = 200 if S <= max(max_len, g_len, z_max_len) else 100
        t = {"ms": time_cold(lambda: kdec.decode_attention(q, k, v, ln), iters, flush),
             "paged_ms": time_cold(lambda: kpaged.paged_decode_attention(*args, seq_len=S), iters, flush),
             "plain_ms": time_cold(lambda: ref.decode_attention_ref(q, k, v, ln), iters // 10, flush),
             "paged_plain_ms": time_cold(lambda: ref.paged_decode_attention_ref(*args, seq_len=S),
                                         iters // 10, flush)}
        mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None, None, :]
        t["library_ms"] = time_cold(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True),
            iters, flush)
        tot = int(sum(lengths))
        bytes_ = 2 * tot * kvh * hd_ * 2 + 2 * BATCH * hq * hd_ * 2 + BATCH * 4
        blocks_read = sum(-(-n // BLOCK) for n in lengths)
        flops = 4 * tot * hq * hd_
        b_ops = flops / PEAK_FLOPS_BF16 * 1e3
        for key, b_bytes in (("", bytes_ / HBM_BW * 1e3), ("paged_", (bytes_ + blocks_read * 4) / HBM_BW * 1e3)):
            t[f"{key}bound_ms"] = max(b_bytes, b_ops)
            t[f"{key}bound_by"] = "bytes" if b_bytes >= b_ops else "operations"
        print(f"{name} decode G={hq // kvh} B={BATCH} S={S} Hq={hq} KVH={kvh} hd={hd_} lengths "
              f"{min(lengths)}..{max(lengths)}: decode_attention {t['ms']:.4f} ms, paged_decode_attention "
              f"(bs {BLOCK}) {t['paged_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms (paged plain "
              f"{t['paged_plain_ms']:.4f} ms), library (SDPA, length mask, GQA) {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}: {bytes_ / 1e6:.3f} MB, {flops / 1e6:.1f} "
              f"MFLOP; paged {t['paged_bound_ms']:.5f} ms with {blocks_read} table entries)", flush=True)
        del q, k, v, args
        return t

    # both decode kernels at G 5 and G 6 (hd 128), at G 24 and G 32 (in
    # chunks of 16 heads per KV head), at the serve's lengths and on the
    # long cache; at glm4-9b's shapes (G 16, hd 128); on the long cache (S
    # 4096) at glm4-9b's heads and at stablelm-1.6b's
    for name, heads in {**GQA_HEADS, **WIDE_HEADS}.items():
        for label, S, lengths in gqa_lengths:
            time_decode(f"{name} {label}", heads, S, lengths)
    time_decode("glm4-9b", glm_heads, g_len, GLM_LENGTHS)
    for name, heads in long_heads.items():
        time_decode(f"{name} long-cache", heads, LONG_S, LONG_LENGTHS)

    # zamba2-2.7b's attention at hd 80: both decode kernels at the serve's
    # lengths (the entries) and on the long cache.  Launches: the zamba2
    # serves' (dense for decode and flash, paged for paged decode).
    z_counts = serve_counts["zamba2-2.7b"]
    for label, S, lengths in z_decode:
        t = time_decode(f"zamba2-2.7b {label}", z_heads, S, lengths, gen80)
        if label == "serve lengths":
            kernels_out += [{
                "name": "decode_attention_hd80", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:124",
                "launches": z_counts["dense"]["decode_attention"],
                "max_abs_err": max_err["decode_attention hd 80"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
            }, {
                "name": "paged_decode_attention_hd80", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                "replaces": "src/repro/kernels/paged_decode_attention.py:148",
                "launches": z_counts["paged"]["paged_decode_attention"],
                "max_abs_err": max_err["paged_decode_attention hd 80"], "ms": t["paged_ms"],
                "plain_ms": t["paged_plain_ms"], "bound_ms": t["paged_bound_ms"],
                "bound_by": t["paged_bound_by"], "library_ms": None,
            }]

    # mixtral-8x7b's attention at G 4, hd 128: both decode kernels at its
    # engine serve's lengths (the entries) and on the long cache.  Launches:
    # the mixtral serves' (dense for decode, paged for paged decode).
    x_counts = serve_counts["mixtral-8x7b"]
    for label, S, lengths in x_decode:
        t = time_decode(f"mixtral-8x7b {label}", x_heads, S, lengths, gen96)
        if label == "serve lengths":
            kernels_out += [{
                "name": "decode_attention_g4", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:124",
                "launches": x_counts["dense"]["decode_attention"],
                "max_abs_err": max_err["decode_attention G 4"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
            }, {
                "name": "paged_decode_attention_g4", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                "replaces": "src/repro/kernels/paged_decode_attention.py:148",
                "launches": x_counts["paged"]["paged_decode_attention"],
                "max_abs_err": max_err["paged_decode_attention G 4"], "ms": t["paged_ms"],
                "plain_ms": t["paged_plain_ms"], "bound_ms": t["paged_bound_ms"],
                "bound_by": t["paged_bound_by"], "library_ms": None,
            }]

    # prefill flash attention at every timed shape, stablelm's and glm4's
    # heads, then zamba2's at hd 80, phi-3-vision's at hd 96 and mixtral's
    # under its window; the first of each is its entry.  At the shapes of
    # more than one batch row the kernel and SDPA are timed in turns
    # (medians of 4), each reading printed with its launches' spread: one
    # reading in a run has come out 2x off before.  Under a window, SDPA
    # takes the band as a boolean mask, and the bound counts the band's
    # (row, key) pairs.
    def time_flash(label, B, S, hq, kvh, hd_, g=gen, window=None):
        q, k, v = flash_inputs(B, S, S, hq, kvh, hd_, g)
        band = None
        if window is not None:
            pos = torch.arange(S, device=dev)
            band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

        def library_flash():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=band,
                                                  is_causal=band is None, enable_gqa=True)

        def kernel_flash():
            return kflash.flash_attention(q, k, v, window=window)

        lib_err = float((library_flash().transpose(1, 2).float()
                         - ref.flash_attention_ref(q, k, v, window=window).float()).abs().max())
        turns = [("kernel", kernel_flash), ("library", library_flash)]
        if B > 1:
            turns = (turns + turns[::-1]) * 2
        readings = {"kernel": [], "library": []}
        for tag, fn in turns:
            st = {}
            readings[tag].append((time_cold(fn, 100, flush, stats=st), launch_summary(st)))
        t_k, t_l = (float(np.median([ms for ms, _ in readings[tag]])) for tag in ("kernel", "library"))
        t_p = time_cold(lambda: ref.flash_attention_ref(q, k, v, window=window), 10, flush)
        bytes_ = 2 * q.numel() * 2 + 2 * k.numel() * 2  # q and out, k and v
        # (row, key) pairs of the causal triangle, or of the window's band
        pairs = S * (S + 1) // 2 if window is None else sum(min(i + 1, window) for i in range(S))
        flops = 4 * B * hq * hd_ * pairs  # QK^T and PV over them
        b_bytes, b_ops = bytes_ / HBM_BW * 1e3, flops / PEAK_FLOPS_BF16 * 1e3
        by = "bytes" if b_bytes >= b_ops else "operations"
        print(f"flash_attention {label} B={B} S={S} Hq={hq} KVH={kvh} hd={hd_} window={window}: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, library (SDPA, {'is_causal' if band is None else 'band mask'}, "
              f"enable_gqa; max|diff| vs plain "
              f"{lib_err:.3g}) {t_l:.4f} ms, bound {max(b_bytes, b_ops):.5f} ms ({by}: "
              f"{bytes_ / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        for tag, rs in readings.items():
            for ms, summary in rs:
                print(f"  {tag} {ms:.5f} ms: {summary}")
        del q, k, v, band
        return {"ms": t_k, "plain_ms": t_p, "bound_ms": max(b_bytes, b_ops), "bound_by": by,
                "library_ms": t_l}

    for entry, shapes, g, n_launch, err_key in (
            ("flash_attention", FLASH_SHAPES, gen, launches["flash_attention"], "flash_attention"),
            ("flash_attention_hd80", ZAMBA_FLASH, gen80, z_counts["dense"]["flash_attention"],
             "flash_attention hd 80"),
            ("flash_attention_hd96", PHI_FLASH, gen96, step_counts["phi-3-vision-4.2b"]["flash_attention"],
             "flash_attention hd 96"),
            ("flash_attention_window", MIXTRAL_FLASH, gen96,
             step_counts["mixtral-8x7b"]["flash_attention"], "flash_attention window")):
        for n_shape, shape in enumerate(shapes):
            t = time_flash(*shape[:6], g, *shape[6:])
            if n_shape == 0:
                kernels_out.append({
                    "name": entry, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:172",
                    "launches": n_launch, "max_abs_err": max_err[err_key], **t,
                })

    split_phase(dev, dec_lengths, max_len, flush)

    del heads
    # phase 10 (d)'s dry runs: CPU only, beside phases 9 and 10 on the card
    # (xlstm's two cells after the timed phases, whose profiles their load
    # would share the host with)
    dryrun_proc, xlstm_proc = start_dryrun(), start_xlstm_sweep()
    try:
        train_phase(dev, read_counts, zero_counts)
        multidevice_phase(dev, read_counts, zero_counts, dryrun_proc, dagger_proc, xlstm_proc)
    finally:
        if dryrun_proc.poll() is None:
            dryrun_proc.kill()
            dryrun_proc.wait()
        stop_group(dagger_proc)
        stop_group(xlstm_proc)
    examples_phase()

    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}))


# the split phase (8b): the decode kernel's partials, split-KV and
# vocab-split combines on one card, their planted faults and timings
SPLIT_SEED = SEED + 23
# (label, query heads, KV heads, head dim) of the partial decode's gates: G 1,
# 4 and 16 at head dims 64, 80 and 128
SPLIT_HEADS = tuple((f"G {g} hd {hd_}", 4 * g, 4, hd_) for g in (1, 4, 16) for hd_ in (64, 80, 128))
# a one-card split of a 4096-key cache into n shards (3: unaligned to the
# walk's 512-key splits), and of stablelm-1.6b's LM head into n vocab blocks
KV_SHARDS = (2, 3, 8)
VOCAB_SHARDS = (2, 4, 16)
# rows of the split gates: a row of length 0, rows ending in the first shard
# (the later shards empty), and rows spanning several
SPLIT_LENGTHS = [0, 100, 511, 512, 1500, 3000, 4095, 4096]
# rows 1 and 2 with the new outputs against the null-output calls, in turns
SPLIT_TIME_TOL = 0.03
# phi-3-vision-4.2b's LM head over a 16-wide "model" axis: 2004 columns a
# device; and a split into blocks of odd and 2-mod-4 widths (the rest odd)
PHI_VOCAB_SHARDS = 16
PHI_ODD_BLOCKS = (2003, 2002)


def split_phase(dev, dec_lengths: list[int], max_len: int, flush: "L2Flush") -> dict:
    """Phase 8b (see the module docstring): on one card, the sharded steps'
    kernel paths.  Returns the timings for the record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import exit_confidence as kexit
    from repro_torch.kernels import ops, ref

    phase("split partials: split-KV decode and the vocab-split exit head on one card")
    g = torch.Generator(device=dev).manual_seed(SPLIT_SEED)

    def dec_inputs(B, S, hq, kvh, hd_, lengths):
        q = torch.randn((B, hq, hd_), generator=g, device=dev).bfloat16()
        k = torch.randn((B, S, kvh, hd_), generator=g, device=dev).bfloat16()
        v = torch.randn((B, S, kvh, hd_), generator=g, device=dev).bfloat16()
        return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)

    # (1) the partial outputs against the plain version, and rounded against
    # the null-output call bit for bit
    for label, hq, kvh, hd_ in SPLIT_HEADS:
        for S, lengths in ((max_len, [0] + dec_lengths[1:]), (LONG_S, [0] + LONG_LENGTHS[1:])):
            q, k, v, ln = dec_inputs(len(lengths), S, hq, kvh, hd_, lengths)
            o, lse = kdec.decode_attention_partial(q, k, v, ln)
            o32, lse32 = ref.decode_attention_partial_ref(q, k, v, ln, f32_scores=True)
            orf, _ = ref.decode_attention_partial_ref(q, k, v, ln)
            same = torch.equal(o.bfloat16(), kdec.decode_attention(q, k, v, ln))
            ok_o, err_o, _ = bf16_close(o, o32)
            err_ref = float((o - orf).abs().max())
            live = ln > 0
            err_lse = float((lse[live] - lse32[live]).abs().max())
            empty = bool((o[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
            check(f"decode_attention_partial {label} S={S}",
                  ok_o and err_ref <= 2e-2 and err_lse <= 1e-3 and empty and same,
                  f"o against the f32-score plain version max|diff| {err_o:.3g} (rtol 1.6e-2, atol "
                  f"1e-2), against the plain version {err_ref:.3g} (tol 2e-2); lse max|diff| "
                  f"{err_lse:.3g} (tol 1e-3); length-0 row (0, -inf) {empty}; o rounded == the "
                  f"null-output call's output bit for bit {same}")
            del q, k, v, o, lse, o32, lse32, orf

    # (2) a 4096-key cache split into n shards on one card: each shard's
    # partial by the kernel, combined, against the unsplit kernel
    def shard_partials(q, k, v, ln, n, offset=True):
        parts, lo = [], 0
        for kc, vc in zip(torch.chunk(k, n, dim=1), torch.chunk(v, n, dim=1)):
            local = (ln - (lo if offset else 0)).clamp(0, kc.shape[1]).to(torch.int32)
            parts.append(kdec.decode_attention_partial(q, kc.contiguous(), vc.contiguous(), local))
            lo += kc.shape[1]
        return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])

    for label, hq, kvh, hd_ in SPLIT_HEADS[::4]:
        q, k, v, ln = dec_inputs(len(SPLIT_LENGTHS), LONG_S, hq, kvh, hd_, SPLIT_LENGTHS)
        whole = kdec.decode_attention(q, k, v, ln)
        for n in KV_SHARDS:
            o, lse = shard_partials(q, k, v, ln, n)
            got = ops.combine_partials(o, lse).bfloat16()
            ok, err, _ = bf16_close(got, whole)
            ulp = float(((got.float() - whole.float()).abs()
                         / whole.float().abs().clamp_min(2.0**-126)).max())
            check(f"split-KV decode {label} over {n} shards of {LONG_S // n}+ keys", ok,
                  f"combined against the unsplit kernel max|diff| {err:.3g} (rtol 1.6e-2, atol "
                  f"1e-2), max rel diff {ulp:.3g}")
            if n == KV_SHARDS[0]:
                w_free = o.sum(0) / (lse > -math.inf).sum(0).clamp_min(1)[..., None]
                ok_f, err_f, _ = bf16_close(w_free.bfloat16(), whole)
                check(f"split-KV gate rejects a combine without the lse weights ({label})", not ok_f,
                      f"max|diff| {err_f:.3g}")
                o_f, lse_f = shard_partials(q, k, v, ln, n, offset=False)
                got_f = ops.combine_partials(o_f, lse_f).bfloat16()
                ok_f, err_f, _ = bf16_close(got_f, whole)
                check(f"split-KV gate rejects local lengths without the shard's offset ({label})",
                      not ok_f, f"max|diff| {err_f:.3g}")
        del q, k, v, whole

    # (3) the exit head's max logit, and stablelm-1.6b's LM head cut into
    # vocab blocks, each block's partial by the kernel, combined
    cfg = get_config("stablelm-1.6b")
    d, V = cfg.d_model, cfg.vocab_size
    h = torch.randn((BATCH, d), generator=g, device=dev)
    w = torch.randn((d, V), generator=g, device=dev) / math.sqrt(d)
    tgt = torch.randperm(V, generator=g, device=dev)[:BATCH]
    # row 0's target in the first of the smallest vocab blocks
    tgt[0] = int(torch.randint(0, V // VOCAB_SHARDS[-1], (1,), generator=g, device=dev))
    if len(set(tgt.tolist())) != BATCH:
        raise RuntimeError("split head inputs: two rows share a target column")
    w[:, tgt] += 8.0 * (h / h.norm(dim=1, keepdim=True) ** 2).T
    # a tie across vocab blocks: row 0's top column copied into the last
    # block, where the combine must keep the first
    j1, j2 = int(tgt[0]), V - 1
    w[:, j2] = w[:, j1]
    h, w = h.bfloat16(), w.bfloat16()
    c, i, m = kexit.exit_confidence_partial(h, w)
    cr, ir, mr = ref.exit_confidence_partial_ref(h, w)
    ok, err, rel = conf_close(c, cr)
    err_m = float((m - mr).abs().max())
    c0, i0 = kexit.exit_confidence(h, w)
    check("exit_confidence_partial stablelm head B=8", ok and torch.equal(i, ir) and err_m <= 1e-3
          and torch.equal(c, c0) and torch.equal(i, i0),
          f"conf max|err| {err:.3g}, rel {rel:.3g}; argmax equal {torch.equal(i, ir)}; max logit "
          f"max|diff| {err_m:.3g} (tol 1e-3); conf and argmax == the null-output call's "
          f"{torch.equal(c, c0) and torch.equal(i, i0)}")
    for n in VOCAB_SHARDS:
        parts, lo = [], 0
        for wc in torch.chunk(w, n, dim=1):
            cc, ic, mc = kexit.exit_confidence_partial(h, wc.contiguous())
            parts.append((cc, ic + lo, mc, ic))
            lo += wc.shape[1]
        conf, idx = ops.combine_exit_partials(*(torch.stack([p[j] for p in parts]) for j in range(3)))
        ok, err, rel = conf_close(conf, c0)
        check(f"vocab-split exit head over {n} blocks of {V // n} columns",
              ok and torch.equal(idx, i0) and int(idx[0]) == j1,
              f"conf max|err| {err:.3g} (atol 1e-3), rel {rel:.3g} (rtol 1e-4); argmax equal "
              f"{torch.equal(idx, i0)}; the tie at columns {j1} and {j2} kept at {int(idx[0])}")
        if n == VOCAB_SHARDS[0]:
            _, idx_f = ops.combine_exit_partials(*(torch.stack([p[j] for p in parts])
                                                   for j in (0, 3, 2)))
            check("vocab-split gate rejects an argmax without its block's offset",
                  not torch.equal(idx_f, i0), f"{int((idx_f != i0).sum())} of {BATCH} rows differ")

    # (4) rows 1 and 2 with the new outputs, in turns with the null-output
    # calls (null, new, new, null, twice; medians of 4)
    q, k, v, ln = dec_inputs(BATCH, max_len, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             dec_lengths)
    ql, kl, vl, lnl = dec_inputs(BATCH, LONG_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                 LONG_LENGTHS)
    pairs = {
        "decode_attention serve lengths": (lambda: kdec.decode_attention(q, k, v, ln),
                                           lambda: kdec.decode_attention_partial(q, k, v, ln), 200),
        "decode_attention S 4096": (lambda: kdec.decode_attention(ql, kl, vl, lnl),
                                    lambda: kdec.decode_attention_partial(ql, kl, vl, lnl), 100),
        "exit_confidence stablelm head B 8": (lambda: kexit.exit_confidence(h, w),
                                              lambda: kexit.exit_confidence_partial(h, w), 50),
    }
    out, smi = {}, nvidia_smi()
    for name, (null_fn, new_fn, iters) in pairs.items():
        ms = {"null": [], "new": []}
        for _ in range(2):
            for tag, fn in (("null", null_fn), ("new", new_fn), ("new", new_fn), ("null", null_fn)):
                ms[tag].append(time_cold(fn, iters, flush))
        t_null, t_new = (float(np.median(ms[t])) for t in ("null", "new"))
        out[name] = (t_null, t_new)
        print(f"{name} on {smi}: null outputs {t_null:.5f} ms, with the new outputs {t_new:.5f} "
              f"ms ({t_new / t_null - 1:+.2%}); in turns: " + "; ".join(
                  f"{t} {' '.join(f'{x:.5f}' for x in xs)}" for t, xs in ms.items()), flush=True)
        check(f"{name}: the new outputs within {SPLIT_TIME_TOL:.0%} of the null-output calls",
              abs(t_new / t_null - 1) <= SPLIT_TIME_TOL, f"{t_new / t_null - 1:+.2%}")
    del q, k, v, ql, kl, vl, h, w
    out["phi3 shard"] = unaligned_head_gates(dev, g, flush)
    return out


def unaligned_head_gates(dev, g, flush: "L2Flush") -> dict:
    """Phase 8b's vocab blocks whose rows are no whole number of 16-byte
    units (see the module docstring): phi-3-vision-4.2b's head in its 16
    blocks of 2004 columns and in blocks of odd and 2-mod-4 widths, and one
    2004-wide block timed.  Returns the timings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import exit_confidence as kexit
    from repro_torch.kernels import ops, ref
    from repro_torch.roofline.constants import HBM_BW, PEAK_FLOPS_BF16

    cfg = get_config("phi-3-vision-4.2b")
    d, V = cfg.d_model, cfg.vocab_size
    width = V // PHI_VOCAB_SHARDS
    h = torch.randn((BATCH, d), generator=g, device=dev)
    w = torch.randn((d, V), generator=g, device=dev) / math.sqrt(d)
    # row 0's top: the last column of block 5; row 1's: the last block's
    # first; the other rows' at random columns
    edge = [6 * width - 1, (PHI_VOCAB_SHARDS - 1) * width]
    rest = [c for c in torch.randperm(V, generator=g, device=dev)[:BATCH].tolist()
            if c not in edge]
    tgt = torch.tensor(edge + rest[:BATCH - 2], device=dev)
    w[:, tgt] += 8.0 * (h / h.norm(dim=1, keepdim=True) ** 2).T
    h, w = h.bfloat16(), w.bfloat16()
    c0, i0 = kexit.exit_confidence(h, w)  # the unsplit head (V % 8 == 0: TMA)
    edges = [0, *np.cumsum(PHI_ODD_BLOCKS).tolist(), V]
    splits = {f"{PHI_VOCAB_SHARDS} blocks of {width} columns":
              [(j * width, (j + 1) * width) for j in range(PHI_VOCAB_SHARDS)],
              "blocks of " + ", ".join(str(b - a) for a, b in zip(edges, edges[1:]))
              + " columns": list(zip(edges, edges[1:]))}
    n0 = kexit.exit_confidence.launches
    for label, bounds in splits.items():
        parts, errs, pieces = [], [], set()
        for lo, hi in bounds:
            wc = w[:, lo:hi].contiguous()
            pieces.add(kexit.w_piece(hi - lo, wc.data_ptr()))
            cc, ic, mc = kexit.exit_confidence_partial(h, wc)
            cr, ir, mr = ref.exit_confidence_partial_ref(h, wc)
            ok, err, rel = conf_close(cc, cr)
            errs.append((ok and torch.equal(ic, ir), err, rel, float((mc - mr).abs().max())))
            parts.append((cc, ic + lo, mc))
        conf, idx = ops.combine_exit_partials(*(torch.stack([p[j] for p in parts])
                                                for j in range(3)))
        ok_c, err_c, rel_c = conf_close(conf, c0)
        ok_b = all(e[0] and e[3] <= 1e-3 for e in errs)
        check(f"phi-3-vision head, {label}: each block's partial by the cp.async path against "
              f"the plain version", ok_b and max(pieces) < 16,
              f"w pieces {sorted(pieces)} bytes; conf max|err| {max(e[1] for e in errs):.3g} "
              f"(atol 1e-3), rel {max(e[2] for e in errs):.3g} (rtol 1e-4); argmax equal in "
              f"{sum(e[0] for e in errs)} of {len(errs)} blocks; max logit max|diff| "
              f"{max(e[3] for e in errs):.3g} (tol 1e-3)")
        check(f"phi-3-vision head, {label}: combined against the unsplit kernel",
              ok_c and torch.equal(idx, i0) and idx[:2].tolist() == tgt[:2].tolist(),
              f"conf max|err| {err_c:.3g} (atol 1e-3), rel {rel_c:.3g} (rtol 1e-4); argmax equal "
              f"{torch.equal(idx, i0)}; rows 0 and 1 at {idx[:2].tolist()} (tops "
              f"{tgt[:2].tolist()})")
    # the planted fault: block 5 read without its last column (row 0's top)
    bounds = splits[f"{PHI_VOCAB_SHARDS} blocks of {width} columns"]
    parts = []
    for j, (lo, hi) in enumerate(bounds):
        cc, ic, mc = kexit.exit_confidence_partial(h, w[:, lo:hi - (j == 5)].contiguous())
        parts.append((cc, ic + lo, mc))
    conf_f, idx_f = ops.combine_exit_partials(*(torch.stack([p[j] for p in parts])
                                                for j in range(3)))
    ok_f, err_f, rel_f = conf_close(conf_f, c0)
    check("phi-3-vision head gate rejects a block read without its last column",
          not (ok_f and torch.equal(idx_f, i0)),
          f"conf max|err| {err_f:.3g}, rel {rel_f:.3g}; {int((idx_f != i0).sum())} of {BATCH} "
          f"argmaxes differ")
    print(f"  the unaligned blocks' gates launched the exit kernel "
          f"{kexit.exit_confidence.launches - n0} times", flush=True)

    # one 2004-wide block: the kernel (its partial, as a device of the split
    # head runs it) in turns with its library yardstick, at B 1, 8 and 32
    ws = w[:, :width].contiguous()
    out, smi = {}, nvidia_smi()
    for B in (1, BATCH, 32):
        hb = torch.randn((B, d), generator=g, device=dev).bfloat16()

        def library():
            logits = torch.matmul(hb, ws).float()
            return logits.max(-1).values, torch.logsumexp(logits, -1), logits.argmax(-1)

        def kernel():
            return kexit.exit_confidence_partial(hb, ws)

        ms = {"kernel": [], "library": []}
        for _ in range(2):
            for tag, fn in (("kernel", kernel), ("library", library), ("library", library),
                            ("kernel", kernel)):
                ms[tag].append(time_cold(fn, 50, flush))
        t_k, t_l = (float(np.median(ms[t])) for t in ("kernel", "library"))
        t_p = time_cold(lambda: ref.exit_confidence_partial_ref(hb, ws), 10, flush) \
            if B == BATCH else None
        bytes_ = d * width * 2 + B * d * 2 + B * 12  # w, h; conf, argmax, max logit
        b_bytes, b_ops = bytes_ / HBM_BW * 1e3, 2 * B * d * width / PEAK_FLOPS_BF16 * 1e3
        bound = max(b_bytes, b_ops)
        out[B] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
                  "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
        plain = f", plain {t_p:.4f} ms" if t_p is not None else ""
        print(f"exit_confidence_partial B={B} d={d} V={width} (w pieces of "
              f"{kexit.w_piece(width, ws.data_ptr())} bytes) on {smi}: kernel {t_k:.5f} ms at "
              f"{bound / t_k:.1%} of the bound, library {t_l:.5f} ms{plain}, bound {bound:.5f} ms "
              f"({out[B]['bound_by']}: {bytes_ / 1e6:.2f} MB); in turns: " + "; ".join(
                  f"{t} {' '.join(f'{x:.5f}' for x in xs)}" for t, xs in ms.items()), flush=True)
        check(f"the 2004-wide block timed at B {B}", math.isfinite(t_k) and t_k > 0,
              f"{t_k:.5f} ms")
    del h, w, ws
    return out


def train_phase(dev, read_counts, zero_counts) -> None:
    """Phase 9: full-width stablelm-1.6b trained for ``TRAIN_STEPS`` steps
    through ``training.make_train_step`` (f32 masters from the seed, the
    token stream at B 8, S 512, default AdamW with a warmup as long as the
    run), with five gates, each also shown rejecting a planted fault where
    one is named:

      (a) every step's loss and grad norm are finite (a non-finite grad
          element makes the norm non-finite), and step 1's every grad leaf;
      (b) step 1's Q, K and V projections have a nonzero gradient in every
          stage; planted: Q, K and V detached before attention, the cut a
          forward-only kernel makes;
      (c) no kernel launch counter moves over the steps, and a profiled
          step (a 7th) shows none of the kernels' device functions;
      (d) one full-width period (B 2, S 256) on the card against the CPU
          (same f32 weights and inputs): its output, and the gradient of
          every leaf and of the input for a seeded cotangent, norm-wise at
          2^-7 (the loss, ``sum(y * ct)``, is then held too: by
          Cauchy-Schwarz its gap is at most the output's relative gap times
          |y| |ct|); planted: one leaf's gradient zeroed;
      (e) ``CheckpointManager`` save and restore of step 6's (params,
          optimizer state), bit for bit.

    Prints each step's metrics, the median synchronized wall time of steps
    2-6, tokens/s, the peak device memory and the step's model FLOPs
    against the bf16 peak."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.models import attention as attention_lib
    from repro_torch.models import model as model_lib
    from repro_torch.roofline.constants import PEAK_FLOPS_BF16
    from repro_torch.runtime import CheckpointManager
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as train_step_lib

    phase("train: full-width stablelm-1.6b, f32 masters, AdamW")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    leaves = torch.utils._pytree.tree_leaves
    t0 = time.perf_counter()
    cfg = get_config("stablelm-1.6b")
    params = model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                                   master=True)
    opt_state = opt_lib.init_opt_state(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"stablelm-1.6b full width: {cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.4f} B params in f32 ({n_params * 4 / 1e9:.1f} GB, "
          f"m and v {n_params * 8 / 1e9:.1f} GB); set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=TRAIN_STEPS))
    stream = token_stream(cfg, DataConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=0), device=dev)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 1)]

    def qkv_norms(grads):
        """|dW| of Q, K and V for each period of each stage."""
        return [[[float(torch.linalg.vector_norm(st["blocks"][0]["attn"][w][i]))
                  for w in ("w_q", "w_k", "w_v")]
                 for i in range(st["blocks"][0]["attn"]["w_q"].shape[0])] for st in grads["stages"]]

    def reached(norms):
        return all(n > 0 for st in norms for period in st for n in period)

    def show(norms):  # per stage, its periods' smallest |dW_q|, |dW_k|, |dW_v|
        return "; ".join("/".join(f"{min(per[j] for per in st):.3g}" for j in range(3))
                         for st in norms)

    def loss_of(p_, b_):
        return model_lib.loss_fn(p_, b_, cfg)

    # (a) and (b): step 1's gradients, from the step's own loss on its batch
    _, _, grads = train_step_lib.value_and_grad(loss_of, params, batches[0])
    finite1 = all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    qkv = qkv_norms(grads)
    del grads

    zero_counts()
    losses, walls, finite = [], [], True
    for i, batch in enumerate(batches[:TRAIN_STEPS]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        vals = {k: float(v) for k, v in metrics.items()}  # synchronizes
        walls.append(time.perf_counter() - t1)
        finite &= all(math.isfinite(v) for v in vals.values())
        losses.append(vals["loss"])
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5g}" for k, v in sorted(vals.items()))
              + f"; wall {walls[-1] * 1e3:.1f} ms", flush=True)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_B * TRAIN_S
    wall = float(np.median(walls[1:]))
    # model FLOPs: 6 N T over the blocks' matmuls and the final head, the
    # remat forward of the blocks (2 N_blocks T) and the two exit heads'
    # forward and backward (6 d V T each); attention's score and value
    # products besides, forward, remat and backward
    n_head = cfg.d_model * cfg.vocab_size
    n_blocks = sum(t.numel() for t in leaves(params["stages"]) if t.ndim == 3)
    model_flops = (6 * (n_blocks + n_head) + 2 * n_blocks + 6 * n_head * len(cfg.exit_stages)) * tokens
    attn_flops = 4 * 4 * TRAIN_B * TRAIN_S * TRAIN_S * cfg.d_model * cfg.num_layers
    bound_ms = (model_flops + attn_flops) / PEAK_FLOPS_BF16 * 1e3
    print(f"train: {TRAIN_STEPS} steps of B {TRAIN_B} x S {TRAIN_S}; median wall of steps 2-"
          f"{TRAIN_STEPS} {wall * 1e3:.1f} ms (step 1 {walls[0] * 1e3:.1f} ms); {tokens / wall:.0f} tokens/s; peak device memory {peak:.2f} GiB; model FLOPs "
          f"{model_flops:.4g} + attention {attn_flops:.4g} a step: bound {bound_ms:.1f} ms at the "
          f"bf16 peak, {bound_ms / (wall * 1e3):.1%} of it reached; card {nvidia_smi()}", flush=True)
    check("train (a): every step's loss and grad norm finite, and every grad leaf of step 1",
          finite and finite1, f"losses {[round(x, 4) for x in losses]}")
    check("train (b): every period's Q, K and V projections got a nonzero gradient at step 1",
          reached(qkv), "per stage, the smallest over its periods of |dW_q|, |dW_k|, |dW_v| "
          + show(qkv))
    check("train (c): no kernel launched over the train steps", sum(counts.values()) == 0,
          f"launch counts {counts}")

    # (b)'s planted fault: Q, K and V detached before attention
    real_chunked = attention_lib.chunked_attention

    def cut(q, k, v, *args, **kw):
        return real_chunked(q.detach(), k.detach(), v.detach(), *args, **kw)

    attention_lib.chunked_attention = cut
    try:
        _, _, g_cut = train_step_lib.value_and_grad(loss_of, params, batches[0])
    finally:
        attention_lib.chunked_attention = real_chunked
    qkv_cut = qkv_norms(g_cut)
    del g_cut
    check("train (b) rejects a planted fault: Q, K and V detached before attention",
          not reached(qkv_cut), "per stage " + show(qkv_cut))

    # (e): the step-6 state through a checkpoint, bit for bit
    ckpt_root = Path(__file__).resolve().parent / "_train_ckpt"
    t1 = time.perf_counter()
    try:
        mgr = CheckpointManager(str(ckpt_root), keep=1)
        path = mgr.save(TRAIN_STEPS, (params, opt_state), {"arch": cfg.name})
        t_save = time.perf_counter() - t1
        restored, manifest = mgr.restore((params, opt_state))
        same = all(torch.equal(a, b) for a, b in zip(leaves((params, opt_state)), leaves(restored)))
        t_all = time.perf_counter() - t1
        n_leaves = manifest["num_leaves"]
        del restored
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    check("train (e): the step-6 (params, optimizer state) through CheckpointManager, bit for bit",
          same and manifest["step"] == TRAIN_STEPS,
          f"{n_leaves} leaves, {(n_params * 12 + 4) / 1e9:.1f} GB; save {t_save:.1f} s, restore "
          f"{t_all - t_save:.1f} s ({path})")

    # (c): a 7th step under the profiler
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    names = device_launches(lambda: step_fn(params, opt_state, batches[TRAIN_STEPS]))
    t_prof = time.perf_counter() - t1
    found = sorted({kernel_name(k) for k in names} & set(KERNEL_FUNCTIONS))
    n_dev = sum(len(v) for v in names.values())
    busy = {k: sum(v) / 1e3 for k, v in names.items()}  # ms
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:10]
    print(f"train: a profiled step: {n_dev} device launches, device busy {sum(busy.values()):.1f} ms "
          f"of {t_prof * 1e3:.1f} ms wall (the profiler's overhead in the wall); by kernel: "
          + "; ".join(f"{kernel_name(k)[:48]} x{len(names[k])} {ms:.1f} ms" for k, ms in top),
          flush=True)
    check("train (c): a profiled step launches none of the kernels' device functions",
          n_dev > 0 and not found and sum(read_counts().values()) == 0,
          f"{n_dev} device launches recorded, of the kernels' {found}")
    del opt_state, batches

    # (d): one full-width period, card vs CPU
    blk = model_lib._period(params["stages"][0]["blocks"][0], 0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn((TRAIN_PERIOD_B, TRAIN_PERIOD_S, cfg.d_model), generator=g, device=dev)
    x = x.bfloat16()
    ct = torch.randn((TRAIN_PERIOD_B, TRAIN_PERIOD_S, cfg.d_model), generator=g, device=dev)

    def period_grads(p_, x_, ct_):
        ps = [t.detach().clone().requires_grad_(True) for t in leaves(p_)]
        tree = torch.utils._pytree.tree_unflatten(ps, torch.utils._pytree.tree_structure(p_))
        x_ = x_.detach().clone().requires_grad_(True)
        pos = torch.arange(x_.shape[1], dtype=torch.int32, device=x_.device)
        y, _, _ = model_lib._block_apply("attn", tree, x_, cfg, pos, "train")
        return y.detach(), torch.autograd.grad(torch.sum(y.float() * ct_), [x_] + ps)

    t1 = time.perf_counter()
    y_c, g_c = period_grads(blk, x, ct)
    y_h, g_h = period_grads(model_lib.params_to(blk, "cpu"), x.cpu(), ct.cpu())
    names_d = ["x"] + ["/".join(str(k.key) for k in path)
                       for path, _ in torch.utils._pytree.tree_flatten_with_path(blk)[0]]

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.float().cpu() - b.float())
                     / torch.linalg.vector_norm(b.float()))

    rels = [rel(a, b) for a, b in zip(g_c, g_h)]
    rel_y = rel(y_c, y_h)
    worst = max(range(len(rels)), key=rels.__getitem__)
    check(f"train (d): one full-width period (B {TRAIN_PERIOD_B}, S {TRAIN_PERIOD_S}) card vs CPU: "
          f"output and every gradient ({time.perf_counter() - t1:.1f} s)",
          rel_y <= 2**-7 and max(rels) <= 2**-7,
          f"output norm-wise rel {rel_y:.3g}; {len(rels)} gradients, worst norm-wise rel "
          f"{rels[worst]:.3g} ({names_d[worst]}, {rels[worst] / 2**-7:.0%} of the tol 2^-7 = "
          f"{2**-7:.3g}); " + ", ".join(f"{n} {r:.2g}" for n, r in zip(names_d, rels)))
    faulty = list(g_c)
    k = names_d.index("attn/w_k")
    faulty[k] = torch.zeros_like(faulty[k])
    rels_f = [rel(a, b) for a, b in zip(faulty, g_h)]
    check("train (d) rejects a planted fault: the card's W_k gradient zeroed",
          max(rels_f) > 2**-7, f"worst norm-wise rel {max(rels_f):.3g}")
    del blk, g_c, g_h, y_c, y_h, faulty
    gc.collect()
    torch.cuda.empty_cache()


_DRYRUN = """
import json, os, time
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
out = {}
with dryrun.fake_world(256):
    for arch, shape in GATES:
        t = time.time()
        row = dryrun.run_cell(arch, shape, multi_pod=False, fit=(arch, shape) == MEASURE,
                              save=False)
        row["wall_s"] = time.time() - t
        out[arch + " " + shape] = row
os.environ["REPRO_MESH"] = "1x1"
with dryrun.fake_world(1):
    cfg = get_config("stablelm-1.6b")
    out["train_1x1"] = dryrun.gate_cell("stablelm-1.6b", "train_b8_s512", False, cfg=cfg,
                                        shape=ShapeSpec("train_b8_s512", S, B, "train"))
print("DRYRUN " + json.dumps(out))
"""


# the port's examples run on the card: (script, flags, closing line)
EXAMPLES = (("examples/torch_quickstart.py", [], "quickstart OK"),
            ("examples/torch_failover_elastic.py", [], "(bit-exact resume)"))


def examples_phase() -> None:
    """Phase 11: the port's examples on the card (their default device),
    each in a process of its own, the two at once (each is bound by its
    host), each ending in its closing line."""
    import os

    phase("examples on the card")
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, *flags], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=str(root))
             for script, flags, _ in EXAMPLES]
    try:
        outs = [proc.communicate(timeout=400) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (script, _, last), proc, (stdout, stderr) in zip(EXAMPLES, procs, outs):
        lines = stdout.strip().splitlines()
        print("\n".join(f"  | {ln}" for ln in lines), flush=True)
        check(f"{script} on the card", proc.returncode == 0 and bool(lines)
              and lines[-1].endswith(last), f"rc {proc.returncode}, both done in "
              f"{time.perf_counter() - t0:.1f} s; " + stderr[-1500:].replace("\n", " | "))


def start_dryrun() -> subprocess.Popen:
    """Phase 10 (d)'s dry run, started in a process of its own (the fake
    process group is process-global) on the host's CPU."""
    code = (f"GATES = {MD_GATES!r}\nMEASURE = {MD_MEASURE!r}\nB, S = {TRAIN_B}, {TRAIN_S}\n"
            + _DRYRUN)
    import os

    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


# the dry-run cells once marked † (a gather of the sequence-split KV cache
# at every layer), re-read since the split-KV decode: their peak GB a device
# on pod16x16 then (PERF.md), which none may exceed now
DAGGER_PEAKS = {
    ("stablelm-1.6b", "decode_32k"): 6.7, ("glm4-9b", "decode_32k"): 5.6,
    ("internlm2-20b", "decode_32k"): 9.1, ("qwen2.5-32b", "decode_32k"): 13.1,
    ("deepseek-v2-lite-16b", "decode_32k"): 3.8, ("zamba2-2.7b", "decode_32k"): 6.0,
    ("mixtral-8x7b", "decode_32k"): 6.9, ("phi-3-vision-4.2b", "decode_32k"): 11.8,
    ("musicgen-medium", "decode_32k"): 8.2,
    ("zamba2-2.7b", "long_500k"): 1.1, ("mixtral-8x7b", "long_500k"): 6.6,
}
DAGGER_DIR = "experiments/dryrun_torch/dagger"
# cells whose collective term on pod16x16 must fall under this many ms:
# stablelm-1.6b's decode (split-KV), phi-3-vision-4.2b's (its vocab-split
# head kept split: 2004 columns a device), and the peak GB phi-3's may not
# exceed (its reading with the head gathered)
DAGGER_COLL_MS = {("stablelm-1.6b", "decode_32k"): 5.0, ("phi-3-vision-4.2b", "decode_32k"): 0.1}
DAGGER_PEAK_CAP = {("phi-3-vision-4.2b", "decode_32k"): 7.5}
# xlstm-350m's cells that ran past 240 s before the counted sLSTM scan
XLSTM_CELLS = ("train_4k", "prefill_32k")
XLSTM_LIMIT_S = 240
XLSTM_DIR = "experiments/dryrun_torch/xlstm"


def start_dagger_sweep() -> subprocess.Popen:
    """The † cells through the dry run's CLI (one process per cell, three
    at a time, on the host's CPU), measured: started with phase 8, read in
    10 (d)."""
    import os

    root = Path(__file__).resolve().parent
    archs = sorted({a for a, _ in DAGGER_PEAKS})
    shapes = sorted({s_ for _, s_ in DAGGER_PEAKS})
    env = dict(os.environ, PYTHONPATH=str(root / "src"), CUDA_VISIBLE_DEVICES="",
               REPRO_DRYRUN_DIR=str(root / DAGGER_DIR))
    # a session of its own: the sweep and its per-cell processes are stopped
    # together at exit (``stop_group``), whatever ends the script
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                             ",".join(archs), "--shape", ",".join(shapes), "--jobs", "3",
                             "--limit", "500"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(root), start_new_session=True)
    import atexit

    atexit.register(stop_group, proc)
    return proc


def start_xlstm_sweep() -> subprocess.Popen:
    """xlstm-350m's train_4k and prefill_32k on pod16x16 through the dry
    run's CLI (both at once, ``XLSTM_LIMIT_S`` each, on the host's CPU):
    started with phase 9, read in 10 (d)."""
    import atexit
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), CUDA_VISIBLE_DEVICES="",
               REPRO_DRYRUN_DIR=str(root / XLSTM_DIR))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                             "xlstm-350m", "--shape", ",".join(XLSTM_CELLS), "--jobs", "2",
                             "--limit", str(XLSTM_LIMIT_S)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(root),
                            start_new_session=True)
    atexit.register(stop_group, proc)
    return proc


def read_xlstm_sweep(proc: subprocess.Popen) -> None:
    """Phase 10 (d), xlstm's cells: both finished within their limit, with
    a roofline row."""
    t0 = time.perf_counter()
    stdout, stderr = proc.communicate(timeout=XLSTM_LIMIT_S + 60)
    check("multi-device (d): xlstm-350m's train_4k and prefill_32k finished on pod16x16",
          proc.returncode == 0, f"rc {proc.returncode}; waited {time.perf_counter() - t0:.1f} s; "
          + (stdout[-1500:] + stderr[-1500:]).replace("\n", " | "))
    root = Path(__file__).resolve().parent / XLSTM_DIR
    for shape in XLSTM_CELLS:
        row = json.loads((root / f"xlstm-350m__{shape}__pod16x16.json").read_text())
        print(f"  xlstm {row['cell']}: counted in {row['run_s']} s; peak "
              f"{row['memory']['peak_gb_per_device']:.3f} GB a device, compute / memory / "
              f"collective {row['compute_ms']:.4g} / {row['memory_ms']:.4g} / "
              f"{row['collective_ms']:.4g} ms, dominant {row['dominant']}; collectives "
              f"{row['collective_counts']} (predictions on meta tensors)", flush=True)
        check(f"multi-device (d): xlstm-350m {shape} measured", row["gate"] == "ok"
              and row["hlo_gflops"] > 0 and row["run_s"] < XLSTM_LIMIT_S, row["cell"])


def stop_group(proc: subprocess.Popen) -> None:
    """Kill ``proc``'s process group if ``proc`` still runs."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def read_dagger_sweep(proc: subprocess.Popen) -> None:
    """Phase 10 (d), the † cells: every one measured, none bound by its
    collectives, none's peak above its reading with the gather, and stablelm-1.6b
    decode_32k's collective term under ``DAGGER_COLL_MS``."""
    t0 = time.perf_counter()
    stdout, stderr = proc.communicate(timeout=900)
    check("multi-device (d): the † cells' dry-run sweep finished", proc.returncode == 0,
          f"rc {proc.returncode}; waited {time.perf_counter() - t0:.1f} s; "
          + (stdout[-1500:] + stderr[-1500:]).replace("\n", " | "))
    root = Path(__file__).resolve().parent / DAGGER_DIR
    for (arch, shape), old in DAGGER_PEAKS.items():
        row = json.loads((root / f"{arch}__{shape}__pod16x16.json").read_text())
        peak = row["memory"]["peak_gb_per_device"]
        print(f"  † {row['cell']}: peak {peak:.3f} GB a device (with the gather: {old}), compute / "
              f"memory / collective {row['compute_ms']:.4g} / {row['memory_ms']:.4g} / "
              f"{row['collective_ms']:.4g} ms, dominant {row['dominant']}, roofline fraction "
              f"{row['roofline_fraction']:.3g}; collectives {row['collective_counts']}", flush=True)
        ok = row["dominant"] != "collective" and peak <= old + 0.05
        ok = ok and row["collective_ms"] < DAGGER_COLL_MS.get((arch, shape), math.inf)
        ok = ok and peak <= DAGGER_PEAK_CAP.get((arch, shape), math.inf)
        check(f"multi-device (d): † {arch} {shape} re-read", ok,
              f"dominant {row['dominant']}, peak {peak:.3f} GB, collective {row['collective_ms']:.4g} ms")


def multidevice_phase(dev, read_counts, zero_counts, dryrun_proc, dagger_proc=None,
                      xlstm_proc=None) -> None:
    """Phase 10: the port's multi-device path on one card (see the module
    docstring, item 10).  Every step runs in this process on the card; a
    failure fails the script."""
    import socket

    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import compression
    from repro_torch.serving.steps import make_decode_step, make_prefill_step
    from repro_torch.training import AdamWConfig, make_compressed_train_step, make_train_step
    from repro_torch.training import optimizer as opt_lib

    phase("multi-device: an NCCL group of one, a 1 x 1 mesh on the card")
    leaves = torch.utils._pytree.tree_leaves
    tree_map = torch.utils._pytree.tree_map
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        rules = sharding.set_mesh(mesh)
        print(f"mesh {mesh}; backend {dist.get_backend()}", flush=True)
        cfg = get_config("stablelm-1.6b")

        # (a) the batched steps, without and with the mesh
        gc.collect()
        torch.cuda.empty_cache()
        params = model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        rng = np.random.default_rng(SEED + 10)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (MD_B, MD_PROMPT))
                                  .astype(np.int32)).to(dev)
        prefill = make_prefill_step(cfg, MD_PROMPT + MD_DECODE)
        decode = make_decode_step(cfg)
        conf = prefill(params, {"tokens": tokens},
                       torch.full((len(cfg.exit_stages),), 2.0, device=dev))["exit_conf"]
        srt = torch.sort(conf.float(), dim=0).values  # exits taken by some rows, not all
        th = (srt[MD_B // 2 - 1] + srt[MD_B // 2]) / 2

        def run(p_, place):
            out = prefill(p_, place({"tokens": tokens}), th)
            trace = [(out["token"], out["exit_stage"], out["exit_conf"])]
            for _ in range(MD_DECODE):
                out = decode(p_, place({"tokens": out["token"][:, None]}), out["caches"], th)
                trace.append((out["token"], out["exit_stage"], out["exit_conf"]))
            torch.cuda.synchronize()
            return trace

        def full(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        zero_counts()
        t0 = time.perf_counter()
        plain = run(params, lambda b: b)
        t_plain = time.perf_counter() - t0
        n_plain = read_counts()
        sparams = sharding.distribute_tree(params, sharding.param_specs(params, rules.as_serving()),
                                           mesh)
        place = lambda b: sharding.distribute_tree(b, sharding.batch_specs(b), mesh)  # noqa: E731
        zero_counts()
        t0 = time.perf_counter()
        meshed = run(sparams, place)
        t_mesh = time.perf_counter() - t0
        n_mesh = read_counts()
        same_tok = all(torch.equal(full(a[0]), b[0]) and torch.equal(full(a[1]), b[1])
                       for a, b in zip(meshed, plain))
        conf_gap = max(float((full(a[2]) - b[2]).abs().max()) for a, b in zip(meshed, plain))
        exits = Counter(int(e) for _, st, _ in plain for e in st.tolist())
        print(f"(a) prefill B {MD_B} x {MD_PROMPT} + {MD_DECODE} decode steps: without a mesh "
              f"{t_plain:.2f} s, on the mesh {t_mesh:.2f} s (DTensor dispatch on the host); "
              f"launches {n_plain} / {n_mesh}; exit stages over the steps {dict(exits)}; "
              f"conf max|diff| {conf_gap:.3g}", flush=True)
        check("multi-device (a): the sharded steps' tokens and exit stages equal the unsharded "
              "steps' bit for bit", same_tok and type(meshed[-1][0]).__name__ == "DTensor",
              f"{len(plain)} steps of {MD_B} rows")
        used = ("flash_attention", "decode_attention", "exit_confidence")
        check("multi-device (a): the sharded steps launch flash, decode and the exit head, as "
              "often as without a mesh", all(n_mesh[k] > 0 for k in used) and n_mesh == n_plain,
              f"with the mesh {n_mesh}, without {n_plain}")
        del params, sparams, plain, meshed
        gc.collect()
        torch.cuda.empty_cache()

        # (b) one train step, without and with the mesh, from the same seed
        opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=TRAIN_STEPS)
        step_fn = make_train_step(cfg, opt_cfg)
        dcfg = DataConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=0)

        def masters():
            return model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                                         master=True)

        # a step's peak counts from what the card held before its arguments
        # were made (the earlier phases still hold some): the arguments and
        # the step's own temporaries, as the dry run predicts them
        base0 = torch.cuda.memory_allocated()
        p0 = masters()
        s0 = opt_lib.init_opt_state(p0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p0, s0, m0 = step_fn(p0, s0, next(token_stream(cfg, dcfg, device=dev)))
        loss0, gn0 = float(m0["loss"]), float(m0["grad_norm"])
        peak0 = torch.cuda.max_memory_allocated() - base0
        ref = tree_map(lambda t: t.cpu(), p0)
        ref_m = [t.cpu() for t in leaves(s0["m"])]
        del p0, s0, m0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        p1 = masters()
        pspecs = sharding.param_specs(p1)
        p1 = sharding.distribute_tree(p1, pspecs, mesh)
        s1 = opt_lib.init_opt_state(p1)
        s1 = sharding.distribute_tree(s1, sharding.param_specs(s1), mesh)
        batch = next(token_stream(cfg, dcfg, mesh=mesh))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p1, s1, m1 = step_fn(p1, s1, batch)
        loss1, gn1 = float(full(m1["loss"])), float(full(m1["grad_norm"]))
        t_step = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        gaps = [float((full(a).cpu() - b).abs().max()) for a, b in zip(leaves(p1), leaves(ref))]
        bitwise = max(gaps) == 0.0 and loss1 == loss0
        print(f"(b) train step B {TRAIN_B} x S {TRAIN_S} on the mesh: {t_step * 1e3:.1f} ms wall; "
              f"loss {loss1!r} (without a mesh {loss0!r}), grad norm {gn1!r} ({gn0!r}); updated "
              f"masters max|diff| {max(gaps):.3g}; bit for bit: {bitwise}; peak device memory of the "
              f"step (arguments included) {peak / 1e9:.3f} GB ({peak / 2**30:.2f} GiB; the step "
              f"without a mesh {peak0 / 1e9:.3f} GB) above the {base / 1e9:.3f} GB the earlier "
              f"phases hold", flush=True)
        lr1 = float(opt_lib.lr_schedule(torch.tensor(1.0), opt_cfg))
        del p1, s1, m1, batch
        gc.collect()
        torch.cuda.empty_cache()
        # the planted fault: a step that skipped its update leaves the
        # initial masters, which the tolerance must refuse
        skipped = max(float((a.cpu() - b).abs().max()) for a, b in zip(leaves(masters()),
                                                                        leaves(ref)))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"    a step that skipped its update would sit {skipped:.3g} from the step without "
              f"a mesh (lr at step 1 {lr1:.3g}); the tolerance is {MD_MASTER_ATOL:g}", flush=True)
        check("multi-device (b): the sharded train step's loss and grad norm equal the step "
              f"without a mesh, its updated masters at atol {MD_MASTER_ATOL:g}",
              loss1 == loss0 and gn1 == gn0 and max(gaps) <= MD_MASTER_ATOL,
              f"loss gap {abs(loss1 - loss0):.3g}, grad norm gap {abs(gn1 - gn0):.3g}, masters "
              f"max|diff| {max(gaps):.3g}")
        check("multi-device (b) rejects a planted fault: the update skipped",
              skipped > MD_MASTER_ATOL, f"{skipped:.3g}")

        # (c) the compressed step on a (1, 1, 1) mesh with a pod axis
        from torch.distributed.device_mesh import init_device_mesh

        pod_mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        sharding.set_mesh(pod_mesh)
        p2 = masters()
        pspecs2 = sharding.param_specs(p2)
        p2 = sharding.distribute_tree(p2, pspecs2, pod_mesh)
        s2 = opt_lib.init_opt_state(p2)
        s2["error"] = compression.init_error(p2)
        s2 = sharding.distribute_tree(s2, sharding.param_specs(s2), pod_mesh)
        t0 = time.perf_counter()
        p2, s2, m2 = make_compressed_train_step(cfg, pod_mesh, opt_cfg)(
            p2, s2, next(token_stream(cfg, dcfg, mesh=pod_mesh)))
        loss2 = float(full(m2["loss"]))
        t_comp = time.perf_counter() - t0
        gn2 = float(full(m2["grad_norm"]))
        err_max = max(float(full(e).abs().max()) for e in leaves(s2["error"]))
        # by hand: AdamW's step 1 from the initial masters and the step's own
        # moments (bias-corrected, weight decay on matrices); a skipped or
        # sign-flipped update parts from it by ~lr
        b1, b2 = opt_cfg.beta1, opt_cfg.beta2
        upd_gap = 0.0
        with torch.no_grad():
            for a, b, m, v in zip(leaves(masters()), leaves(p2), leaves(s2["m"]),
                                  leaves(s2["v"])):
                delta = (full(m) / (1 - b1)) / (torch.sqrt(full(v) / (1 - b2)) + opt_cfg.eps)
                if opt_cfg.weight_decay > 0 and a.ndim >= 2:
                    delta = delta + opt_cfg.weight_decay * a
                upd_gap = max(upd_gap, float((full(b) - (a - lr1 * delta)).abs().max()))
                del a, delta
        gc.collect()
        torch.cuda.empty_cache()

        # the gradient the moments carry: at one pod, from zero error,
        # g = m / ((1 - b1) c) + e (c the clip scale of the dequantized
        # gradients' norm), against the uncompressed step's m / ((1 - b1) c)
        def clip(gn):
            return min(1.0, opt_cfg.grad_clip_norm / max(gn, 1e-9))

        g_gap = 0.0
        for m, e, m0_ in zip(leaves(s2["m"]), leaves(s2["error"]), ref_m):
            g = full(m).double() / ((1 - b1) * clip(gn2)) + full(e).double()
            g0 = m0_.to(dev).double() / ((1 - b1) * clip(gn0))
            den = float(g0.norm())
            g_gap = max(g_gap, float((g - g0).norm()) / den if den > 0 else float(g.abs().max()))
            del g, g0
        print(f"(c) compressed step on {pod_mesh}: {t_comp * 1e3:.1f} ms wall; loss {loss2!r}; "
              f"masters max|diff| from AdamW's step by hand {upd_gap:.3g} (lr at step 1 "
              f"{lr1:.3g}); gradient carried + residual against the uncompressed step's, worst "
              f"leaf norm-wise {g_gap:.3g}; largest error residual {err_max:.3g}", flush=True)
        check("multi-device (c): the compressed step's loss is finite, its masters are AdamW's "
              f"step from its own moments (atol {MD_MASTER_ATOL:g}) and its moments carry the "
              f"uncompressed gradient less the int8 residual (norm-wise {MD_GRAD_RTOL:.3g})",
              math.isfinite(loss2) and upd_gap <= MD_MASTER_ATOL and g_gap <= MD_GRAD_RTOL
              and err_max > 0, f"loss {loss2:.6g}, update gap {upd_gap:.3g}, gradient gap "
              f"{g_gap:.3g}")
        del p2, s2, m2, ref, ref_m
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()

    # (d) the dry run's gates, measured cell and the 1 x 1 prediction
    phase("multi-device (d): the dry run (meta tensors, a fake group of 256 ranks)")
    t0 = time.perf_counter()
    stdout, stderr = dryrun_proc.communicate(timeout=600)
    line = next((ln for ln in stdout.splitlines() if ln.startswith("DRYRUN ")), None)
    check("multi-device (d): the dry-run subprocess finished", dryrun_proc.returncode == 0
          and line is not None, f"rc {dryrun_proc.returncode}; waited "
          f"{time.perf_counter() - t0:.1f} s; " + stderr[-3000:].replace("\n", " | "))
    rows = json.loads(line[len("DRYRUN "):])
    for arch, shape in MD_GATES:
        row = rows[f"{arch} {shape}"]
        mem = row["memory"]
        print(f"  {row['cell']}: gate {row['gate']} in {row['wall_s']:.1f} s; per device "
              f"arguments {mem['argument_size_gb']:.3f} GB, peak {mem['peak_gb_per_device']:.3f} GB "
              f"(predicted on meta tensors); collectives {row['gate_collective_counts']}",
              flush=True)
        check(f"multi-device (d): {arch} {shape} gated on pod16x16", row["gate"] == "ok"
              and sum(row["gate_collective_counts"].values()) > 0, row["cell"])
    arch, shape = MD_MEASURE
    row = rows[f"{arch} {shape}"]
    keys = ("hlo_gflops", "hlo_gbytes", "coll_gbytes_global", "compute_ms", "memory_ms",
            "collective_ms", "dominant", "model_gflops", "useful_ratio", "roofline_fraction")
    print("  roofline row (predicted, H100 peaks): " + json.dumps({k: row[k] for k in keys}),
          flush=True)
    check("multi-device (d): the measured cell's roofline row", all(k in row for k in keys)
          and row["hlo_gflops"] > 0, row["cell"])
    pred = rows["train_1x1"]["memory"]["peak_gb_per_device"] * 1e9
    gap = abs(peak - pred) / pred
    print(f"  (b)'s cell on a 1 x 1 mesh: predicted peak {pred / 1e9:.3f} GB, measured "
          f"{peak / 1e9:.3f} GB on {nvidia_smi()}: {gap:.1%} apart", flush=True)
    check("multi-device (b): the train step's peak memory within 15% of the dry run's prediction",
          gap <= MD_PEAK_TOL, f"{gap:.1%}")
    if dagger_proc is not None:
        read_dagger_sweep(dagger_proc)
    if xlstm_proc is not None:
        read_xlstm_sweep(xlstm_proc)


if __name__ == "__main__":
    main()
