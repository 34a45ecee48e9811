"""The benchmark's traffic generator: one general generator that every mix
file (``perfbench/traffic/<mix>.json``) parameterises.

The length law is a frozen copy of ``repro_torch.data.pipeline.
poisson_requests``' (``max(2, int(lognormal(log(median), sigma)))``), with a
clip to the mix's ``min`` and ``max``; it lives here so that a change to the
program cannot move the yardstick.

What the run's ``--seed`` changes and what it does not:

* the prompt lengths of slot ``j``, in their order, are drawn from the
  mix's fixed ``length_seed`` (and ``j``), so every seed serves the same
  sizes in the same order: the engine's simulated schedule, and so which
  rows share a batch, follows the lengths' order, and a window's work does
  not change with the seed;
* the seed draws every token id, uniform over the vocabulary.

Arrivals are the engine's own: ``serve`` draws them on its simulated clock
at the mix's ``arrival_rate``.
"""
from __future__ import annotations

import numpy as np


def poisson_lengths(rng: np.random.Generator, n: int, median: float, sigma: float) -> np.ndarray:
    """``n`` prompt lengths by ``poisson_requests``' law, unclipped (the copy)."""
    return np.array([max(2, int(rng.lognormal(np.log(median), sigma))) for _ in range(n)],
                    np.int64)


def slot_lengths(mix: dict, slot: int) -> np.ndarray:
    """The prompt lengths of slot ``slot``, clipped, in draw order; the same
    for every run seed."""
    p = mix["prompt"]
    rng = np.random.default_rng((int(mix["length_seed"]), slot))
    raw = poisson_lengths(rng, int(mix["slot_requests"]), p["median"], p["sigma"])
    return np.clip(raw, int(p["min"]), int(p["max"]))


def slot_prompts(mix: dict, vocab: int, seed: int, slot: int) -> list[np.ndarray]:
    """Slot ``slot``'s prompts for run seed ``seed``: its lengths, and token
    ids drawn from the seed."""
    rng = np.random.default_rng((int(seed), slot))
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in slot_lengths(mix, slot)]


def warmup_prompts(mix: dict, vocab: int, warm_gen: int) -> list[np.ndarray]:
    """Prompts for the set-up's short serve: one long enough that, served
    with ``warm_gen`` tokens, it sizes the slot stores as the window's
    longest prompt does with the mix's ``gen_len`` (the same allocations),
    and ``batch_size`` prompts of the mix's shortest length (every padded
    decode batch size up to ``batch_size``)."""
    p = mix["prompt"]
    rng = np.random.default_rng(0)
    longest = int(p["max"]) + int(mix["gen_len"]) - warm_gen
    lengths = [longest] + [int(p["min"])] * int(mix["batch_size"])
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]
