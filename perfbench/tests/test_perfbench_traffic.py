"""The traffic generator: a seed repeats exactly, every seed serves the same
sizes, and the mix's clips hold."""
from __future__ import annotations

import numpy as np
import pytest
from perfbench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)

from perfbench.harness import bench, traffic

MIXES = ("generate", "single_shot")


def _mix(name):
    return bench.load_json(bench.PERFBENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_repeats_exactly(name):
    mix = _mix(name)
    a = traffic.slot_prompts(mix, 1000, 2**31 + 11, 3)
    b = traffic.slot_prompts(mix, 1000, 2**31 + 11, 3)
    assert len(a) == mix["slot_requests"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_sizes_and_other_tokens(name):
    mix = _mix(name)
    a, b = (traffic.slot_prompts(mix, 1000, s, 0) for s in (1, 2))
    assert [len(p) for p in a] == [len(p) for p in b]
    assert not any(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(map(len, a)) != sorted(len(p) for p in traffic.slot_prompts(mix, 1000, 1, 1))


@pytest.mark.parametrize("name", MIXES)
def test_clips_hold_and_tokens_lie_in_the_vocabulary(name):
    mix = _mix(name)
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    lengths = np.concatenate([traffic.slot_lengths(mix, s) for s in range(20)])
    assert lengths.min() >= lo and lengths.max() <= hi
    # the clip bites at the top somewhere in 20 slots, and leaves the median
    assert (lengths == hi).any()
    assert abs(np.median(lengths) / mix["prompt"]["median"] - 1) < 0.15
    toks = np.concatenate(traffic.slot_prompts(mix, 777, 5, 0))
    assert toks.min() >= 0 and toks.max() < 777


def test_the_length_law_is_the_programs():
    """The frozen copy draws as ``repro_torch.data.pipeline.poisson_requests``
    does, given the same generator state."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import RequestConfig, poisson_requests

    cfg = get_config("stablelm-1.6b").reduced()
    rc = RequestConfig(arrival_rate=5.0, mean_prompt_len=384, sigma=0.6, seed=9)
    theirs = [len(p) for _, p in poisson_requests(cfg, rc, 4.0)]
    rng = np.random.default_rng(9)
    ours = []
    t = rng.exponential(1 / 5.0)
    while t < 4.0:
        ours.append(int(traffic.poisson_lengths(rng, 1, 384, 0.6)[0]))
        rng.integers(0, cfg.vocab_size, size=ours[-1])
        t += rng.exponential(1 / 5.0)
    assert ours == theirs
