"""The exit-head kernel's split on the CPU: the vocab ranges of its
persistent CTAs and the batch passes (``exit_confidence.vocab_ranges`` and
``batch_passes``), and
the plain version run over that split (``ref.exit_confidence_split_ref``:
one (max, sum-exp, first argmax) partial per range, combined in range
order) against the JAX package's oracle and its Pallas kernel in interpret
mode.  Tolerances as ``tests/test_kernels.py``: conf atol 1e-3 with an exact
argmax, on inputs with a clear top-1 margin.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.exit_confidence import exit_confidence as pallas_exit
from repro_torch.kernels import exit_confidence as texit
from repro_torch.kernels import ref

import torch_port_common  # noqa: F401  (one CPU thread for the port's ops)

# the registry's LM-head vocabs, small and ragged ones, and fewer columns
# than a unit per CTA
VOCABS = [100352, 102400, 151552, 92544, 152064, 2056, 1000, 136, 120, 8, 513, 127]
# an H100 SXM's and an H100 PCIe's SM counts, and small grids
CTAS = [132, 114, 7, 1]


@pytest.mark.parametrize("n_ctas", CTAS)
@pytest.mark.parametrize("V", VOCABS)
def test_vocab_ranges_cover_the_vocab_once_in_order(V, n_ctas):
    ranges = texit.vocab_ranges(V, n_ctas)
    assert len(ranges) == n_ctas
    assert ranges[0][0] == 0 and ranges[-1][1] == V
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2  # contiguous, ascending: every column in exactly one range
    unit = texit.UNIT
    for lo, hi in ranges:
        assert lo <= hi
        assert lo % unit == 0 and (hi % unit == 0 or hi == V)  # edges on units
    widths = [-(-(hi - lo) // unit) for lo, hi in ranges]  # in units
    assert max(widths) - min(widths) <= 1  # balanced within one unit
    units = -(-V // unit)
    assert (min(widths) == 0) == (units < n_ctas)  # empty ranges only when V < unit x CTAs


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("n_sm", [132, 114])
def test_grid_keeps_the_slowest_cta_and_idles_fewer(V, n_sm):
    """At most one CTA per SM and at least 90% of them; no CTA gets more
    units than on a full grid, and no smaller count in that span does so."""
    n = texit.grid_ctas(V, n_sm)
    floor = -(-9 * n_sm // 10)
    assert floor <= n <= n_sm
    units = -(-V // texit.UNIT)
    q = -(-units // n_sm)
    assert -(-units // n) == q
    assert n == floor or -(-units // (n - 1)) > q
    widths = [hi - lo for lo, hi in texit.vocab_ranges(V, n)]
    assert max(widths) <= q * texit.UNIT


def test_grid_at_the_registry_heads():
    """132 SMs: deepseek-v2-lite-16b's 1600 units go to 124 CTAs of at most
    13 (12 slots idle at the end, against 116 on 132 CTAs); qwen2.5-32b's
    2376 fill 132 exactly; glm4-9b and internlm2-20b keep 132.  The heads
    served since: mixtral-8x7b's 500 units on 125 CTAs of 4, phi-3-vision's
    501 on 126 (at most 4 each), and musicgen-medium's 32 units on the
    floor of 119 CTAs (87 of them with an empty range)."""
    assert [texit.grid_ctas(V, 132) for V in (102400, 152064, 151552, 92544, 100352)] == [
        124, 132, 132, 132, 131]
    assert [texit.grid_ctas(V, 132) for V in (32000, 32064, 2048)] == [125, 126, 119]
    assert sum(hi > lo for lo, hi in texit.vocab_ranges(2048, 119)) == 32


@pytest.mark.parametrize("B", [1, 8, 32, 63, 64, 65, 128, 129, 200])
def test_batch_passes_cover_the_batch_in_order(B):
    passes = texit.batch_passes(B)
    assert passes[0][0] == 0 and passes[-1][1] == B
    assert all(r1 == r0b for (_, r1), (r0b, _) in zip(passes, passes[1:]))
    assert all(0 < r1 - r0 <= texit.MAX_ROWS for r0, r1 in passes)
    assert len(passes) == -(-B // texit.MAX_ROWS)  # one pass over w for every B <= 64


EXIT_CASES = [(4, 64, 1000), (8, 128, 2048), (3, 32, 513), (1, 16, 257), (5, 16, 130),
              (7, 32, 64), (6, 16, 127)]


def _margin_inputs(rng, B, d, V):
    """h, w (bf16 values) whose exact top-1 logit beats the runner-up by a
    clear margin."""
    h = rng.standard_normal((B, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    targets = rng.choice(V, size=B, replace=False) if B <= V else rng.integers(0, V, B)
    for b, t in enumerate(targets):
        w[:, t] += 6.0 * h[b] / np.linalg.norm(h[b])
    h = np.array(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
    w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    top2 = np.sort(h.astype(np.float64) @ w.astype(np.float64), axis=1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 0.05), "inputs lack a clear top-1 margin"
    return h, w


@functools.lru_cache(maxsize=None)
def _case(B, d, V):
    """The inputs of a case and the JAX oracle's and Pallas body's answers."""
    h, w = _margin_inputs(np.random.default_rng(11), B, d, V)
    jh, jw = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    oracle = tuple(np.asarray(x) for x in jref.exit_confidence_ref(jh, jw))
    pallas = tuple(np.asarray(x) for x in pallas_exit(jh, jw, block_b=8, block_v=128,
                                                     interpret=True))
    return h, w, oracle, pallas


@pytest.mark.parametrize("n_ctas", [132, 7])
@pytest.mark.parametrize("B,d,V", EXIT_CASES)
def test_split_matches_jax_and_pallas(B, d, V, n_ctas):
    h, w, (c_o, i_o), (c_p, i_p) = _case(B, d, V)
    th = torch.from_numpy(h).bfloat16()
    tw = torch.from_numpy(w).bfloat16()
    conf, idx = ref.exit_confidence_split_ref(th, tw, texit.vocab_ranges(V, n_ctas))
    assert conf.dtype == torch.float32 and idx.dtype == torch.int32
    for c_want, i_want in ((c_o, i_o), (c_p, i_p)):
        np.testing.assert_allclose(conf.numpy(), c_want, atol=1e-3)
        np.testing.assert_array_equal(idx.numpy(), i_want)
    c_r, i_r = ref.exit_confidence_ref(th, tw)
    np.testing.assert_allclose(conf.numpy(), c_r.numpy(), atol=1e-3)
    np.testing.assert_array_equal(idx.numpy(), i_r.numpy())


@pytest.mark.parametrize("V,n_ctas", [(2048, 7), (120, 132), (136, 132), (100352, 132)])
def test_split_tie_across_ranges_takes_the_first_index(V, n_ctas):
    """Three equal top logits: the last column of one CTA's range, the first
    of the next, and one further on; every version picks the first."""
    ranges = [(lo, hi) for lo, hi in texit.vocab_ranges(V, n_ctas) if hi > lo]
    a, b = ranges[0][1] - 1, ranges[1][0]
    assert b == a + 1
    rng = np.random.default_rng(12)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal((32, V)).astype(np.float32) * 0.1
    col = 4.0 * h.sum(axis=0) / np.linalg.norm(h.sum(axis=0))
    for c in (a, b, ranges[-1][0]):
        w[:, c] = col
    jh, jw = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, i_o = jref.exit_confidence_ref(jh, jw)
    _, i_p = pallas_exit(jh, jw, block_b=8, block_v=128, interpret=True)
    _, idx = ref.exit_confidence_split_ref(torch.from_numpy(h).bfloat16(),
                                           torch.from_numpy(w).bfloat16(),
                                           texit.vocab_ranges(V, n_ctas))
    assert np.all(np.asarray(i_o) == a) and np.all(np.asarray(i_p) == a)
    assert torch.all(idx == a)


@pytest.mark.parametrize("V", [120, 136])
@pytest.mark.parametrize("B", [1, 5])
def test_split_with_fewer_columns_than_ctas(B, V):
    """V < 64 x 132: most ranges empty, each empty partial changing nothing."""
    ranges = texit.vocab_ranges(V, 132)
    assert sum(hi == lo for lo, hi in ranges) == 132 - -(-V // texit.UNIT)
    h, w = _margin_inputs(np.random.default_rng(13), B, 16, V)
    th, tw = torch.from_numpy(h).bfloat16(), torch.from_numpy(w).bfloat16()
    conf, idx = ref.exit_confidence_split_ref(th, tw, ranges)
    c_o, i_o = jref.exit_confidence_ref(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(conf.numpy(), np.asarray(c_o), atol=1e-3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_o))
