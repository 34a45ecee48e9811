"""The port's deepseek-v2-lite-16b serve (MLA attention, MoE FFN; reduced)
against the JAX engine and against itself.

The port's serve is held to the JAX engine run op by op (tokens, exits,
simulated delays) and to the jitted JAX engine on prompts where that engine
agrees with its own op-by-op run; where it does not, the test records why
(a router near-tie that the jitted engine's rounding flips).  The
port's paged serve is held to its dense one (the port's analogue of
``tests/test_paged_serving.py``'s MLA case).  Cached == stateless ==
monolithic is not asserted for MoE in either package: an expert's capacity
depends on the tokens of the call, so a request's tokens may depend on what
it is batched with.
"""
import numpy as np
import pytest

import jax

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import exit_confidence as texit
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_decode_attention as tpaged

from torch_port_common import engine_pair

ARCH = "deepseek-v2-lite-16b"
GEN = 6
THRESHOLD = 0.1


@pytest.fixture(scope="module")
def router_log():
    """The JAX engine's router calls, recorded through a host callback (so
    under jit as well as op by op) as (f32 logits [T, E], top-k indices
    [T, k]) into ``log["sink"]`` while it is a list.  Installed before the
    engines trace anything, so every program of theirs records."""
    import repro.models.moe as jmoe

    real = jmoe.router_probs
    log = {"sink": None}

    def recording(logits, dims):
        out = real(logits, dims)

        def keep(lg, idx):
            if log["sink"] is not None:
                log["sink"].append((np.asarray(lg), np.asarray(idx)))

        jax.debug.callback(keep, logits, out[1], ordered=True)
        return out

    jmoe.router_probs = recording
    yield log
    jmoe.router_probs = real


@pytest.fixture(scope="module")
def engines(router_log):
    return engine_pair(THRESHOLD, ARCH)


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=n).astype(np.int32) for n in (12, 8, 12, 8, 12, 8, 12, 8)]


@pytest.fixture(scope="module")
def prompts():
    return _prompts(2)


def _serve(engine, prompts, seed=7, **kw):
    engine.rng = np.random.default_rng(seed)
    kw.setdefault("arrival_rate", 1e5)
    kw.setdefault("batch_size", 4)
    return engine.serve(prompts, gen_len=GEN, **kw)


def _recorded_serve(engines, prompts, router_log, **kw):
    """The JAX engine's cached serve and its router calls."""
    router_log["sink"] = calls = []
    try:
        stats = _serve(engines[0], prompts, decode_mode="cached", **kw)
    finally:
        router_log["sink"] = None
    return stats, calls


@pytest.fixture(scope="module")
def op_by_op(engines, prompts, router_log):
    """The JAX engine's serve of ``prompts`` under ``jax.disable_jit``, whose
    ops round as the port's do, and its router calls."""
    with jax.disable_jit():
        return _recorded_serve(engines, prompts, router_log)


def test_serve_matches_jax_engine_op_by_op(engines, prompts, op_by_op):
    """Tokens, exits and simulated delays equal the JAX engine's, run op by
    op."""
    jeng, teng = engines
    np.testing.assert_array_equal(teng.p, jeng.p)
    want = op_by_op[0]
    got = _serve(teng, prompts, decode_mode="cached")
    assert got.sequences_by_rid() == want.sequences_by_rid()
    np.testing.assert_allclose(np.asarray(got.delays)[np.argsort(got.rids)],
                               np.asarray(want.delays)[np.argsort(want.rids)], rtol=1e-9)
    assert len(set(got.exit_stage)) > 1  # early and late exits both taken


@pytest.mark.parametrize("prompt_seed", [3, 5])
def test_serve_matches_jitted_jax_engine(engines, prompt_seed):
    """On prompts where no router choice sits within the jitted engine's
    rounding of a tie, the port's tokens, exits and delays equal the jitted
    JAX engine's."""
    jeng, teng = engines
    ps = _prompts(prompt_seed)
    want = _serve(jeng, ps, decode_mode="cached")
    got = _serve(teng, ps, decode_mode="cached")
    assert got.sequences_by_rid() == want.sequences_by_rid()
    np.testing.assert_allclose(np.asarray(got.delays)[np.argsort(got.rids)],
                               np.asarray(want.delays)[np.argsort(want.rids)], rtol=1e-9)
    assert len(set(got.exit_stage)) > 1


def test_jitted_jax_engine_departs_only_through_a_router_near_tie(engines, prompts, op_by_op,
                                                                  router_log):
    """On the seed-2 prompts the jitted JAX engine differs from its own
    op-by-op run in requests 2 and 5, and in no other; the port equals both
    JAX runs on the other six.  The cause is recorded: the router calls of
    the two JAX runs agree up to the first call whose top-k sets differ, and
    there every flipped token's k-th and (k+1)-th op-by-op logits lie closer
    than the largest jitted-vs-op-by-op logit difference of that call (the
    jitted engine's fusions round the router's inputs otherwise than the
    op-by-op run does)."""
    _, teng = engines
    op_stats, op_calls = op_by_op
    jit_stats, jit_calls = _recorded_serve(engines, prompts, router_log)
    op, jit = op_stats.sequences_by_rid(), jit_stats.sequences_by_rid()
    port = _serve(teng, prompts, decode_mode="cached").sequences_by_rid()
    assert sorted(r for r in op if jit[r] != op[r]) == [2, 5]
    assert all(port[r] == jit[r] for r in op if r not in (2, 5))

    first = next(n for n, ((_, ij), (_, io)) in enumerate(zip(jit_calls, op_calls))
                 if ij.shape != io.shape or (np.sort(ij, -1) != np.sort(io, -1)).any())
    (lj, ij), (lo, io) = jit_calls[first], op_calls[first]
    assert lj.shape == lo.shape  # the calls before agree, so this one has the same tokens
    flipped = np.nonzero((np.sort(ij, -1) != np.sort(io, -1)).any(-1))[0]
    k = io.shape[-1]
    ranked = -np.sort(-lo[flipped], axis=-1)
    margins = ranked[:, k - 1] - ranked[:, k]
    assert len(flipped) and np.all(margins < np.abs(lj - lo).max())


@pytest.mark.parametrize("kw", [{"block_size": 3}, {"block_size": 3, "prefix_sharing": False},
                                {"block_size": 16}],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_paged_serve_equals_dense(engines, prompts, kw):
    """Absorbed-latent MLA decode through block tables == dense slot rows
    (the batches are the same, so the experts' capacities are too), every
    pool drained, no kernel launched on the CPU."""
    _, teng = engines
    counts = lambda: (texit.exit_confidence.launches, tdec.decode_attention.launches,  # noqa: E731
                      tpaged.paged_decode_attention.launches, tflash.flash_attention.launches)
    n0 = counts()
    dense = _serve(teng, prompts, decode_mode="cached")
    paged = _serve(teng, prompts, cache_layout="paged", **kw)
    assert paged.sequences_by_rid() == dense.sequences_by_rid()
    assert len(paged.delays) == len(prompts)
    assert paged.allocators and all(
        not a.live_handles() and not any(a.refcounts()) for a in paged.allocators.values())
    assert counts() == n0


def test_launch_serve_deepseek_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--arch", ARCH, "--slots", "1", "--requests-per-slot", "4",
          "--gen-len", "2", "--batch-size", "2"])
    out = capsys.readouterr().out
    assert out.count("slot 0:") == 1 and out.rstrip().endswith("done")
