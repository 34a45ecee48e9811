"""The port's serve of reduced mixtral-8x7b (an MoE of 8 experts top-2 with
no shared experts, GQA 4:4 at reduced width, a sliding window of 32)
against the JAX engine, and the engine's refusals.

The checks and the set-up are ``torch_ssm_serving``'s (vocab 128, prompts
of 12 and 8 tokens, 4 tokens each, threshold 0.1): ``max_len`` 16 lies
within the window, so the slot caches are full caches, as the reference's
engine keeps them.  Recorded on these prompts: the port equals the JAX
engine run op by op in cached, paged (block 4) and stateless decode; the
jitted JAX engine leaves its op-by-op run on request 0, at a head decision
within the two runs' measured difference of a tie; stateless decode parts
from cached decode on requests 0-2 in both packages (an expert's capacity
counts the padded rows of its call, ROADMAP Queue 3).
"""
import numpy as np
import pytest

import torch_ssm_serving as checks


@pytest.fixture(scope="module")
def case():
    return checks.build("mixtral-8x7b")


def test_cached_serve_matches_jax_engine(case):
    checks.check_cached_matches_jax(case)


def test_paged_serve_matches_jax_engine(case):
    checks.check_cached_matches_jax(case, "paged")


def test_stateless_serve_matches_jax_engine(case):
    checks.check_stateless_matches_jax(case, near_ties=set())


def test_port_equals_jitted_engine_where_it_keeps_its_op_by_op_tokens(case):
    checks.check_jitted_engine(case, jit_moves={0})


def test_cached_equals_paged_and_stateless_parts_as_in_the_reference(case):
    assert case["port", "paged"].sequences_by_rid() == case["port", "cached"].sequences_by_rid()
    assert max(len(toks) for _, toks in case["port", "cached"].sequences_by_rid().values()) > 1
    checks.check_stateless_against_cached(case, moved={0, 1, 2})


def test_engine_refuses_a_window_shorter_than_max_len(case):
    """A 30-token prompt and 4 tokens make ``max_len`` 34 past the window of
    32: the cached and paged serves refuse it before any work (per-slot
    rings are not in the reference's engine either)."""
    long = [np.arange(30, dtype=np.int32) % 128]
    for kw in ({"decode_mode": "cached"}, checks.PAGED):
        with pytest.raises(ValueError, match="sliding_window=32 < max_len=34"):
            checks.serve(case["teng"], long, **kw)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "musicgen-medium"])
def test_engine_refuses_an_embeds_config(arch):
    """The staged engine embeds tokens.  With ``gen_len > 1`` it raises the
    reference's ValueError; with ``gen_len == 1`` the reference fails later,
    with ``KeyError: 'embeds'`` in its embed step, and the port raises a
    ValueError up front instead (ROADMAP Queue 3)."""
    from repro_torch.core.profiles import profile_from_arch
    from repro_torch.core.thresholds import synthetic_validation
    from repro_torch.core.topology import NetworkSpec, build_edge_network
    from repro_torch.core.types import DtoHyperParams
    from repro_torch.serving import CollaborativeEngine

    from torch_port_common import bridged_params

    _, tparams, _, tcfg = bridged_params(0, arch)
    profile = profile_from_arch(tcfg)
    teng = CollaborativeEngine(
        tparams, tcfg, build_edge_network(seed=0, profile=profile,
                                          spec=NetworkSpec(num_eds=4, es_per_stage=(2, 2))),
        profile, synthetic_validation(seed=1, profile=profile), DtoHyperParams(rounds=5), seed=0,
        device="cpu",
    )
    prompts = [np.arange(8, dtype=np.int32)]
    with pytest.raises(ValueError, match="autoregressive decode needs a token frontend"):
        teng.serve(prompts, gen_len=4)
    for kw in ({"decode_mode": "stateless"}, {"decode_mode": "cached"}, checks.PAGED):
        with pytest.raises(ValueError, match="the staged engine embeds tokens"):
            teng.serve(prompts, gen_len=1, **kw)
