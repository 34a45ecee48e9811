"""The port's serve of reduced xlstm-350m (mLSTM and sLSTM blocks, no
attention: only the exit head's kernel would run on the card) against the
JAX engine: the checks and the tolerances are in ``torch_ssm_serving``.

Recorded on these prompts: the jitted JAX engine leaves its op-by-op run
on request 0 (the port equals the op-by-op run on all four, in cached and
stateless decode); its first departing head call is a token whose two top
logits lie 0.0069 apart, within that call's jitted-vs-op-by-op logit
difference (0.11).  Stateless decode differs from cached decode in both
packages: a stateless pass re-runs the mLSTM over the padded prefix, whose
chunk ``_pick_chunk`` chooses by its length, and the reference's chunked
mLSTM reads its memory transposed, so its result depends on the chunk
(ROADMAP queue 3; ``test_torch_ssm.py`` measures the gap).
"""
import pytest

import torch_ssm_serving as checks


@pytest.fixture(scope="module")
def case():
    return checks.build("xlstm-350m")


def test_cached_serve_matches_jax_engine(case):
    checks.check_cached_matches_jax(case)


def test_paged_serve_matches_jax_engine(case):
    checks.check_cached_matches_jax(case, "paged")


def test_stateless_serve_matches_jax_engine(case):
    checks.check_stateless_matches_jax(case, near_ties=set())


def test_port_equals_jitted_engine_where_it_keeps_its_op_by_op_tokens(case):
    checks.check_jitted_engine(case, jit_moves={0})


def test_cached_equals_paged_and_monolithic(case):
    checks.check_cached_paged_monolithic(case)


def test_stateless_against_cached(case):
    checks.check_stateless_against_cached(case, moved={0, 1, 2, 3})


def test_short_prompt_refused_for_cached_decode(case):
    checks.check_short_prompt(case)
