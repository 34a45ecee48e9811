"""The port's serve of reduced zamba2-2.7b (Mamba2 blocks and a dense
attention block per period) against the JAX engine: the checks and the
tolerances are in ``torch_ssm_serving``.

Recorded on these prompts: the jitted JAX engine leaves its op-by-op run
on requests 0-2 (the port equals the op-by-op run on all four); its first
departing head call is a token whose two top logits lie 0.019 apart, within
that call's jitted-vs-op-by-op logit difference (0.11), and the batches
differ from there on.  The port's stateless serve equals the op-by-op one
but for request 1, whose exit confidence at its third token lies 3.8e-4
from the 0.1 threshold, within that call's port-vs-JAX confidence
difference (2.5e-3).  Stateless decode moves requests 0 and 2 away from
cached decode in both packages (the padded prefix through the chunked SSD
scan against the stepped recurrence; ``test_torch_ssm.py`` holds the two
routes to each other norm-wise at 2^-7).
"""
import pytest

import torch_ssm_serving as checks


@pytest.fixture(scope="module")
def case():
    return checks.build("zamba2-2.7b")


def test_cached_serve_matches_jax_engine(case):
    checks.check_cached_matches_jax(case)


def test_paged_serve_matches_jax_engine(case):
    checks.check_cached_matches_jax(case, "paged")


def test_stateless_serve_matches_jax_engine(case):
    checks.check_stateless_matches_jax(case, near_ties={1})


def test_port_equals_jitted_engine_where_it_keeps_its_op_by_op_tokens(case):
    checks.check_jitted_engine(case, jit_moves={0, 1, 2})


def test_cached_equals_paged_and_monolithic(case):
    checks.check_cached_paged_monolithic(case)


def test_stateless_against_cached(case):
    checks.check_stateless_against_cached(case, moved={0, 2})


def test_short_prompt_refused_for_cached_decode(case):
    checks.check_short_prompt(case)
