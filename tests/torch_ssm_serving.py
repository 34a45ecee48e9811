"""Shared checks of the port's serve of the recurrent configs against the
JAX engine (``test_torch_ssm_serving.py`` holds zamba2-2.7b,
``test_torch_xlstm_serving.py`` xlstm-350m; two files, so that two test
workers take them).

Both engines are built from the same seeds and bridged weights, the port
takes the JAX engine's strategy ``p`` and thresholds, and both serve the
same prompts (``tests/test_decode_serving.py``'s setup: vocab 128, prompts
of 12 and 8 tokens, threshold 0.1).  The port is held to the JAX engine run
op by op (``jax.disable_jit``), as the module tests hold it (ROADMAP queue
3): sequences and exit stages equal, simulated delays at rtol 1e-9.
Where two serves part (the jitted JAX engine from its op-by-op run, or a
stateless serve of one package from the other's), the checks name the
requests that part and show the cause: every head call of both serves is
recorded, the calls agree one for one up to the first call whose exit or
token decision differs, and there each differing decision is a near-tie
within the two serves' measured difference on that call.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

import jax

from repro_torch.models import layers as tlayers
from repro_torch.serving import monolithic_generate

from torch_port_common import engine_pair

GEN = 4
THRESHOLD = 0.1
PAGED = {"decode_mode": "cached", "cache_layout": "paged", "block_size": 4}


def serve(engine, prompts, seed=7, op_by_op=False, **kw):
    engine.rng = np.random.default_rng(seed)
    kw = dict(gen_len=GEN, arrival_rate=1e5, batch_size=4, **kw)
    if op_by_op:
        with jax.disable_jit():
            return engine.serve(prompts, **kw)
    return engine.serve(prompts, **kw)


@contextlib.contextmanager
def recorded_heads():
    """Both packages' exit and final heads, recording while the context is
    open: each call appends (exit stage, 0 for the final head; hidden [B, d]
    f32; confidences [B]; tokens [B]) to ``log["sink"]`` while that is a
    list.  The JAX heads record through a host callback, so a program traced
    inside the context records under jit as well as op by op."""
    import repro.models.model as jmodel
    import repro_torch.models.model as tmodel

    log = {"sink": None}

    def keep(stage, hidden, conf, tok):
        if log["sink"] is not None:
            conf = np.asarray(conf, np.float32)
            log["sink"].append((stage, np.asarray(hidden, np.float32).reshape(len(conf), -1), conf,
                                np.asarray(tok)))

    def jax_head(real, stage_of):
        def head(params, hidden, *rest):
            out = real(params, hidden, *rest)
            jax.debug.callback(functools.partial(keep, stage_of(rest)), hidden, *out, ordered=True)
            return out
        return head

    def port_head(real, stage_of):
        def head(params, hidden, *rest):
            out = real(params, hidden, *rest)
            keep(stage_of(rest), hidden.float().numpy(), *(t.numpy() for t in out))
            return out
        return head

    real = [(m, m.exit_confidence, m.final_confidence) for m in (jmodel, tmodel)]
    for (m, ex, fin), wrap in zip(real, (jax_head, port_head)):
        m.exit_confidence = wrap(ex, lambda rest: rest[0])
        m.final_confidence = wrap(fin, lambda rest: 0)
    try:
        yield log
    finally:
        for m, ex, fin in real:
            m.exit_confidence, m.final_confidence = ex, fin


def build(arch: str) -> dict:
    """Engines, prompts, every serve the checks read, and the head calls of
    the serves that may part: ``c["heads", who, mode]``."""
    with recorded_heads() as log:
        jeng, teng = engine_pair(THRESHOLD, arch)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, 128, size=n).astype(np.int32) for n in (12, 8, 12, 8)]
        c = {"arch": arch, "jeng": jeng, "teng": teng, "prompts": prompts}

        def recorded(who, mode, **kw):
            log["sink"] = c["heads", who, mode] = []
            try:
                return serve(teng if who == "port" else jeng, prompts, decode_mode=mode, **kw)
            finally:
                log["sink"] = None

        for mode in ("cached", "stateless"):
            c["port", mode] = recorded("port", mode)
            c["jax", mode] = recorded("jax", mode, op_by_op=True)
        c["port", "paged"] = serve(teng, prompts, **PAGED)
        c["jax", "paged"] = serve(jeng, prompts, op_by_op=True, **PAGED)
        c["jit", "cached"] = recorded("jit", "cached")
    return c


def differing(a, b) -> set[int]:
    sa, sb = a.sequences_by_rid(), b.sequences_by_rid()
    assert sa.keys() == sb.keys()
    return {rid for rid in sa if sa[rid] != sb[rid]}


def assert_same_serve(got, want):
    assert got.sequences_by_rid() == want.sequences_by_rid()
    np.testing.assert_allclose(np.asarray(got.delays)[np.argsort(got.rids)],
                               np.asarray(want.delays)[np.argsort(want.rids)], rtol=1e-9)
    s, w = got.summary(), want.summary()
    for key in ("num_batches", "num_forward_rows", "generated_tokens", "exit_histogram"):
        assert s[key] == w[key], key


def check_cached_matches_jax(c, layout: str = "cached"):
    """``layout``: "cached" (dense slots) or "paged" (the block pool)."""
    np.testing.assert_array_equal(c["teng"].p, c["jeng"].p)
    assert_same_serve(c["port", layout], c["jax", layout])


def head_logits(teng, stage: int, hidden: np.ndarray) -> np.ndarray:
    """f32 logits [B, V] of one head (``stage`` 0: the final head) on the
    recorded hidden states, through the port's norm and LM head (the bridged
    weights both packages hold)."""
    params = teng.programs.params
    norm = params["final_norm"] if stage == 0 else params["exit_norms"][f"exit_{stage}"]
    h = tlayers.apply_norm(teng.cfg.norm, {k: v.float() for k, v in norm.items()},
                           torch.from_numpy(hidden))
    return (h @ params["lm_head"].float()).numpy()


def assert_first_difference_is_a_near_tie(c, a: tuple, b: tuple):
    """Two serves' head calls (``c["heads", ...]`` keys ``a`` and ``b``)
    agree one for one up to the first call where a row's decision differs:
    at an exit branch whether it exits (confidence >= the threshold) or,
    exiting in both, its token; at the final head its token.  There every
    differing row is a near-tie: an exit decision whose confidence in ``b``
    lies closer to the threshold than the call's largest a-vs-b confidence
    difference, or a token whose two top f32 logits in ``b`` lie closer than
    the call's largest a-vs-b logit difference.  Returns (call index, the
    differing rows' (threshold or top-2 gap, measured difference))."""
    calls_a, calls_b = c[("heads", *a)], c[("heads", *b)]
    for n, ((sa, ha, ca, ta), (sb, hb, cb, tb)) in enumerate(zip(calls_a, calls_b)):
        assert sa == sb and ha.shape == hb.shape, f"call {n} has other rows"
        if sa == 0:
            flip_exit, flip_tok = np.zeros(len(ca), bool), ta != tb
        else:
            ea, eb = ca >= THRESHOLD, cb >= THRESHOLD
            flip_exit, flip_tok = ea != eb, ea & eb & (ta != tb)
        if (flip_exit | flip_tok).any():
            break
    else:
        pytest.fail(f"no head call of {a} and {b} differs")
    ties = []
    conf_diff = float(np.abs(ca - cb).max())
    for i in np.nonzero(flip_exit)[0]:
        ties.append((abs(float(cb[i]) - THRESHOLD), conf_diff))
    if flip_tok.any():
        la, lb = (head_logits(c["teng"], sa, h) for h in (ha, hb))
        logit_diff = float(np.abs(la - lb).max())
        for i in np.nonzero(flip_tok)[0]:
            top = np.sort(lb[i])[::-1]
            ties.append((float(top[0] - top[1]), logit_diff))
    for margin, measured in ties:
        assert margin <= measured, (n, ties)
    return n, ties


def check_stateless_matches_jax(c, near_ties: set[int]):
    """Equal but for ``near_ties``: requests that part at a head decision
    within the two packages' measured difference of a tie
    (``assert_first_difference_is_a_near_tie``); the shorter of the two
    sequences is then a prefix of the longer."""
    got, want = c["port", "stateless"], c["jax", "stateless"]
    assert differing(got, want) == near_ties
    g, w = got.sequences_by_rid(), want.sequences_by_rid()
    for rid in near_ties:
        a, b = sorted((g[rid][1], w[rid][1]), key=len)
        assert b[: len(a)] == a
    if near_ties:
        assert_first_difference_is_a_near_tie(c, ("port", "stateless"), ("jax", "stateless"))
    else:
        assert_same_serve(got, want)


def check_jitted_engine(c, jit_moves: set[int]):
    """The jitted engine leaves its op-by-op run on ``jit_moves``, parting
    from it at a head decision within the two runs' measured difference of a
    tie; the port equals it on every other request."""
    assert differing(c["jit", "cached"], c["jax", "cached"]) == jit_moves
    assert differing(c["port", "cached"], c["jit", "cached"]) == jit_moves
    if jit_moves:
        assert_first_difference_is_a_near_tie(c, ("jit", "cached"), ("jax", "cached"))


def check_cached_paged_monolithic(c):
    teng = c["teng"]
    cached = c["port", "cached"].sequences_by_rid()
    assert c["port", "paged"].sequences_by_rid() == cached
    mono = {}
    for i, p in enumerate(c["prompts"]):
        toks, stage = monolithic_generate(teng.programs.params, teng.cfg, p, teng.thresholds, GEN)
        mono[i] = (stage, tuple(toks))
    assert cached == mono
    assert max(len(toks) for _, toks in cached.values()) > 1  # some request decodes


def check_stateless_against_cached(c, moved: set[int]):
    """Stateless decode re-runs the padded prefix through the chunked scans
    while cached decode steps the recurrences: ``moved`` are the requests
    whose tokens differ, in the port and the op-by-op JAX engine alike."""
    assert differing(c["port", "stateless"], c["port", "cached"]) == moved
    assert differing(c["jax", "stateless"], c["jax", "cached"]) >= moved


def check_short_prompt(c):
    """A prompt shorter than conv_kernel - 1 = 3 tokens: the port's cached
    and paged serves refuse it before any work, naming the limit; the
    reference fails on it too (at the conv tail's slot write); the stateless
    serves take it and agree."""
    jeng, teng, prompts = c["jeng"], c["teng"], c["prompts"]
    short = [prompts[0], prompts[1][:2]]
    for kw in ({"decode_mode": "cached"}, PAGED):
        with pytest.raises(ValueError, match="at least 3 tokens"):
            serve(teng, short, **kw)
        with pytest.raises(Exception):
            serve(jeng, short, op_by_op=True, **kw)
    got = serve(teng, short, decode_mode="stateless")
    assert got.sequences_by_rid() == serve(jeng, short, op_by_op=True,
                                           decode_mode="stateless").sequences_by_rid()
    assert len(got.sequences_by_rid()) == 2
