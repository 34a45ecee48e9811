"""Split-KV flash-decode and the vocab-split exit head on the CPU, held to
the JAX package's kernels on the whole cache and the whole head.

Each sequence shard's partial (``decode_attention_partial``: the output in
f32 before its cast and the log-sum-exp of its keys' scores) goes through
``ops.combine_partials``; each vocab block's (``exit_confidence_partial``:
also the max logit) through ``ops.combine_exit_partials``.  Tolerances are
``tests/test_torch_kernels.py``'s: decode f32 2e-5 and bf16 2e-2, the exit
head's conf 1e-3 with an exact argmax on inputs with a clear top-1 margin.
A row of length 0 gives (0, -inf) and combines to zeros, as the kernels'
rows of length 0 do (the JAX oracle gives the mean of V there)."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import exit_confidence as texit
from repro_torch.kernels import ops, ref

import torch_port_common  # noqa: F401  (one CPU thread for the port's ops)
from test_torch_kernels import _margin_inputs

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, S, Hq, KVH, hd, lengths): G 1, 4 and 8; rows of length 0, rows
# ending in an early shard (the later ones empty) and full rows
DECODE_CASES = [
    (6, 100, 4, 4, 32, [0, 1, 13, 37, 64, 100]),
    (4, 96, 8, 2, 64, [96, 50, 0, 7]),
    (3, 130, 8, 1, 16, [129, 65, 2]),
]


def _decode_inputs(seed, B, S, hq, kvh, hd, lengths, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, hq, hd), (B, S, kvh, hd), (B, S, kvh, hd))]
    j = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    ln = np.asarray(lengths, np.int32)
    return j + [jnp.asarray(ln)], t + [torch.from_numpy(ln)]


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _jax_lse(q, k, lengths):
    """``jax.nn.logsumexp`` of the reference's masked scores, [B, Hq]."""
    B, hq, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(B, kvh, hq // kvh, hd)
    scores = jnp.einsum("bkgd,bskd->bkgs", qg, k).astype(jnp.float32) * float(1.0 / math.sqrt(hd))
    valid = jnp.arange(k.shape[1])[None, :] < lengths[:, None]
    scores = jnp.where(valid[:, None, None, :], scores, jref.NEG_INF)
    return jax.nn.logsumexp(scores, axis=-1).reshape(B, hq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_partial_decode_matches_reference(dtype, case):
    """o against ``repro.kernels.ref.decode_attention_ref`` on the rows with
    keys and lse against the logsumexp of its masked scores; a row of length
    0 gives (0, -inf)."""
    B, S, hq, kvh, hd, lengths = case
    (jq, jk, jv, jln), (tq, tk, tv, tln) = _decode_inputs(0, *case, dtype)
    o, lse = tdec.decode_attention_partial(tq, tk, tv, tln)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (B, hq, hd) and lse.shape == (B, hq)
    live = np.asarray(lengths) > 0
    want = _f32(jref.decode_attention_ref(jq, jk, jv, jln))
    np.testing.assert_allclose(o.numpy()[live], want[live], atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.numpy()[live], _f32(_jax_lse(jq, jk, jln))[live],
                               atol=TOL[dtype], rtol=1e-6)
    assert (o.numpy()[~live] == 0).all() and np.isneginf(lse.numpy()[~live]).all()
    # the f32-score variant: the kernels' softmax, the same contract
    o32, lse32 = ref.decode_attention_partial_ref(tq, tk, tv, tln, f32_scores=True)
    np.testing.assert_allclose(o32.numpy()[live], want[live], atol=TOL[dtype], rtol=0)
    assert (o32.numpy()[~live] == 0).all() and np.isneginf(lse32.numpy()[~live]).all()


def _shard_partials(q, k, v, lengths, n, offset=True):
    """Each of n sequence shards' partial (``torch.chunk`` cuts, so shards
    may be unequal), its local lengths ``lengths`` less its first key's
    position, clamped to [0, S_i]; stacked [n, ...]."""
    parts, lo = [], 0
    for kc, vc in zip(torch.chunk(k, n, dim=1), torch.chunk(v, n, dim=1)):
        local = (lengths - (lo if offset else 0)).clamp(0, kc.shape[1]).to(torch.int32)
        parts.append(ops.decode_attention_partial(q, kc, vc, local))
        lo += kc.shape[1]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_combine_over_shards_matches_whole_cache(dtype, n, case):
    """The shards' partials combined, in f32 and cast to ``dtype``, against
    the JAX oracle on the whole cache; zeros at length 0."""
    B, S, hq, kvh, hd, lengths = case
    (jq, jk, jv, jln), (tq, tk, tv, tln) = _decode_inputs(1, *case, dtype)
    o, lse = _shard_partials(tq, tk, tv, tln, n)
    got = ops.combine_partials(o, lse).to(TDT[dtype])
    assert got.dtype == TDT[dtype] and got.shape == (B, hq, hd)
    live = np.asarray(lengths) > 0
    want = _f32(jref.decode_attention_ref(jq, jk, jv, jln))
    np.testing.assert_allclose(_f32(got)[live], want[live], atol=TOL[dtype], rtol=0)
    assert (_f32(got)[~live] == 0).all()


def test_combine_rejects_planted_faults():
    """The same comparison fails for a combine without the lse weights and
    for local lengths taken without the shard's offset."""
    case = DECODE_CASES[0]
    (jq, jk, jv, jln), (tq, tk, tv, tln) = _decode_inputs(2, *case, "float32")
    live = np.asarray(case[-1]) > 0
    want = _f32(jref.decode_attention_ref(jq, jk, jv, jln))[live]
    o, lse = _shard_partials(tq, tk, tv, tln, 4)
    unweighted = o.sum(0) / (lse > -math.inf).sum(0).clamp_min(1)[..., None]
    o_f, lse_f = _shard_partials(tq, tk, tv, tln, 4, offset=False)
    for bad in (unweighted, ops.combine_partials(o_f, lse_f)):
        assert np.abs(bad.numpy()[live] - want).max() > 100 * TOL["float32"]


def test_partial_split_groups_equals_whole():
    """``split_groups`` hands a launch's tuple of outputs back head by head:
    G 40 in chunks of 16, 16 and 8 equals the whole partial."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 80, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 24, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 24, 2, 32)).astype(np.float32))
    ln = torch.tensor([24, 0], dtype=torch.int32)
    chunks = []

    def launch(qc):
        chunks.append(qc.shape[1] // 2)
        return ref.decode_attention_partial_ref(qc, k, v, ln)

    o, lse = tdec.split_groups(q, 2, launch)
    ow, lw = ref.decode_attention_partial_ref(q, k, v, ln)
    assert chunks == [16, 16, 8]
    torch.testing.assert_close(o, ow, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, lw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_vocab_split_exit_head_matches_reference(dtype, n):
    """Each vocab block's (conf, argmax + offset, max logit) combined against
    ``repro.kernels.ref.exit_confidence_ref`` on the whole head; row 0's top
    column is copied into the last block, and the combine keeps the first
    (the kernel's rule on ties)."""
    B, d, V = 6, 64, 1000
    h, w = _margin_inputs(np.random.default_rng(5), B, d, V)
    j1 = int(np.argmax(h[0] @ w))
    w[:, V - 1] = w[:, j1]
    jh, jw = jnp.asarray(h, JDT[dtype]), jnp.asarray(w, JDT[dtype])
    th, tw = torch.from_numpy(h).to(TDT[dtype]), torch.from_numpy(w).to(TDT[dtype])
    parts, lo = [], 0
    for wc in torch.chunk(tw, n, dim=1):
        c, i, m = texit.exit_confidence_partial(th, wc.contiguous())
        assert c.dtype == m.dtype == torch.float32 and i.dtype == torch.int32
        parts.append((c, i + lo, m))
        lo += wc.shape[1]
    conf, idx = ops.combine_exit_partials(*(torch.stack([p[j] for p in parts]) for j in range(3)))
    cref, iref = jref.exit_confidence_ref(jh, jw)
    np.testing.assert_allclose(conf.numpy(), np.asarray(cref), atol=1e-3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(iref))
    assert int(idx[0]) == j1 and idx.dtype == torch.int32
    if n > 1:  # the argmax without its block's offset is refused
        _, bad = ops.combine_exit_partials(*(torch.stack([p[j] if j != 1 else p[1] - lo_
                                                          for p, lo_ in zip(parts, _offsets(tw, n))])
                                             for j in range(3)))
        assert not np.array_equal(bad.numpy(), np.asarray(iref))


def _offsets(w, n):
    out, lo = [], 0
    for wc in torch.chunk(w, n, dim=1):
        out.append(lo)
        lo += wc.shape[1]
    return out


def test_partial_exit_head_max_logit():
    """The partial's max logit is the row's max of h @ w, and with conf it
    gives the row's log-sum-exp: m - log(conf)."""
    h, w = _margin_inputs(np.random.default_rng(6), 4, 32, 300)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    c, i, m = texit.exit_confidence_partial(th, tw)
    logits = torch.from_numpy(h.astype(np.float64) @ w.astype(np.float64))
    torch.testing.assert_close(m.double(), logits.max(-1).values, rtol=0, atol=1e-4)
    torch.testing.assert_close((m - torch.log(c)).double(), torch.logsumexp(logits, -1),
                               rtol=0, atol=1e-4)
    c0, i0 = texit.exit_confidence(th, tw)
    assert torch.equal(c, c0) and torch.equal(i, i0)
