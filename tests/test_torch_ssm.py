"""The port's ``models/ssm.py`` against ``repro.models.ssm``, function by
function, at reduced dims, with the reference's weights bridged in
(reduced zamba2-2.7b and xlstm-350m) and numpy inputs fed to both.

The JAX functions run op by op (``jax.disable_jit``), as the port's other
module tests run them (ROADMAP queue 3).  Tolerances: f32 results at
rtol 1e-5 / atol 2e-5 (the frameworks sum in other orders), bf16 results at
the bf16 tolerance of ``torch_port_common``, tokens and shapes exact.

Two reference faults are held in both packages alike: the mLSTM memory is
read transposed (chunked != sequential, by the same amount in both), and a
prompt shorter than ``conv_kernel - 1`` tokens leaves a short conv tail
that cached decode cannot step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm

from torch_port_common import as_np, assert_bf16_close, bridged_params

F32_RTOL, F32_ATOL = 1e-5, 2e-5


@pytest.fixture(autouse=True)
def op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def zamba():
    return bridged_params(0, "zamba2-2.7b")


@pytest.fixture(scope="module")
def xlstm():
    return bridged_params(0, "xlstm-350m")


def _pair(a: np.ndarray, bf16: bool = False):
    a = np.asarray(a, np.float32)
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _f32_close(got, want, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=rtol, atol=atol)


def _cell(tree, stage, j, kind):
    """(JAX, port) parameters of block ``j`` of ``stage`` (0-indexed, period
    0): dicts holding the block's pre-norm and, under ``kind``, its cell."""
    jp, tp = tree[0], tree[1]
    jb = jax.tree.map(lambda a: a[0], jp["stages"][stage]["blocks"][j])
    tb = tmodel._period(tp["stages"][stage]["blocks"][j], 0)
    return jb, tb


# ---------------------------------------------------------------------------
# helpers and layers
# ---------------------------------------------------------------------------


def test_pick_chunk_and_segsum_match():
    for S in range(1, 40):
        for chunk in (1, 4, 16, 256):
            assert tssm._pick_chunk(S, chunk) == jssm._pick_chunk(S, chunk)
    assert tssm._pick_chunk(17, 16) == 1  # a prime above the chunk: chunks of 1
    a = -np.abs(np.random.default_rng(0).standard_normal((2, 3, 9))).astype(np.float32)
    ja, ta = _pair(a)
    want, got = jssm.segsum(ja), tssm.segsum(ta)
    finite = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(as_np(got)), finite)
    np.testing.assert_allclose(as_np(got)[finite], np.asarray(want)[finite], atol=F32_ATOL)


def test_softplus_and_log_sigmoid_match():
    """Including the range above 20, where ``F.softplus`` would go linear."""
    x = np.concatenate([np.linspace(-40, 40, 161), [0.0, 1e-3, 19.5, 20.5, 60.0]]).astype(np.float32)
    jx, tx = _pair(x)
    _f32_close(tlayers.softplus(tx), jax.nn.softplus(jx), atol=1e-6)
    _f32_close(tlayers.log_sigmoid(tx), jax.nn.log_sigmoid(jx), atol=1e-6)


def test_causal_conv1d_and_conv_step_match(zamba):
    rng = np.random.default_rng(1)
    jb, tb = _cell(zamba, 0, 0, "mamba")
    C = jb["mamba"]["conv_w"].shape[1]
    jx, tx = _pair(rng.standard_normal((2, 7, C)), bf16=True)
    want = jssm.causal_conv1d(jx, jb["mamba"]["conv_w"], jb["mamba"]["conv_b"])
    got = tssm.causal_conv1d(tx, tb["mamba"]["conv_w"], tb["mamba"]["conv_b"])
    np.testing.assert_array_equal(as_np(got), as_np(want))
    jc, tc = _pair(rng.standard_normal((2, 3, C)), bf16=True)
    jo, jn = jssm.conv_step(jx[:, 0], jc, jb["mamba"]["conv_w"], jb["mamba"]["conv_b"])
    to, tn = tssm.conv_step(tx[:, 0], tc, tb["mamba"]["conv_w"], tb["mamba"]["conv_b"])
    assert_bf16_close(to, jo)
    np.testing.assert_array_equal(as_np(tn), as_np(jn))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, B, S, H=8, P=32, G=1, N=16):
    return (
        _pair(rng.standard_normal((B, S, H, P)), bf16=True),
        _pair(-0.3 * np.abs(rng.standard_normal((B, S, H)))),
        _pair(rng.standard_normal((B, S, G, N)), bf16=True),
        _pair(rng.standard_normal((B, S, G, N)), bf16=True),
    )


@pytest.mark.parametrize("S,chunk", [(16, 16), (16, 4), (17, 16)],
                         ids=["one-chunk", "four-chunks", "prime-length-chunk-1"])
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_matches(S, chunk, initial):
    rng = np.random.default_rng(2)
    x, a, b, c = _ssd_inputs(rng, 2, S)
    j0 = t0 = None
    if initial:
        j0, t0 = _pair(rng.standard_normal((2, 8, 32, 16)))
    jy, js = jssm.ssd_chunked(x[0], a[0], b[0], c[0], chunk, j0)
    ty, ts = tssm.ssd_chunked(x[1], a[1], b[1], c[1], chunk, t0)
    assert_bf16_close(ty, jy)
    _f32_close(ts, js, rtol=1e-5, atol=1e-4)


def test_ssd_step_matches_and_chunked_agrees_with_the_recurrence():
    """One step in both packages; and the chunked scan (S 16, four chunks)
    against the token-by-token recurrence it stands for, in both packages,
    norm-wise at 2^-7: the chunked form rounds its intra-chunk terms to bf16
    where the recurrence keeps them in f32, so single elements part by a
    few bf16 ulps (why stateless and cached decode can part on a near-tie)."""
    rng = np.random.default_rng(3)
    x, a, b, c = _ssd_inputs(rng, 2, 16)
    js, ts = _pair(rng.standard_normal((2, 8, 32, 16)))
    jy, jn = jssm.ssd_step(x[0][:, 0], a[0][:, 0], b[0][:, 0], c[0][:, 0], js)
    ty, tn = tssm.ssd_step(x[1][:, 0], a[1][:, 0], b[1][:, 0], c[1][:, 0], ts)
    assert_bf16_close(ty, jy)
    _f32_close(tn, jn)
    for lib, (xx, aa, bb, cc) in ((tssm, [t[1] for t in (x, a, b, c)]),
                                  (jssm, [t[0] for t in (x, a, b, c)])):
        y_chunk, s_chunk = lib.ssd_chunked(xx, aa, bb, cc, 4)
        state = torch.zeros((2, 8, 32, 16)) if lib is tssm else jnp.zeros((2, 8, 32, 16))
        ys = []
        for t in range(16):
            y, state = lib.ssd_step(xx[:, t], aa[:, t], bb[:, t], cc[:, t], state)
            ys.append(as_np(y))
        for got, want in ((np.stack(ys, axis=1), as_np(y_chunk)), (as_np(state), as_np(s_chunk))):
            assert np.linalg.norm(got - want) <= 2.0 ** -7 * np.linalg.norm(want)


def _prefill_cache(lib, cell, h, dims, kind):
    """The reference's prefill cache of one recurrent cell (its
    ``_block_apply``), from normed input ``h``."""
    K = dims.conv_kernel
    if kind == "mamba":
        out, state = lib.mamba_forward(cell, h, dims, return_state=True)
        _, xbc, _ = lib._mamba_split(cell, h[:, -(K - 1):], dims)
        return out, {"conv": xbc, "ssd": state}
    out, (C, n, m) = lib.mlstm_forward(cell, h, dims, return_state=True)
    up = (jlayers if lib is jssm else tlayers).matmul(h[:, -(K - 1):], cell["up_proj"])
    conv = jnp.split(up, 2, axis=-1)[0] if lib is jssm else torch.chunk(up, 2, dim=-1)[0]
    return out, {"conv": conv, "C": C, "n": n, "m": m}


@pytest.mark.parametrize("S", [10, 17])
def test_mamba_forward_and_decode_from_prefilled_state_match(zamba, S):
    jb, tb = _cell(zamba, 1, 2, "mamba")
    dims_j, dims_t = zamba[2].mamba, zamba[3].mamba
    rng = np.random.default_rng(4)
    jh, th = _pair(rng.standard_normal((3, S, 128)), bf16=True)
    jo, jc = _prefill_cache(jssm, jb["mamba"], jh, dims_j, "mamba")
    to, tc = _prefill_cache(tssm, tb["mamba"], th, dims_t, "mamba")
    assert_bf16_close(to, jo)
    _f32_close(tc["ssd"], jc["ssd"])
    np.testing.assert_array_equal(as_np(tc["conv"]), as_np(jc["conv"]))
    jc["pos"], tc["pos"] = jnp.asarray(S, jnp.int32), torch.tensor(S, dtype=torch.int32)
    jx, tx = _pair(rng.standard_normal((3, 1, 128)), bf16=True)
    for _ in range(2):
        jy, jc = jssm.mamba_decode(jb["mamba"], jx, jc, dims_j)
        ty, tc = tssm.mamba_decode(tb["mamba"], tx, tc, dims_t)
        assert_bf16_close(ty, jy)
        _f32_close(tc["ssd"], jc["ssd"])
        assert_bf16_close(tc["conv"], jc["conv"])
        assert int(tc["pos"]) == int(jc["pos"])
        jx, tx = jy, ty


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_inputs(rng, B, S, H, P):
    q = rng.standard_normal((B, S, H, P)) / np.sqrt(P)
    return (_pair(q), _pair(rng.standard_normal((B, S, H, P)), bf16=True),
            _pair(rng.standard_normal((B, S, H, P)), bf16=True),
            _pair(rng.standard_normal((B, S, H))), _pair(2.0 + rng.standard_normal((B, S, H))))


@pytest.mark.parametrize("S,chunk", [(16, 16), (16, 4), (17, 16)],
                         ids=["one-chunk", "four-chunks", "prime-length-chunk-1"])
def test_mlstm_chunked_matches(S, chunk):
    rng = np.random.default_rng(5)
    q, k, v, i, f = _mlstm_inputs(rng, 2, S, 4, 16)
    jh, jst = jssm.mlstm_chunked(q[0], k[0], v[0], i[0], f[0], chunk)
    th, tst = tssm.mlstm_chunked(q[1], k[1], v[1], i[1], f[1], chunk)
    _f32_close(th, jh, rtol=1e-4, atol=1e-4)
    for a, b in zip(tst, jst):
        _f32_close(a, b, rtol=1e-4, atol=1e-4)
    # from a carried state: a second call continues the first
    jh2, _ = jssm.mlstm_chunked(q[0], k[0], v[0], i[0], f[0], chunk, jst)
    th2, _ = tssm.mlstm_chunked(q[1], k[1], v[1], i[1], f[1], chunk, tst)
    _f32_close(th2, jh2, rtol=1e-4, atol=1e-4)


def test_mlstm_step_matches():
    rng = np.random.default_rng(6)
    q, k, v, i, f = _mlstm_inputs(rng, 2, 1, 4, 16)
    C = _pair(rng.standard_normal((2, 4, 16, 16)))
    n = _pair(rng.standard_normal((2, 4, 16)))
    m = _pair(rng.standard_normal((2, 4)))
    jh, js = jssm.mlstm_step(q[0][:, 0], k[0][:, 0], v[0][:, 0], i[0][:, 0], f[0][:, 0],
                             (C[0], n[0], m[0]))
    th, ts = tssm.mlstm_step(q[1][:, 0], k[1][:, 0], v[1][:, 0], i[1][:, 0], f[1][:, 0],
                             (C[1], n[1], m[1]))
    _f32_close(th, jh)
    for a, b in zip(ts, js):
        _f32_close(a, b)


def _sequential(lib, q, k, v, i, f):
    """``mlstm_step`` over the sequence from the empty state."""
    B, S, H, P = q.shape
    zeros = (lambda s: torch.zeros(s)) if lib is tssm else (lambda s: jnp.zeros(s))
    state = (zeros((B, H, P, P)), zeros((B, H, P)), -1e30 + zeros((B, H)))
    hs = []
    for t in range(S):
        h, state = lib.mlstm_step(q[:, t], k[:, t], v[:, t], i[:, t], f[:, t], state)
        hs.append(as_np(h))
    return np.stack(hs, axis=1)


def _sequential_kv(q, k, v, i, f):
    """The recurrence storing C = k v^T (read as q^T C), the xLSTM paper's
    memory, in numpy f64."""
    q, k, v, i, f = (np.asarray(as_np(t), np.float64) for t in (q, k, v, i, f))
    B, S, H, P = q.shape
    C, n, m = np.zeros((B, H, P, P)), np.zeros((B, H, P)), np.full((B, H), -1e30)
    out = np.zeros((B, S, H, P))
    for t in range(S):
        lf = -np.logaddexp(-f[:, t], 0.0)
        m_new = np.maximum(lf + m, i[:, t])
        fw, iw = np.exp(lf + m - m_new), np.exp(i[:, t] - m_new)
        C = C * fw[..., None, None] + iw[..., None, None] * np.einsum("bhp,bhn->bhpn", k[:, t], v[:, t])
        n = n * fw[..., None] + iw[..., None] * k[:, t]
        num = np.einsum("bhp,bhpn->bhn", q[:, t], C)
        den = np.einsum("bhp,bhp->bh", q[:, t], n)
        out[:, t] = num / np.maximum(np.abs(den), np.exp(-m_new))[..., None]
        m = m_new
    return out


def test_mlstm_transposed_memory_read_is_mirrored():
    """The reference fault (its ssm.py:372, :385, :431, :435): the memory
    stores v k^T but is read as q^T C, which contracts q with the value
    index.  At f32, B 1, S 13, H 4, P 8, against the step recurrence: the
    one-chunk scan and the chunk-1 scan both miss it, by amounts equal in
    the two packages; the one-chunk scan, right within its chunk, equals a
    recurrence that stores k v^T instead."""
    rng = np.random.default_rng(7)
    q, k, v, i, f = (np.asarray(t, np.float32) for t in (
        rng.standard_normal((1, 13, 4, 8)) / np.sqrt(8), rng.standard_normal((1, 13, 4, 8)),
        rng.standard_normal((1, 13, 4, 8)), rng.standard_normal((1, 13, 4)),
        2.0 + rng.standard_normal((1, 13, 4))))
    gaps = {}
    for name, lib, cast in (("jax", jssm, jnp.asarray), ("port", tssm, torch.from_numpy)):
        args = [cast(t) for t in (q, k, v, i, f)]
        seq = _sequential(lib, *args)
        one = as_np(lib.mlstm_chunked(*args, 16)[0])  # S 13: one chunk of 13
        unit = as_np(lib.mlstm_chunked(*args, 4)[0])  # S 13 is prime: chunks of 1
        gaps[name] = (np.abs(one - seq).max(), np.abs(unit - seq).max())
        np.testing.assert_allclose(one, _sequential_kv(q, k, v, i, f), rtol=1e-4, atol=1e-4)
    assert gaps["port"] == pytest.approx(gaps["jax"], rel=1e-3)
    assert min(gaps["port"]) > 1.0, gaps  # far off, not rounding


def test_mlstm_forward_and_decode_from_prefilled_state_match(xlstm):
    jb, tb = _cell(xlstm, 1, 0, "mlstm")
    dims_j, dims_t = xlstm[2].xlstm, xlstm[3].xlstm
    rng = np.random.default_rng(8)
    jh, th = _pair(rng.standard_normal((3, 10, 128)), bf16=True)
    jo, jc = _prefill_cache(jssm, jb["mlstm"], jh, dims_j, "mlstm")
    to, tc = _prefill_cache(tssm, tb["mlstm"], th, dims_t, "mlstm")
    assert_bf16_close(to, jo)
    for key in ("C", "n", "m"):
        _f32_close(tc[key], jc[key], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(as_np(tc["conv"]), as_np(jc["conv"]))
    jc["pos"], tc["pos"] = jnp.asarray(10, jnp.int32), torch.tensor(10, dtype=torch.int32)
    jx, tx = _pair(rng.standard_normal((3, 1, 128)), bf16=True)
    jy, jn = jssm.mlstm_decode(jb["mlstm"], jx, jc, dims_j)
    ty, tn = tssm.mlstm_decode(tb["mlstm"], tx, tc, dims_t)
    assert_bf16_close(ty, jy)
    for key in ("C", "n", "m"):
        _f32_close(tn[key], jn[key], rtol=1e-4, atol=1e-4)
    assert int(tn["pos"]) == 11


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def test_slstm_cell_matches(xlstm):
    jb, tb = _cell(xlstm, 0, 1, "slstm")
    rng = np.random.default_rng(9)
    H, P = 4, 32
    jw, tw = _pair(rng.standard_normal((3, 4 * 128)), bf16=True)
    st = [_pair(rng.standard_normal((3, H, P))) for _ in range(4)]
    jout, jh = jssm.slstm_cell(jw, jb["slstm"]["r_gates"], jb["slstm"]["gate_bias"],
                               tuple(s[0] for s in st), H, P)
    tout, th = tssm.slstm_cell(tw, tb["slstm"]["r_gates"], tb["slstm"]["gate_bias"],
                               tuple(s[1] for s in st), H, P)
    _f32_close(th, jh)
    for a, b in zip(tout, jout):
        _f32_close(a, b)


def test_slstm_forward_and_decode_match(xlstm):
    jb, tb = _cell(xlstm, 2, 1, "slstm")
    dims_j, dims_t = xlstm[2].xlstm, xlstm[3].xlstm
    rng = np.random.default_rng(10)
    jh, th = _pair(rng.standard_normal((3, 10, 128)), bf16=True)
    jo, js = jssm.slstm_forward(jb["slstm"], jh, dims_j, return_state=True)
    to, ts = tssm.slstm_forward(tb["slstm"], th, dims_t, return_state=True)
    assert_bf16_close(to, jo)
    for a, b in zip(ts, js):
        _f32_close(a, b, rtol=1e-4, atol=1e-4)
    jc = dict(zip("cnhm", js), pos=jnp.asarray(10, jnp.int32))
    tc = dict(zip("cnhm", ts), pos=torch.tensor(10, dtype=torch.int32))
    jx, tx = _pair(rng.standard_normal((3, 1, 128)), bf16=True)
    jy, jn = jssm.slstm_decode(jb["slstm"], jx, jc, dims_j)
    ty, tn = tssm.slstm_decode(tb["slstm"], tx, tc, dims_t)
    assert_bf16_close(ty, jy)
    for key in "cnhm":
        _f32_close(tn[key], jn[key], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# caches and the short-prompt fault
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_slot_and_paged_caches_match_reference_layout(arch):
    """Per-kind state leaves, slot-indexed in both layouts (only K/V go into
    the pool; xLSTM has no pool leaves), with the reference's shapes,
    dtypes and initial values (mLSTM's and sLSTM's ``m`` at -1e30)."""
    jcfg, tcfg = bridged_params(0, arch)[2:]
    want = jmodel.init_stage_paged_caches(jcfg, 2, 3, 5, 4, 16)
    got = tmodel.init_stage_paged_caches(tcfg, 2, 3, 5, 4, 16, device="cpu")
    dense_j = jmodel.init_stage_slot_caches(jcfg, 2, 3, 16)
    dense_t = tmodel.init_stage_slot_caches(tcfg, 2, 3, 16, device="cpu")
    for jtree, ttree in ((want[0], got[0]), (want[1], got[1]), (dense_j, dense_t)):
        assert len(jtree) == len(ttree)
        for jd, td in zip(jtree, ttree):
            assert sorted(jd) == sorted(td)
            for key in jd:
                assert tuple(td[key].shape) == tuple(jd[key].shape), key
                np.testing.assert_array_equal(as_np(td[key]), as_np(jd[key]))
    if arch == "xlstm-350m":
        assert all(not d for d in got[0])


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_short_prompt_leaves_a_short_conv_tail_in_both(arch):
    """A 2-token prompt (conv_kernel - 1 = 3): a stage's prefill caches a
    2-row conv tail in both packages, and the next decode step through it
    fails in both; the engine refuses such a prompt for cached decode
    (``test_torch_ssm_serving.py``)."""
    jparams, tparams, jcfg, tcfg = bridged_params(0, arch)
    jx, tx = _pair(np.random.default_rng(11).standard_normal((1, 2, 128)), bf16=True)
    jo, jc = jmodel.prefill_stage(jparams, 1, jx, jcfg, 6)
    to, tc = tmodel.prefill_stage(tparams, 1, tx, tcfg, 6)
    assert_bf16_close(to, jo)
    assert tuple(tc[0]["conv"].shape) == tuple(jc[0]["conv"].shape)
    assert tc[0]["conv"].shape[2] == 2
    assert tmodel.min_cached_prompt_len(tcfg) == 3
    jstep, tstep = jx[:, -1:], tx[:, -1:]
    with pytest.raises(Exception):
        jmodel._decode_stage(jparams["stages"][0], jstep, jc, jcfg)
    with pytest.raises(RuntimeError):
        tmodel._decode_stage(tparams["stages"][0], tstep, tc, tcfg)
