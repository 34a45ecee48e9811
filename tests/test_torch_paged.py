"""The port's paged slot layout against the JAX package, module by module
and as a whole serve, plus the port's own paged == dense == monolithic
invariant.

Kernel level: ``ref.paged_decode_attention_ref`` against JAX's oracle and
against the Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s
tolerances (f32 2e-5, bf16 2e-2).  Module level: the JAX functions run op by
op (``jax.disable_jit``), as in ``test_torch_models.py``; bf16 results at
rtol 1.6e-2 / atol 1e-2, positions and block indices exact.  A padded batch
row whose position has run past its table (``pos >= n_logical * bs``) is
planted in every write test: the reference drops that write, the port sends
it to the pool's trash block (its last row), and every real block must
match.

Serve level: the port's paged serve against the jitted JAX paged engine on
the same weights, prompts and arrivals, at block sizes 1, 3 and 16 with
prefix sharing on and off, and with a tight pool: sequences, exit stages,
simulated delays, prefix hits, occupancy and peak in flight must be
identical.  Token equality across the two frameworks needs every exit
decision to sit clear of the frameworks' last-bit differences (the jitted
reference keeps some bf16 intermediates in f32; ROADMAP queue 3): the
prompts are ones on which the port's DENSE serve and the JAX dense engine
agree, which ``test_dense_serves_agree`` asserts first.  The port's own
invariant (paged == dense == monolithic, pools drained) is held on three
prompt sets, since it compares the port with itself.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import paged_decode_attention as pallas_paged
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving import steps as jsteps
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import exit_confidence as texit
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode_attention as tpaged
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.serving import monolithic_generate
from repro_torch.serving import steps as tsteps

from torch_port_common import as_np, assert_bf16_close, bridged_params, engine_pair

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GEN = 6
THRESHOLD = 0.1


def _pair(a: np.ndarray, dtype: str = "bfloat16"):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _paged_case(rng, B, KVH, G, hd, bs, n_logical):
    """A pool of shuffled blocks plus one trailing trash block, each row's
    table pointing at its own blocks and at the trash block past them; the
    last row is a padded all-trash row."""
    NB = B * n_logical + 1
    trash = NB - 1
    table = np.full((B, n_logical), trash, np.int32)
    perm = rng.permutation(NB - 1)
    used = rng.integers(1, n_logical + 1, size=B)
    for b in range(B - 1):
        table[b, : used[b]] = perm[b * n_logical : b * n_logical + used[b]]
    lengths = np.array([rng.integers((u - 1) * bs + 1, u * bs + 1) for u in used], np.int32)
    q = rng.standard_normal((B, KVH * G, hd)).astype(np.float32)
    k_pool = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    v_pool = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    return q, k_pool, v_pool, table, lengths


# ---------------------------------------------------------------------------
# the plain version against JAX's oracle and the Pallas kernel
# ---------------------------------------------------------------------------


def _kernel_inputs(bs, G, hd, dtype):
    rng = np.random.default_rng(bs * 100 + G * 10 + hd)
    n_logical = -(-20 // bs)
    q, kp, vp, table, lengths = _paged_case(rng, 3, 2, G, hd, bs, n_logical)
    seq_len = n_logical * bs - (bs > 1)  # the virtual view cut short where it can be
    lengths[0] = n_logical * bs  # overhangs seq_len
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    return ((jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths)),
            (tq, tk, tv, torch.from_numpy(table), torch.from_numpy(lengths)), seq_len)


# one compiled program per shape: cheaper here than compiling each op of it
_jax_oracle = jax.jit(jref.paged_decode_attention_ref, static_argnames="seq_len")


# f32 over every combination; bf16 (the serving dtype) over a covering set
COVER = [(1, 1, 32), (3, 2, 64), (4, 4, 32), (16, 2, 64)]


@pytest.mark.parametrize(
    "bs,G,hd,dtype",
    [(bs, G, hd, "float32") for bs in (1, 3, 4, 16) for G in (1, 2, 4) for hd in (32, 64)]
    + [(*c, "bfloat16") for c in COVER],
)
def test_paged_ref_matches_jax_oracle(bs, G, hd, dtype):
    jargs, targs, seq_len = _kernel_inputs(bs, G, hd, dtype)
    got = ref.paged_decode_attention_ref(*targs, seq_len=seq_len)
    assert got.dtype == TDT[dtype] and got.shape == targs[0].shape
    want = _jax_oracle(*jargs, seq_len=seq_len)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=TOL[dtype])


# every block size, G and hd at least once (interpret mode compiles per shape)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs,G,hd", COVER)
def test_paged_ref_matches_pallas_body(bs, G, hd, dtype):
    jargs, targs, seq_len = _kernel_inputs(bs, G, hd, dtype)
    got = ref.paged_decode_attention_ref(*targs, seq_len=seq_len)
    # the Pallas kernel takes no seq_len: the reference's ops clamp the lengths
    jq, jk, jv, jt, jl = jargs
    body = pallas_paged(jq, jk, jv, jt, jnp.minimum(jl, seq_len), interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(body), atol=TOL[dtype])


def test_paged_ref_with_contiguous_table_is_bitwise_dense():
    """Blocks laid out in order plus the ``seq_len`` slice give the dense
    plain version on the same rows, bit for bit: the bridge that keeps the
    paged serve equal to the dense one on the CPU."""
    rng = np.random.default_rng(3)
    B, S, KVH, Hq, hd, bs = 2, 20, 2, 4, 32, 8
    n_logical = -(-S // bs)
    k = torch.from_numpy(rng.standard_normal((B, S, KVH, hd)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((B, S, KVH, hd)).astype(np.float32)).bfloat16()
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd)).astype(np.float32)).bfloat16()
    lengths = torch.tensor([S, 13], dtype=torch.int32)
    pad = torch.zeros((B, n_logical * bs - S, KVH, hd), dtype=k.dtype)
    k_pool = torch.cat([k, pad], 1).reshape(B * n_logical, bs, KVH, hd)
    v_pool = torch.cat([v, pad], 1).reshape(B * n_logical, bs, KVH, hd)
    table = torch.arange(B * n_logical, dtype=torch.int32).reshape(B, n_logical)
    want = ref.decode_attention_ref(q, k, v, lengths)
    got = ref.paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, seq_len=S)
    assert torch.equal(got, want)


def test_paged_wrapper_and_ops_on_the_cpu():
    """On a CPU tensor the wrapper and ``ops`` (auto and torch) run the plain
    version with the ``seq_len`` cut and launch nothing; the cuda backend
    refuses a CPU tensor."""
    rng = np.random.default_rng(4)
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _paged_case(rng, 3, 2, 2, 32, 3, 5))
    want = ref.paged_decode_attention_ref(q, kp, vp, table, lengths, seq_len=13)
    n0 = tpaged.paged_decode_attention.launches
    assert torch.equal(tpaged.paged_decode_attention(q, kp, vp, table, lengths, seq_len=13), want)
    try:
        for backend in ("auto", "torch"):
            ops.set_backend(backend)
            assert torch.equal(ops.paged_decode_attention(q, kp, vp, table, lengths, seq_len=13), want)
        ops.set_backend("cuda")
        with pytest.raises(ValueError, match="cuda"):
            ops.paged_decode_attention(q, kp, vp, table, lengths, seq_len=13)
    finally:
        ops.set_backend("auto")
    assert tpaged.paged_decode_attention.launches == n0


# ---------------------------------------------------------------------------
# attention, stage and step modules against JAX (op by op)
# ---------------------------------------------------------------------------


@pytest.fixture
def op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def bridged():
    return bridged_params(0)


def _np_pool(rng, n_periods, NB, bs, dims):
    return rng.standard_normal((n_periods, NB, bs, dims.num_kv_heads, dims.head_dim)).astype(np.float32)


def test_paged_token_write_sends_overflow_to_trash(op_by_op):
    rng = np.random.default_rng(5)
    NB, bs, n_logical = 7, 3, 2
    pool = rng.standard_normal((NB, bs, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    table = np.array([[0, 4], [2, 6], [3, 5]], np.int32)  # 6 is the trash block
    pos = np.array([4, 0, n_logical * bs + 2], np.int32)  # row 2 past its table of real blocks
    want = np.asarray(jattn._paged_token_write(jnp.asarray(pool), jnp.asarray(new),
                                               jnp.asarray(table), jnp.asarray(pos)))
    got = torch.from_numpy(pool.copy())
    tattn._paged_token_write((got,), (torch.from_numpy(new),), torch.from_numpy(table),
                             torch.from_numpy(pos))
    np.testing.assert_array_equal(got[:-1].numpy(), want[:-1])  # every real block
    np.testing.assert_array_equal(want[-1], pool[-1])  # the reference dropped the write
    np.testing.assert_array_equal(got[-1, pos[2] % bs].numpy(), new[2, 0])  # the port: trash
    np.testing.assert_array_equal(got[4, 1].numpy(), new[0, 0])
    np.testing.assert_array_equal(got[2, 0].numpy(), new[1, 0])


def test_gqa_decode_paged_matches(bridged, op_by_op):
    jparams, tparams, jcfg, tcfg = bridged
    rng = np.random.default_rng(6)
    dims = jcfg.attn_dims()
    jp = jax.tree.map(lambda a: a[0], jparams["stages"][1]["blocks"][0])["attn"]
    tp = tmodel._period(tparams["stages"][1]["blocks"][0], 0)["attn"]
    NB, bs, n_logical, seq_len = 9, 4, 4, 14
    kp, vp = (_np_pool(rng, 1, NB, bs, dims)[0] for _ in range(2))
    table = np.array([[3, 0, 5, 8], [1, 7, 8, 8], [2, 4, 6, 7]], np.int32)  # 8 is trash
    pos = np.array([9, 4, n_logical * bs + 1], np.int32)  # row 2: past its table of real blocks
    jx, tx = _pair(rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32))
    jc = {"k": jnp.asarray(kp, jnp.bfloat16), "v": jnp.asarray(vp, jnp.bfloat16),
          "pos": jnp.asarray(pos), "table": jnp.asarray(table)}
    tc = {"k": torch.from_numpy(kp).bfloat16(), "v": torch.from_numpy(vp).bfloat16(),
          "pos": torch.from_numpy(pos), "table": torch.from_numpy(table)}
    jout, jnew = jattn.gqa_decode_paged(jp, jx, jc, dims, seq_len)
    tout, tnew = tattn.gqa_decode_paged(tp, tx, tc, tcfg.attn_dims(), seq_len)
    assert tnew["k"] is tc["k"]  # written in place
    assert_bf16_close(tout[:2], jout[:2])  # row 2's output is a padded row's, discarded
    for key in ("k", "v"):
        assert_bf16_close(tnew[key][:-1], jnew[key][:-1])
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))


def _prefill_stage(jparams, tparams, jcfg, tcfg, rng, stage, B, S, max_len):
    jx, tx = _pair(rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32))
    jout, jcaches = jmodel.prefill_stage(jparams, stage, jx, jcfg, max_len)
    tout, tcaches = tmodel.prefill_stage(tparams, stage, tx, tcfg, max_len)
    return jout, tout, jcaches, tcaches


def test_paged_slot_write_stage_decode_and_block_copy_match(bridged, op_by_op):
    """Prefill rows into a paged store through write tables (a shared block
    and the blocks past a prompt go to trash, a padded row is all trash),
    decode one token per row (the padded row's position past its table),
    then copy blocks with a source that is also a destination."""
    jparams, tparams, jcfg, tcfg = bridged
    rng = np.random.default_rng(7)
    stage, B, S, max_len, bs = 2, 3, 7, 12, 3
    n_logical = -(-max_len // bs)
    n_slots, n_blocks = 4, 12
    trash, trash_block = n_slots, n_blocks
    jpool, jstate = jmodel.init_stage_paged_caches(jcfg, stage, n_slots + 1, n_blocks + 1, bs, max_len)
    tpool, tstate = tmodel.init_stage_paged_caches(tcfg, stage, n_slots + 1, n_blocks + 1, bs, max_len,
                                                   device="cpu")
    for jd, td in zip(jpool + jstate, tpool + tstate):
        assert {k: v.shape for k, v in jd.items()} == {k: tuple(v.shape) for k, v in td.items()}
    jpool = tuple({k: jnp.asarray(_np_pool(rng, *v.shape[:3], jcfg.attn_dims()), v.dtype)
                   for k, v in d.items()} for d in jpool)
    tpool = tuple({k: torch.from_numpy(np.asarray(jpool[i][k], np.float32)).bfloat16()
                   for k in d} for i, d in enumerate(tpool))
    _, _, jcaches, tcaches = _prefill_stage(jparams, tparams, jcfg, tcfg, rng, stage, B, S, max_len)
    wtab = np.full((B, n_logical), trash_block, np.int64)
    wtab[0, :3] = [4, 0, 9]
    wtab[1, :3] = [trash_block, 2, 6]  # block 0 shared: never rewritten
    slots = np.array([1, 3, trash], np.int64)
    jwrite = jsteps.make_paged_slot_write(jcfg, stage)
    jpool, jstate = jwrite(jpool, jstate, jcaches, jnp.asarray(wtab, jnp.int32),
                           jnp.asarray(slots, jnp.int32))
    tsteps.paged_slot_write(tpool, tstate, tcaches, torch.from_numpy(wtab), torch.from_numpy(slots))
    for jd, td in zip(jpool, tpool):
        for key in jd:
            assert_bf16_close(td[key][:, :-1], jd[key][:, :-1])
    np.testing.assert_array_equal(tstate[0]["pos"].numpy(), np.asarray(jstate[0]["pos"]))

    # the padded row's trash slot: its position has run past the table
    jstate = ({"pos": jstate[0]["pos"].at[:, trash].set(n_logical * bs + 2)},)
    tstate[0]["pos"][:, trash] = n_logical * bs + 2
    rtab = np.array([[4, 0, 9, 5], [1, 2, 6, trash_block], [trash_block] * 4], np.int32)
    jx, tx = _pair(rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32))
    jdecode = jsteps.make_paged_stage_decode(jcfg, stage, max_len)
    jy, jpool, jstate = jdecode(jparams, jx, jpool, jstate, jnp.asarray(rtab),
                                jnp.asarray(slots, jnp.int32))
    ty = tsteps.paged_stage_decode(tparams, tx, tpool, tstate, torch.from_numpy(rtab),
                                   torch.from_numpy(slots), tcfg, stage, max_len)
    assert_bf16_close(ty[:2], jy[:2])
    for jd, td in zip(jpool, tpool):
        for key in jd:
            assert_bf16_close(td[key][:, :-1], jd[key][:, :-1])
    np.testing.assert_array_equal(tstate[0]["pos"].numpy(), np.asarray(jstate[0]["pos"]))

    # block copy on a fresh pool with the same values in both
    src, dst = np.array([0, 2, 6]), np.array([2, 7, 3])  # block 2 is read and written
    jpool = tuple({k: jnp.asarray(_np_pool(rng, *v.shape[:3], jcfg.attn_dims()), v.dtype)
                   for k, v in d.items()} for d in jpool)
    tpool = tuple({k: torch.from_numpy(np.asarray(jpool[i][k], np.float32)).bfloat16()
                   for k in d} for i, d in enumerate(tpool))
    before = [{k: v.clone() for k, v in d.items()} for d in tpool]
    jpool = jsteps.make_block_copy(jcfg, stage)(jpool, jnp.asarray(src, jnp.int32),
                                                jnp.asarray(dst, jnp.int32))
    tsteps.block_copy(tpool, torch.from_numpy(src), torch.from_numpy(dst))
    for jd, td, bd in zip(jpool, tpool, before):
        for key in jd:
            np.testing.assert_array_equal(as_np(td[key]), as_np(jd[key]))
            assert torch.equal(td[key][:, dst], bd[key][:, src])
            rest = [i for i in range(td[key].shape[1]) if i not in dst]
            assert torch.equal(td[key][:, rest], bd[key][:, rest])


def test_decode_stage_paged_matches(bridged, op_by_op):
    jparams, tparams, jcfg, tcfg = bridged
    rng = np.random.default_rng(8)
    stage, bs, NB, seq_len = 3, 4, 10, 15
    dims = jcfg.attn_dims()
    P = jcfg.stage_periods()[stage - 1]
    kp, vp = _np_pool(rng, P, NB, bs, dims), _np_pool(rng, P, NB, bs, dims)
    tables = np.array([[2, 5, 1, 9], [7, 9, 9, 9]], np.int32)
    pos = np.broadcast_to(np.array([11, 17], np.int32), (P, 2)).copy()  # row 1 past its table
    jx, tx = _pair(rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32))
    jpool = ({"k": jnp.asarray(kp, jnp.bfloat16), "v": jnp.asarray(vp, jnp.bfloat16)},)
    tpool = ({"k": torch.from_numpy(kp).bfloat16(), "v": torch.from_numpy(vp).bfloat16()},)
    jy, jnew = jmodel.decode_stage_paged(jparams, stage, jx, jpool, ({"pos": jnp.asarray(pos)},),
                                         jnp.asarray(tables), jcfg, seq_len)
    ty, tnew = tmodel.decode_stage_paged(tparams, stage, tx, tpool, ({"pos": torch.from_numpy(pos)},),
                                         torch.from_numpy(tables), tcfg, seq_len)
    assert_bf16_close(ty[:1], jy[:1])
    for key in ("k", "v"):
        assert_bf16_close(tnew[0][key][:, :-1], jnew[0][key][:, :-1])
    np.testing.assert_array_equal(tnew[0]["pos"].numpy(), np.asarray(jnew[0]["pos"]))


# ---------------------------------------------------------------------------
# whole serves
# ---------------------------------------------------------------------------


def _prompts(group_seed: int):
    """The dense cross-check prompts of ``test_torch_serving.py`` plus a group
    of three sharing a 16-token prefix (one full block at bs 16)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=n).astype(np.int32) for n in (12, 8) * 4]
    rng = np.random.default_rng(group_seed)
    common = rng.integers(0, 128, size=16).astype(np.int32)
    return prompts + [np.concatenate([common, rng.integers(0, 128, size=n).astype(np.int32)])
                      for n in (3, 5, 3)]


@pytest.fixture(scope="module")
def engines():
    return engine_pair(THRESHOLD)


@pytest.fixture(scope="module")
def prompts():
    return _prompts(6)


def _serve(engine, prompts, seed=7, **kw):
    engine.rng = np.random.default_rng(seed)
    kw.setdefault("arrival_rate", 1e5)
    kw.setdefault("batch_size", 4)
    return engine.serve(prompts, gen_len=GEN, **kw)


def _by_rid(stats, values):
    return np.asarray(values)[np.argsort(stats.rids)]


def _assert_same_serve(got, want):
    assert got.sequences_by_rid() == want.sequences_by_rid()
    np.testing.assert_allclose(_by_rid(got, got.delays), _by_rid(want, want.delays), rtol=1e-9)
    s, w = got.summary(), want.summary()
    for key in ("num_batches", "num_forward_rows", "num_real_rows", "generated_tokens",
                "exit_histogram", "peak_in_flight", "prefix_hit_blocks", "prefix_total_blocks"):
        assert s[key] == w[key], key
    for key in ("block_occupancy_mean", "block_occupancy_peak"):
        np.testing.assert_allclose(s[key], w[key], rtol=1e-12, err_msg=key)
    assert got.block_occupancy == pytest.approx(want.block_occupancy, rel=1e-12)


def test_dense_serves_agree(engines, prompts):
    """The precondition of the paged comparison: on these prompts the port's
    dense serve already emits the jitted JAX engine's tokens and exits."""
    jeng, teng = engines
    _assert_same_serve(_serve(teng, prompts, decode_mode="cached"),
                       _serve(jeng, prompts, decode_mode="cached"))


@pytest.mark.parametrize(
    "kw",
    [{"block_size": bs, "prefix_sharing": sh} for bs in (1, 3, 16) for sh in (True, False)]
    + [{"block_size": 4, "num_slots": 4, "num_blocks": 16}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_paged_serve_matches_jax_engine(engines, prompts, kw):
    jeng, teng = engines
    want = _serve(jeng, prompts, cache_layout="paged", **kw)
    got = _serve(teng, prompts, cache_layout="paged", **kw)
    _assert_same_serve(got, want)
    if kw.get("prefix_sharing"):
        assert want.prefix_hit_blocks > 0


def test_paged_pool_too_small_raises(engines, prompts):
    for eng in engines:
        with pytest.raises(RuntimeError, match="block pool"):
            _serve(eng, prompts, cache_layout="paged", block_size=4, num_slots=2, num_blocks=4)


def test_paged_rejects_stateless_and_unknown_layouts(engines, prompts):
    _, teng = engines
    with pytest.raises(ValueError, match="paged"):
        _serve(teng, prompts, cache_layout="paged", decode_mode="stateless")
    with pytest.raises(ValueError, match="cache_layout"):
        _serve(teng, prompts, cache_layout="blocked")
    with pytest.raises(ValueError, match="block_size"):
        _serve(teng, prompts, cache_layout="paged", block_size=0)


@pytest.mark.parametrize("group_seed", [5, 6, 7])
def test_paged_equals_dense_equals_monolithic(engines, group_seed):
    """The port with itself: paged (sharing on and off, two block sizes) ==
    dense == the monolithic generator, every pool drained at the end, and no
    kernel launched on the CPU."""
    _, teng = engines
    prompts = _prompts(group_seed)
    reference = {
        i: (stage, tuple(toks))
        for i, p in enumerate(prompts)
        for toks, stage in [monolithic_generate(teng.programs.params, teng.cfg, p, teng.thresholds, GEN)]
    }
    counts = lambda: (texit.exit_confidence.launches, tdec.decode_attention.launches,  # noqa: E731
                      tpaged.paged_decode_attention.launches)
    n0 = counts()
    for kw in ({"block_size": 3}, {"block_size": 3, "prefix_sharing": False},
               {"block_size": 16, "num_slots": 3}):
        dense = _serve(teng, prompts, decode_mode="cached", num_slots=kw.get("num_slots"))
        assert dense.sequences_by_rid() == reference
        paged = _serve(teng, prompts, cache_layout="paged", **kw)
        assert paged.sequences_by_rid() == reference
        # the default pool never holds admission back, so the schedule is the dense one
        np.testing.assert_array_equal(_by_rid(paged, paged.delays), _by_rid(dense, dense.delays))
        assert paged.allocators and all(
            not a.live_handles() and not any(a.refcounts()) for a in paged.allocators.values()
        )
    assert counts() == n0


def test_launch_serve_paged_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--slots", "2", "--requests-per-slot", "4", "--gen-len", "3",
          "--batch-size", "2", "--cache-layout", "paged", "--block-size", "3"])
    out = capsys.readouterr().out
    assert out.count("prefix hits") == 2 and out.rstrip().endswith("done")
