"""The port's MoE and MLA blocks (deepseek-v2-lite-16b, reduced) against the
JAX package, module by module, stage by stage and as a whole serve.

Weights come from ``repro.models.model.init_params`` through the bridge;
inputs are numpy draws fed to both.  The JAX module and stage functions run
op by op (``jax.disable_jit``), as in ``test_torch_models.py``.  Tolerances:
f32 at 2e-5, bf16 results at rtol 1.6e-2 / atol 1e-2, expert choices, drops,
positions and tokens exact.

The whole serve is held in ``test_torch_deepseek_serving.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

from torch_port_common import F32_ATOL, as_np, assert_bf16_close, bridged_params

ARCH = "deepseek-v2-lite-16b"
S, B, MAX_LEN = 10, 3, 16


@pytest.fixture
def op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def bridged():
    return bridged_params(0, ARCH)


def _block(jparams, tparams, stage=0):
    return (jax.tree.map(lambda a: a[0], jparams["stages"][stage]["blocks"][0]),
            tmodel._period(tparams["stages"][stage]["blocks"][0], 0))


def _pair(a: np.ndarray, dtype=jnp.bfloat16):
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(tdt)


def _x(rng, shape, dtype=jnp.bfloat16):
    return _pair(rng.standard_normal(shape).astype(np.float32), dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _jax_dropped(params, x, dims):
    """Which (token, k) choices the reference drops: its router and ranks."""
    T = x.shape[0] * x.shape[1]
    logits = jnp.matmul(x.reshape(T, -1).astype(jnp.bfloat16),
                        params["router"].astype(jnp.bfloat16)).astype(jnp.float32)
    _, idx, _ = jmoe.router_probs(logits, dims)
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, dims.num_experts, dtype=jnp.int32)
    ranks = jax.lax.associative_scan(jnp.add, onehot, axis=0) - onehot
    rank = jnp.take_along_axis(ranks, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(idx), np.asarray(rank >= jmoe.capacity(T, dims))


@pytest.mark.parametrize("router_norm", ["softmax_topk", "topk_softmax"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_forward_matches(bridged, op_by_op, router_norm, capacity_factor):
    """Both router norms; at capacity factor 0.5, T * k > E * C forces drops."""
    jparams, tparams, jcfg, tcfg = bridged
    jblk, tblk = _block(jparams, tparams)
    jdims = dataclasses.replace(jcfg.moe, router_norm=router_norm, capacity_factor=capacity_factor)
    tdims = dataclasses.replace(tcfg.moe, router_norm=router_norm, capacity_factor=capacity_factor)
    rng = np.random.default_rng(11)
    jx, tx = _x(rng, (B, S, jcfg.d_model))
    jout, jaux = jmoe.moe_forward(jblk["moe"], jx, jdims)
    tout, taux = tmoe.moe_forward(tblk["moe"], tx, tdims)
    assert_bf16_close(tout, jout)
    np.testing.assert_allclose(float(taux), float(jaux), atol=F32_ATOL)

    T, k, E = B * S, tdims.top_k, tdims.num_experts
    C = tmoe.capacity(T, tdims)
    assert C == jmoe.capacity(T, jdims)
    want_idx, want_dropped = _jax_dropped(jblk["moe"], jx, jdims)
    logits = tmodel.layers.matmul(tx.reshape(T, -1), tblk["moe"]["router"]).float()
    _, idx, _ = tmoe.router_probs(logits, tdims)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    _, slot = tmoe.dispatch_slots(idx, C, E)
    np.testing.assert_array_equal((slot == C).numpy(), want_dropped)
    if capacity_factor < 1:
        assert T * k > E * C and want_dropped.any()


def test_moe_param_counts_match():
    from repro.configs import get_config as jget

    from repro_torch.configs import get_config as tget

    jm, tm = jget(ARCH).moe, tget(ARCH).moe
    assert tmoe.moe_active_params(tm) == jmoe.moe_active_params(jm)
    assert tmoe.moe_total_params(tm) == jmoe.moe_total_params(jm)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_cache(rng, batch, length, dims):
    c = rng.standard_normal((batch, length, dims.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((batch, length, dims.qk_rope_head_dim)).astype(np.float32)
    return c, kpe


def test_mla_forward_matches(bridged, op_by_op):
    jparams, tparams, jcfg, tcfg = bridged
    jblk, tblk = _block(jparams, tparams)
    rng = np.random.default_rng(12)
    jx, tx = _x(rng, (B, S, jcfg.d_model))
    pos = np.arange(S, dtype=np.int32)
    jout, (jc, jk) = jattn.mla_forward(jblk["attn"], jx, jcfg.mla, jnp.asarray(pos), 4,
                                       return_latent=True)
    tout, (tc, tk) = tattn.mla_forward(tblk["attn"], tx, tcfg.mla, torch.from_numpy(pos), 4,
                                       return_latent=True)
    assert_bf16_close(tout, jout)
    assert_bf16_close(tc, jc)
    assert_bf16_close(tk, jk)


def test_mla_decodes_match(bridged, op_by_op):
    """The scalar-position and the ragged decode against the reference's."""
    jparams, tparams, jcfg, tcfg = bridged
    jblk, tblk = _block(jparams, tparams, 1)
    dims = jcfg.mla
    rng = np.random.default_rng(13)
    jx, tx = _x(rng, (B, 1, jcfg.d_model))
    c, kpe = _mla_cache(rng, B, MAX_LEN, dims)
    pos = np.array([3, 9, 15], np.int32)
    jcache = {"c_kv": jnp.asarray(c, jnp.bfloat16), "k_pe": jnp.asarray(kpe, jnp.bfloat16),
              "pos": jnp.asarray(pos)}
    tcache = {"c_kv": torch.from_numpy(c).bfloat16(), "k_pe": torch.from_numpy(kpe).bfloat16(),
              "pos": torch.from_numpy(pos)}
    jout, jnew = jattn.mla_decode_ragged(jblk["attn"], jx, jcache, dims)
    tout, tnew = tattn.mla_decode_ragged(tblk["attn"], tx, tcache, tcfg.mla)
    assert tnew["c_kv"] is tcache["c_kv"]  # written in place
    assert_bf16_close(tout, jout)
    for key in ("c_kv", "k_pe"):
        assert_bf16_close(tnew[key], jnew[key])
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))

    jcache1 = dict(jcache, pos=jnp.asarray(7, jnp.int32))
    tcache1 = {"c_kv": torch.from_numpy(c).bfloat16(), "k_pe": torch.from_numpy(kpe).bfloat16(),
               "pos": torch.tensor(7, dtype=torch.int32)}
    jout1, jnew1 = jattn.mla_decode(jblk["attn"], jx, jcache1, dims)
    tout1, tnew1 = tattn.mla_decode(tblk["attn"], tx, tcache1, tcfg.mla)
    assert_bf16_close(tout1, jout1)
    for key in ("c_kv", "k_pe"):
        assert_bf16_close(tnew1[key], jnew1[key])
    assert int(tnew1["pos"]) == int(jnew1["pos"]) == 8


def test_mla_decode_paged_matches_reference_and_ragged(bridged, op_by_op):
    """Paged against the reference's paged decode, and bitwise the port's
    ragged decode on the same rows at block size 3 (a padded row past its
    table writes to the trash block, as in the GQA paged decode)."""
    jparams, tparams, jcfg, tcfg = bridged
    jblk, tblk = _block(jparams, tparams, 1)
    dims = jcfg.mla
    rng = np.random.default_rng(14)
    bs, n_logical, seq_len = 3, 5, 14
    NB = B * n_logical + 1
    trash = NB - 1
    perm = rng.permutation(NB - 1)
    table = np.full((B, n_logical), trash, np.int32)
    pos = np.array([9, 4, n_logical * bs + 1], np.int32)  # row 2: past its table
    for b in range(2):
        used = pos[b] // bs + 1
        table[b, :used] = perm[b * n_logical: b * n_logical + used]
    c, kpe = _mla_cache(rng, NB, bs, dims)
    jx, tx = _x(rng, (B, 1, jcfg.d_model))
    jcache = {"c_kv": jnp.asarray(c, jnp.bfloat16), "k_pe": jnp.asarray(kpe, jnp.bfloat16),
              "pos": jnp.asarray(pos), "table": jnp.asarray(table)}
    tcache = {"c_kv": torch.from_numpy(c).bfloat16(), "k_pe": torch.from_numpy(kpe).bfloat16(),
              "pos": torch.from_numpy(pos), "table": torch.from_numpy(table)}
    # the rows the ragged decode sees: each row's blocks gathered, before the write
    dense = {key: tcache[key][tcache["table"].long()].reshape(B, n_logical * bs, -1)[:, :seq_len].clone()
             for key in ("c_kv", "k_pe")}
    jout, jnew = jattn.mla_decode_paged(jblk["attn"], jx, jcache, dims, seq_len)
    tout, tnew = tattn.mla_decode_paged(tblk["attn"], tx, tcache, tcfg.mla, seq_len)
    assert_bf16_close(tout[:2], jout[:2])  # row 2 is a padded row's, discarded
    for key in ("c_kv", "k_pe"):
        assert_bf16_close(tnew[key][:-1], jnew[key][:-1])
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))

    rout, _ = tattn.mla_decode_ragged(tblk["attn"], tx[:2], dict(
        {key: t[:2].contiguous() for key, t in dense.items()}, pos=torch.from_numpy(pos[:2])),
        tcfg.mla)
    assert torch.equal(tout[:2], rout)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def test_prefill_and_decode_stages_match(bridged, op_by_op):
    """prefill_stage, then one ragged token, then one paged token through the
    same stage, each against the reference's stage function."""
    jparams, tparams, jcfg, tcfg = bridged
    rng = np.random.default_rng(15)
    stage = 2
    jx, tx = _x(rng, (B, S, jcfg.d_model))
    jout, jcaches = jmodel.prefill_stage(jparams, stage, jx, jcfg, MAX_LEN)
    tout, tcaches = tmodel.prefill_stage(tparams, stage, tx, tcfg, MAX_LEN)
    assert_bf16_close(tout, jout)
    assert set(tcaches[0]) == set(jcaches[0]) == {"c_kv", "k_pe", "pos"}
    for key in ("c_kv", "k_pe"):
        assert_bf16_close(tcaches[0][key], jcaches[0][key])
    np.testing.assert_array_equal(tcaches[0]["pos"].numpy(), np.asarray(jcaches[0]["pos"]))

    P = jcfg.stage_periods()[stage - 1]
    pos = np.broadcast_to(np.array([S, S - 3, S - 1], np.int32), (P, B)).copy()
    jstep, tstep = _x(rng, (B, 1, jcfg.d_model))
    jy, jnew = jmodel.decode_stage_ragged(jparams, stage, jstep, (dict(jcaches[0], pos=jnp.asarray(pos)),),
                                          jcfg)
    ty, tnew = tmodel.decode_stage_ragged(tparams, stage, tstep,
                                          (dict(tcaches[0], pos=torch.from_numpy(pos)),), tcfg)
    assert_bf16_close(ty, jy)
    for key in ("c_kv", "k_pe"):
        assert_bf16_close(tnew[0][key], jnew[0][key])
    np.testing.assert_array_equal(tnew[0]["pos"].numpy(), np.asarray(jnew[0]["pos"]))

    # the same stage through a paged pool: period p's latent rows cut into
    # blocks of 4, row b's logical block j at pool block b * 4 + j
    bs, n_logical, seq_len = 4, MAX_LEN // 4, MAX_LEN
    tables = np.arange(B * n_logical, dtype=np.int32).reshape(B, n_logical)
    pool_np = {key: np.concatenate([as_np(tnew[0][key]).reshape(P, B * n_logical, bs, -1),
                                    np.zeros((P, 1, bs, tnew[0][key].shape[-1]), np.float32)], 1)
               for key in ("c_kv", "k_pe")}
    pos2 = np.array(jnew[0]["pos"])
    jstep, tstep = _x(rng, (B, 1, jcfg.d_model))
    jpool = ({key: jnp.asarray(a, jnp.bfloat16) for key, a in pool_np.items()},)
    tpool = ({key: torch.from_numpy(a).bfloat16() for key, a in pool_np.items()},)
    jy, jp = jmodel.decode_stage_paged(jparams, stage, jstep, jpool, ({"pos": jnp.asarray(pos2)},),
                                       jnp.asarray(tables), jcfg, seq_len)
    ty, tp = tmodel.decode_stage_paged(tparams, stage, tstep, tpool, ({"pos": torch.from_numpy(pos2)},),
                                       torch.from_numpy(tables), tcfg, seq_len)
    assert_bf16_close(ty, jy)
    for key in ("c_kv", "k_pe"):
        assert_bf16_close(tp[0][key], jp[0][key])
    np.testing.assert_array_equal(tp[0]["pos"].numpy(), np.asarray(jp[0]["pos"]))


def test_paged_caches_hold_the_latent_leaves():
    from repro.configs import get_config as jget

    from repro_torch.configs import get_config as tget

    jcfg, tcfg = jget(ARCH).reduced(vocab_size=128), tget(ARCH).reduced(vocab_size=128)
    jpool, jstate = jmodel.init_stage_paged_caches(jcfg, 1, 3, 7, 4, 12)
    tpool, tstate = tmodel.init_stage_paged_caches(tcfg, 1, 3, 7, 4, 12, device="cpu")
    for jd, td in zip(jpool + jstate, tpool + tstate):
        assert {k: v.shape for k, v in jd.items()} == {k: tuple(v.shape) for k, v in td.items()}
    jslot = jmodel.init_stage_slot_caches(jcfg, 1, 3, 12)
    tslot = tmodel.init_stage_slot_caches(tcfg, 1, 3, 12, device="cpu")
    assert {k: v.shape for k, v in jslot[0].items()} == {k: tuple(v.shape) for k, v in tslot[0].items()}
    assert tmodel.PAGED_CACHE_LEAVES == jmodel.PAGED_CACHE_LEAVES
