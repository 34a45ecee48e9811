"""The port's config, layers, attention and staged model vs the JAX package.

Weights come from ``repro.models.model.init_params`` through the bridge;
inputs are numpy draws fed to both.  Tolerances: f32 math at 2e-5; bf16
results at rtol 1.6e-2 / atol 1e-2 (the frameworks round bf16 at different
places); tokens exact.

The stage-level JAX functions run op by op here (``jax.disable_jit``; their
``lax.scan`` over periods otherwise compiles): each op then rounds its bf16
result, as the port's eager ops do.  Compiled, the CPU backend keeps some
bf16 intermediates in f32 across a fusion (a residual sum feeding the next
norm, a QKV product feeding its bias), which moves single bf16 ulps that
cancellation can turn into more than the tolerance; the whole-slice test in
``test_torch_serving.py`` runs the jitted JAX engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

from torch_port_common import F32_ATOL, as_np, assert_bf16_close, bridged_params, step_batch

S, B, MAX_LEN = 10, 3, 16
# reduced: stablelm-1.6b MHA, hd 32, LayerNorm; glm4-9b G 2, hd 32, RMSNorm;
# internlm2-20b and qwen2.5-32b 4 query heads over 4 KV heads (qwen with
# QKV bias); deepseek-v2-lite-16b MLA attention and an MoE FFN of 8 experts;
# zamba2-2.7b five Mamba2 blocks and a dense attention block per period;
# xlstm-350m an mLSTM and an sLSTM block per period; mixtral-8x7b an MoE of
# 8 experts top-2 and a sliding window of 32 (beyond MAX_LEN: full caches
# here, the ring in test_torch_batched_steps.py); phi-3-vision-4.2b and
# musicgen-medium embeddings in (musicgen: LayerNorm, the tanh-gelu MLP)
GQA_ARCHS = ("stablelm-1.6b", "glm4-9b", "internlm2-20b", "qwen2.5-32b")
ARCHS = GQA_ARCHS + ("deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-350m", "mixtral-8x7b",
                     "phi-3-vision-4.2b", "musicgen-medium")


@pytest.fixture
def op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    return bridged_params(0, request.param)


@pytest.fixture(scope="module", params=GQA_ARCHS)
def gqa_bridged(request):
    return bridged_params(0, request.param)


def _seq_leaf(caches) -> str:
    """The first cache leaf of a stage's first block: ``k``, MLA's ``c_kv``,
    or a recurrent block's state (Mamba's ``ssd``, mLSTM's ``C``)."""
    return next(k for k in ("k", "c_kv", "ssd", "C") if k in caches[0])


XLSTM_NORM_TOL = 2.0 ** -8


def _norm_gap(got, want) -> float:
    g, w = as_np(got), as_np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _assert_stage_close(cfg, got, want):
    """A stage output or cache leaf after several layers: at the bf16
    tolerance, or, for xLSTM (``slstm`` in the period), norm-wise at 2^-8.
    There the two frameworks' f32 sums in another order flip single bf16
    roundings (each block alone agrees element-wise on fresh inputs,
    ``test_torch_ssm.py``), and the random-weight sLSTM recurrence
    amplifies such a flip (``r_gates`` at std 1/sqrt(H) = 0.5 over P = 32
    inputs: the recurrent product's std is 2.8 times h's).  Measured: the
    sound port reads 2.1e-3 and 2.4e-3 on stage 2's outputs and at most
    3.1e-3 on the monolithic check's state leaf; the control, ``r_gates``
    rounded to bf16, reads 4.0e-3, 4.8e-3 and 4.7e-3 / 7.4e-3 there
    (``test_xlstm_stage_tolerance_rejects_r_gates_in_bf16``)."""
    if "slstm" not in cfg.period:
        assert_bf16_close(got, want)
        return
    assert _norm_gap(got, want) <= XLSTM_NORM_TOL


def _caches_to_torch(caches):
    """A JAX cache tree as the port's: bf16, f32 and int32 leaves kept."""
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32, jnp.int32: torch.int32}

    def leaf(a):
        a = jnp.asarray(a)
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtypes[a.dtype.type])

    return [tuple({k: leaf(v) for k, v in c.items()} for c in stage) for stage in caches]


def _glu(block):
    """A block's GLU FFN (or MLP FFN, under ``ffn="mlp"``): an attention
    block's, an MoE block's shared experts, or an sLSTM block's; None for a
    block without one."""
    for path in (("ffn",), ("moe", "shared"), ("slstm", "ffn")):
        sub = block
        for key in path:
            sub = sub.get(key) if isinstance(sub, dict) else None
        if sub is not None:
            return sub
    return None


def _block(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _x(rng, shape, dtype=jnp.bfloat16):
    a = rng.standard_normal(shape).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced, arch):
    from repro.configs import get_config

    jcfg = get_config(arch)
    tcfg = tconfigs.get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(vocab_size=128), tcfg.reduced(vocab_size=128)
    for f in dataclasses.fields(tcfg):
        if f.name in ("moe", "mla", "mamba", "xlstm"):  # the port's own dims classes
            want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
            assert (got is None) == (want is None), f.name
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        elif f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.bfloat16
    assert tcfg.stage_periods() == jcfg.stage_periods()
    assert tcfg.uses_attention == jcfg.uses_attention
    assert dataclasses.asdict(tcfg.attn_dims()) == dataclasses.asdict(jcfg.attn_dims())
    if reduced:  # the reference counts through jax.eval_shape; cheap only when reduced
        for active in (False, True):
            assert tcfg.param_count(active_only=active) == jcfg.param_count(active_only=active)


@pytest.mark.parametrize("arch,lo,hi", [
    ("mixtral-8x7b", 45e9, 48e9),
    ("phi-3-vision-4.2b", 3.5e9, 4.5e9),
    ("musicgen-medium", 1.2e9, 1.7e9),
    ("deepseek-v2-lite-16b", 15.5e9, 16.5e9),
    ("internlm2-20b", 19e9, 21e9),
    ("qwen2.5-32b", 31e9, 34e9),
    ("zamba2-2.7b", 2.4e9, 3.2e9),
    ("xlstm-350m", 0.3e9, 0.5e9),
])
def test_param_counts_match_claimed_scale(arch, lo, hi):
    """The port's analogue of ``tests/test_models_smoke.py``'s scale check,
    counted on the meta device (nothing allocated)."""
    n = tconfigs.get_config(arch).param_count()
    assert lo <= n <= hi, n
    if arch.startswith("deepseek"):  # MoE: 6 of 64 routed experts active per token
        assert 2e9 <= tconfigs.get_config(arch).param_count(active_only=True) <= 3e9


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_profiles_match_reference(arch):
    """Per-stage parameter counts (MoE stages charged their active
    parameters, MLA its latent projections) and the DTO-EE profile built
    from them, at full width, equal the reference's."""
    from repro.configs import get_config
    from repro.core import profiles as jprofiles

    from repro_torch.core import profiles as tprofiles

    jcfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    assert tprofiles.stage_param_counts(tcfg) == jprofiles.stage_param_counts(jcfg)
    assert (dataclasses.asdict(tprofiles.profile_from_arch(tcfg))
            == dataclasses.asdict(jprofiles.profile_from_arch(jcfg)))


@pytest.mark.parametrize("change", [
    {"period": ("mamba",)},
    {"period": ("mlstm", "slstm")},
    {"period": ("dense_attn",)},
    {"sliding_window": 64},
    {"ffn": "mlp"},
    {"frontend": "embeds"},
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_unported_kinds_raise(change):
    """Every option of the reference builds in the port (none raises
    NotImplementedError any more).  The recurrent kinds and ``dense_attn``
    build with their dims (those of zamba2-2.7b and xlstm-350m), and a
    recurrent period without its dims is a ValueError naming them, as a
    ``moe_attn`` period without moe dims is.  A sliding window, the MLP FFN
    (``act="gelu"``) and the embeds frontend each build, and one reduced
    prefill runs with it: the window leaves a ring of its 32 slots past
    ``max_len``, the MLP block holds ``w_up``/``w_down`` alone, and the
    embeds model has no table and takes ``{"embeds": [B, S, d]}``."""
    cfg = tconfigs.get_config("stablelm-1.6b")
    period = change.get("period")
    if period is None:
        if change.get("ffn") == "mlp":
            change = dict(change, act="gelu")
        built = dataclasses.replace(cfg, **change).reduced(vocab_size=128)
        params = tmodel.init_params(built, torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(0)
        _, batch = step_batch(built, rng, 2, 40)
        max_len = 48
        tok, conf, etok, caches = tmodel.prefill(params, batch, built, max_len)
        assert tok.shape == (2,) and conf.shape == (2, len(built.exit_stages))
        assert bool(torch.all((conf >= 0) & (conf <= 1)))
        cache = caches[0][0]
        if "sliding_window" in change:
            assert built.sliding_window == 32 and cache["k"].shape[2] == 32
            assert sorted(cache["slot_pos"][0].tolist()) == list(range(8, 40))
        else:
            assert "slot_pos" not in cache and cache["k"].shape[2] == max_len
        if "ffn" in change:
            assert set(params["stages"][0]["blocks"][0]["ffn"]) == {"w_up", "w_down"}
        assert ("embed" in params) == ("frontend" not in change)
        return
    dims = {"mamba": tconfigs.get_config("zamba2-2.7b").mamba,
            "xlstm": tconfigs.get_config("xlstm-350m").xlstm}
    need = {"mamba": "mamba", "mlstm": "xlstm", "slstm": "xlstm"}
    wanted = {need[k] for k in period if k in need}
    built = dataclasses.replace(cfg, period=period, **{k: dims[k] for k in wanted})
    assert built.period == period
    for k in wanted:
        with pytest.raises(ValueError, match=f"needs {k} dims"):
            dataclasses.replace(cfg, period=period, **{o: dims[o] for o in wanted - {k}})


def test_unknown_kind_and_moe_without_dims_raise():
    cfg = tconfigs.get_config("stablelm-1.6b")
    with pytest.raises(ValueError, match="unknown block kind"):
        dataclasses.replace(cfg, period=("conv",))
    with pytest.raises(ValueError, match="moe dims"):
        dataclasses.replace(cfg, period=("moe_attn",))


def test_init_params_tree_matches_reference(bridged):
    jparams, _, jcfg, tcfg = bridged
    tparams = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(tparams)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == [
        jax.tree_util.keystr(p) for p, _ in tleaves
    ]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape), jax.tree_util.keystr(path)
        name = jax.tree_util.keystr(path).split("'")[-2]
        want = torch.bfloat16 if name in tmodel.BF16_LEAVES else torch.float32
        assert t.dtype == want, jax.tree_util.keystr(path)
    # truncated normal at +-3 std with std 1/sqrt(fan_in)
    w = tparams["lm_head"].float()
    std = 1.0 / np.sqrt(tcfg.d_model)
    assert float(w.abs().max()) <= 3 * std * 1.01
    assert abs(float(w.std()) / std - 0.986) < 0.05


def test_bridge_casts_weights_once(bridged):
    jparams, tparams, _, _ = bridged
    jblk, tblk = jparams["stages"][1]["blocks"][0], tparams["stages"][1]["blocks"][0]
    sub, name = next((s, n) for s, n in (("attn", "w_q"), ("mamba", "in_proj"), ("mlstm", "up_proj"))
                     if s in jblk)
    np.testing.assert_array_equal(as_np(tblk[sub][name]), as_np(jblk[sub][name].astype(jnp.bfloat16)))
    np.testing.assert_array_equal(
        tparams["final_norm"]["scale"].numpy(), np.asarray(jparams["final_norm"]["scale"])
    )


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms_match(norm, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, (4, 7, 64), dtype)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    want = jlayers.apply_norm(norm, jp, jx)
    got = tlayers.apply_norm(norm, tp, tx)
    if dtype == jnp.float32:
        np.testing.assert_allclose(as_np(got), as_np(want), atol=F32_ATOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rope_matches(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, (2, 9, 4, 32), dtype)
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e4)
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), 1e4)
    if dtype == jnp.float32:
        np.testing.assert_allclose(as_np(got), as_np(want), atol=F32_ATOL * 10)
    else:
        assert_bf16_close(got, want)


def test_silu_glu_embed_matmul_match(bridged):
    """The FFN: the GLU (an MoE block's shared experts under deepseek; an
    MoE without shared experts, mixtral's, has none here), or the tanh-gelu
    MLP under ``ffn="mlp"`` (musicgen); the embedding table where the
    frontend has one."""
    jparams, tparams, jcfg, _ = bridged
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, (3, 5, 128))
    assert_bf16_close(tlayers.silu(tx), jax.nn.silu(jx))
    j = next((j for j, b in enumerate(jparams["stages"][0]["blocks"]) if _glu(b) is not None), None)
    if j is not None:
        jblk = _block(jparams["stages"][0]["blocks"][j])
        tblk = tmodel._period(tparams["stages"][0]["blocks"][j], 0)
        jffn, tffn = _glu(jblk), _glu(tblk)
        if jcfg.ffn == "mlp":
            assert_bf16_close(tlayers.mlp_ffn(tffn, tx, jcfg.act), jlayers.mlp_ffn(jffn, jx, jcfg.act))
        else:
            assert_bf16_close(tlayers.glu_ffn(tffn, tx), jlayers.glu_ffn(jffn, jx))
        assert_bf16_close(tlayers.matmul(tx, tffn["w_up"]), jlayers.matmul(jx, jffn["w_up"]))
    else:
        assert jcfg.moe is not None and jcfg.moe.num_shared == 0
    if jcfg.frontend != "tokens":
        assert "embed" not in jparams and "embed" not in tparams
        return
    toks = rng.integers(0, 128, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        as_np(tlayers.embed(tparams["embed"], torch.from_numpy(toks).long())),
        as_np(jlayers.embed(jparams["embed"], jnp.asarray(toks))),
    )


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def test_gqa_forward_matches(gqa_bridged):
    jparams, tparams, jcfg, tcfg = gqa_bridged
    rng = np.random.default_rng(3)
    jx, tx = _x(rng, (B, S, jcfg.d_model))
    jp = _block(jparams["stages"][0]["blocks"][0])["attn"]
    tp = tmodel._period(tparams["stages"][0]["blocks"][0], 0)["attn"]
    pos = np.arange(S, dtype=np.int32)
    jout, (jk, jv) = jattn.gqa_forward(jp, jx, jcfg.attn_dims(), jnp.asarray(pos), 4, return_kv=True)
    tout, (tk, tv) = tattn.gqa_forward(tp, tx, tcfg.attn_dims(), torch.from_numpy(pos), 4, return_kv=True)
    assert_bf16_close(tout, jout)
    assert_bf16_close(tk, jk)
    assert_bf16_close(tv, jv)


def test_gqa_decode_ragged_and_scalar_match(gqa_bridged):
    jparams, tparams, jcfg, tcfg = gqa_bridged
    rng = np.random.default_rng(4)
    dims_j, dims_t = jcfg.attn_dims(), tcfg.attn_dims()
    jp = _block(jparams["stages"][1]["blocks"][0])["attn"]
    tp = tmodel._period(tparams["stages"][1]["blocks"][0], 0)["attn"]
    jx, tx = _x(rng, (B, 1, jcfg.d_model))
    kc = rng.standard_normal((B, MAX_LEN, dims_j.num_kv_heads, dims_j.head_dim)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos = np.array([3, 9, 15], np.int32)
    jc = {"k": jnp.asarray(kc, jnp.bfloat16), "v": jnp.asarray(vc, jnp.bfloat16), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(kc).bfloat16(), "v": torch.from_numpy(vc).bfloat16(),
          "pos": torch.from_numpy(pos)}
    jout, jnew = jax.jit(jattn.gqa_decode_ragged, static_argnums=3)(jp, jx, jc, dims_j)
    tout, tnew = tattn.gqa_decode_ragged(tp, tx, tc, dims_t)
    assert_bf16_close(tout, jout)
    assert_bf16_close(tnew["k"], jnew["k"])
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    # scalar position: the monolithic decode
    jc1 = dict(jc, pos=jnp.asarray(7, jnp.int32))
    tc1 = {"k": torch.from_numpy(kc).bfloat16(), "v": torch.from_numpy(vc).bfloat16(),
           "pos": torch.tensor(7, dtype=torch.int32)}
    jout1, jnew1 = jax.jit(jattn.gqa_decode, static_argnums=3)(jp, jx, jc1, dims_j)
    tout1, tnew1 = tattn.gqa_decode(tp, tx, tc1, dims_t)
    assert_bf16_close(tout1, jout1)
    assert_bf16_close(tnew1["v"], jnew1["v"])
    assert int(tnew1["pos"]) == int(jnew1["pos"]) == 8


def test_cache_write_ragged_matches_masked_select():
    """The in-place index_put_ writes what the reference's masked select
    writes, including rows whose slot lies past the buffer (left unchanged)."""
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    slots = np.array([0, 5, 9], np.int32)
    want = jattn._cache_write_ragged(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(slots))
    tbuf = torch.from_numpy(buf.copy())
    tattn._cache_write_ragged(tbuf, torch.from_numpy(new), torch.from_numpy(slots))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tbuf[2].numpy(), buf[2])


# ---------------------------------------------------------------------------
# stages, heads, monolithic generation
# ---------------------------------------------------------------------------


def test_prefill_and_ragged_decode_stage_match(bridged, op_by_op):
    jparams, tparams, jcfg, tcfg = bridged
    rng = np.random.default_rng(6)
    jx, tx = _x(rng, (B, S, jcfg.d_model))
    for stage in (2,):
        jout, jcaches = jmodel.prefill_stage(jparams, stage, jx, jcfg, MAX_LEN)
        tout, tcaches = tmodel.prefill_stage(tparams, stage, tx, tcfg, MAX_LEN)
        _assert_stage_close(tcfg, tout, jout)
        leaf = _seq_leaf(tcaches)
        _assert_stage_close(tcfg, tcaches[0][leaf], jcaches[0][leaf])
        np.testing.assert_array_equal(tcaches[0]["pos"].numpy(), np.asarray(jcaches[0]["pos"]))
        # one ragged token against the prefilled caches, per-row positions
        jstep, tstep = _x(rng, (B, 1, jcfg.d_model))
        P = jcaches[0]["pos"].shape[0]
        pos = np.broadcast_to(np.array([S, S, S], np.int32), (P, B)).copy()
        jc = tuple(dict(c, pos=jnp.asarray(pos)) for c in jcaches)
        tc = tuple(dict(c, pos=torch.from_numpy(pos)) for c in tcaches)
        jy, jnew = jmodel.decode_stage_ragged(jparams, stage, jstep, jc, jcfg)
        ty, tnew = tmodel.decode_stage_ragged(tparams, stage, tstep, tc, tcfg)
        _assert_stage_close(tcfg, ty, jy)
        _assert_stage_close(tcfg, tnew[0][leaf], jnew[0][leaf])
        np.testing.assert_array_equal(tnew[0]["pos"].numpy(), np.asarray(jnew[0]["pos"]))


def test_heads_match(bridged):
    jparams, tparams, jcfg, tcfg = bridged
    rng = np.random.default_rng(7)
    jx, tx = _x(rng, (4, 1, jcfg.d_model))
    for stage in jcfg.exit_stages:
        jc, jt = jmodel.exit_confidence(jparams, jx, stage, jcfg)
        tc, tt = tmodel.exit_confidence(tparams, tx, stage, tcfg)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jc, jt = jmodel.final_confidence(jparams, jx, jcfg)
    tc, tt = tmodel.final_confidence(tparams, tx, tcfg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _monolithic_steps(jparams, tparams, jcfg, tcfg):
    """Prefill and two decode steps of both packages on one seeded batch
    (tokens, or embeddings under ``frontend="embeds"``), yielding (port, JAX) of (next tokens, head tokens, confidences,
    caches) per call; read each before the next (the port's decode updates
    its caches in place).  For xLSTM each decode step starts from the reference's
    caches, so that one step's differences are held, not the amplified ones
    of the steps before (``_assert_stage_close``)."""
    rng = np.random.default_rng(8)
    jbatch, tbatch = step_batch(jcfg, rng, B, S)
    j = jmodel.prefill(jparams, jbatch, jcfg, MAX_LEN)
    t = tmodel.prefill(tparams, tbatch, tcfg, MAX_LEN)
    yield t, j
    for _ in range(2):
        tcaches = _caches_to_torch(j[3]) if "slstm" in tcfg.period else t[3]
        jbatch, tbatch = step_batch(jcfg, rng, B, 1, np.array(j[0])[:, None])
        j = jmodel.decode_step(jparams, jbatch, j[3], jcfg)
        t = tmodel.decode_step(tparams, tbatch, tcaches, tcfg)
        yield t, j


def test_monolithic_prefill_and_decode_step_match(bridged, op_by_op):
    jparams, tparams, jcfg, tcfg = bridged
    for n, (t, j) in enumerate(_monolithic_steps(jparams, tparams, jcfg, tcfg)):
        (tn, tconf, ttok, tcaches), (jn, jconf, jtok, jcaches) = t, j
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert_bf16_close(tconf, jconf)
        if n:
            leaf = _seq_leaf(tcaches[3])
            _assert_stage_close(tcfg, tcaches[3][0][leaf], jcaches[3][0][leaf])


def test_xlstm_stage_tolerance_rejects_r_gates_in_bf16(op_by_op):
    """The control for ``_assert_stage_close``'s xLSTM limit: the port's
    sLSTM recurrent weights rounded to bf16 (the reference keeps them f32
    and casts them to the f32 state's dtype, ``ssm.py:523``) move the
    monolithic check's state leaf past 2^-8."""
    jparams, tparams, jcfg, tcfg = bridged_params(0, "xlstm-350m")

    def rounded(tree):
        if isinstance(tree, dict):
            return {k: (v.bfloat16().float() if k == "r_gates" else rounded(v)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rounded(v) for v in tree)
        return tree

    gaps = []
    for n, (t, j) in enumerate(_monolithic_steps(jparams, rounded(tparams), jcfg, tcfg)):
        if n:
            leaf = _seq_leaf(t[3][3])
            gaps.append(_norm_gap(t[3][3][0][leaf], j[3][3][0][leaf]))
    assert max(gaps) > XLSTM_NORM_TOL, gaps