"""The port's kernel modules on the CPU vs the JAX package's kernels.

On a CPU tensor each wrapper runs its plain version; the same numpy inputs
go through ``repro.kernels`` (its ``xla`` oracle, and the Pallas bodies in
interpret mode for a subset).  Tolerances follow ``tests/test_kernels.py``:
decode attention f32 2e-5 and bf16 2e-2; exit confidence 1e-3 on conf with
an exact argmax, on inputs built with a clear top-1 margin.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.exit_confidence import exit_confidence as pallas_exit
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import exit_confidence as texit
from repro_torch.kernels import ops, ref

import torch_port_common  # noqa: F401  (one CPU thread for the port's ops)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    (2, 300, 8, 2, 64),
    (1, 512, 4, 4, 128),
    (3, 1000, 16, 4, 64),  # ragged lengths below
    (2, 300, 4, 4, 32),
    (2, 300, 10, 2, 128),  # G 5: qwen2.5-32b's 40 query heads over 8
    (2, 300, 12, 2, 128),  # G 6: internlm2-20b's 48 over 8
    (2, 300, 8, 8, 80),  # zamba2-2.7b's head dim, G 1
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,KVH,hd", DECODE_CASES)
def test_decode_attention_matches_jax(dtype, B, S, Hq, KVH, hd):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((B, Hq, hd)).astype(np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, S, KVH, hd)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, S, KVH, hd)).astype(np.float32), dtype)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    got = tdec.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == TDT[dtype] and got.shape == (B, Hq, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("B,S,Hq,KVH,hd,block", [(2, 300, 8, 2, 64, 64), (1, 256, 4, 4, 32, 128),
                                                (2, 300, 10, 2, 128, 64), (1, 256, 12, 2, 128, 128),
                                                (2, 300, 8, 8, 80, 64)])
def test_decode_attention_matches_pallas_body(B, S, Hq, KVH, hd, block):
    """The plain version against the Pallas kernel body (interpret mode)."""
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng.standard_normal((B, Hq, hd)).astype(np.float32), "float32")
    jk, tk = _pair(rng.standard_normal((B, S, KVH, hd)).astype(np.float32), "float32")
    jv, tv = _pair(rng.standard_normal((B, S, KVH, hd)).astype(np.float32), "float32")
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    want = pallas_decode(jq, jk, jv, jnp.asarray(lengths), block_k=block, interpret=True)
    got = tdec.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])


@pytest.mark.parametrize("dtype,block", [("float32", 64), ("bfloat16", 512)])
def test_decode_attention_f32_scores_ref_matches_pallas_body(dtype, block):
    """The f32-score plain version against the Pallas body: f32 inputs over
    several KV blocks at 2e-5; bf16 inputs over one block within two output
    ulps (one for the output's rounding, one for the body's bf16 cast of the
    probabilities), with a length-0 row."""
    B, S, Hq, KVH, hd = 3, 300, 8, 2, 64
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng.standard_normal((B, Hq, hd)).astype(np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, S, KVH, hd)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, S, KVH, hd)).astype(np.float32), dtype)
    lengths = np.array([S, 0, 117], dtype=np.int32)
    want = pallas_decode(jq, jk, jv, jnp.asarray(lengths), block_k=block, interpret=True)
    got = ref.decode_attention_f32_scores_ref(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == TDT[dtype] and not bool(got[1].any())
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2**-7, atol=2**-9)


def test_decode_attention_padded_rows_and_lengths_past_cache():
    """Rows are independent; a length past S reads the whole cache (the
    engine's trash slot can run past ``max_len``)."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((3, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 40, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 40, 2, 32)).astype(np.float32))
    out = tdec.decode_attention(q, k, v, torch.tensor([5, 40, 99], dtype=torch.int32))
    one = tdec.decode_attention(q[:1], k[:1], v[:1], torch.tensor([5], dtype=torch.int32))
    torch.testing.assert_close(out[:1], one, rtol=0, atol=0)
    full = tdec.decode_attention(q[2:], k[2:], v[2:], torch.tensor([40], dtype=torch.int32))
    torch.testing.assert_close(out[2:], full, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# exit confidence
# ---------------------------------------------------------------------------

EXIT_CASES = [(4, 64, 1000), (8, 128, 2048), (3, 32, 513), (1, 16, 257), (5, 16, 130),
              (7, 32, 64), (6, 16, 127)]


def _margin_inputs(rng, B, d, V):
    """h, w whose exact top-1 logit beats the runner-up by a clear margin."""
    h = rng.standard_normal((B, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    targets = rng.choice(V, size=B, replace=False) if B <= V else rng.integers(0, V, B)
    for b, t in enumerate(targets):
        w[:, t] += 3.0 * h[b] / np.linalg.norm(h[b])
    hb = jnp.asarray(h, jnp.bfloat16).astype(jnp.float32)
    wb = jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)
    logits = np.asarray(hb, np.float64) @ np.asarray(wb, np.float64)
    top2 = np.sort(logits, axis=1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 0.05), "inputs lack a clear top-1 margin"
    return h, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,d,V", EXIT_CASES)
def test_exit_confidence_matches_jax(dtype, B, d, V):
    h, w = _margin_inputs(np.random.default_rng(3), B, d, V)
    jh, th = _pair(h, dtype)
    jw, tw = _pair(w, dtype)
    cref, iref = jref.exit_confidence_ref(jh, jw)
    conf, idx = texit.exit_confidence(th, tw)
    assert conf.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_allclose(conf.numpy(), np.asarray(cref), atol=1e-3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(iref))


@pytest.mark.parametrize("B,d,V,bb,bv", [(4, 64, 1000, 4, 256), (5, 16, 130, 4, 64)])
def test_exit_confidence_matches_pallas_body(B, d, V, bb, bv):
    h, w = _margin_inputs(np.random.default_rng(4), B, d, V)
    jh, th = _pair(h, "bfloat16")
    jw, tw = _pair(w, "bfloat16")
    cp, ip = pallas_exit(jh, jw, block_b=bb, block_v=bv, interpret=True)
    conf, idx = texit.exit_confidence(th, tw)
    np.testing.assert_allclose(conf.numpy(), np.asarray(cp), atol=1e-3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ip))


def test_exit_confidence_tie_takes_first_index():
    """Two equal top logits (identical columns): both packages pick the first."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 300)).astype(np.float32) * 0.1
    col = 4.0 * h.sum(axis=0) / np.linalg.norm(h.sum(axis=0))
    w[:, 17] = col
    w[:, 260] = col  # the same logits, in another vocab tile of the reference kernel
    for dtype in ("float32", "bfloat16"):
        jh, th = _pair(h, dtype)
        jw, tw = _pair(w, dtype)
        _, iref = jref.exit_confidence_ref(jh, jw)
        _, ipal = pallas_exit(jh, jw, block_b=8, block_v=128, interpret=True)
        _, idx = texit.exit_confidence(th, tw)
        assert np.all(np.asarray(iref) == 17) and np.all(np.asarray(ipal) == 17)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(iref))


# ---------------------------------------------------------------------------
# the decode walk's split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 1, 31, 32, 511, 512, 513, 1024, 1100, 4096, 4097])
def test_split_plan_tiles_the_row_and_depends_on_its_length_alone(length):
    """The walk's splits cover [0, length) exactly, in order, from absolute
    multiples of SPLIT_KEYS, so a row's splits (and so its output) depend on
    its length alone, never on the cache size S; the scratch of an
    S-position cache holds every split a row of length <= S can have, for
    each of the G query heads of a KV head, at every G the kernels take."""
    spans = tdec.split_bounds(length)
    assert spans[0][0] == 0 and spans[-1][1] == length
    assert all(end == start for (_, end), (start, _) in zip(spans, spans[1:]))
    assert all(start % tdec.SPLIT_KEYS == 0 and 0 < end - start <= tdec.SPLIT_KEYS
               for start, end in spans) or spans == [(0, 0)]
    assert len(spans) == max(1, -(-length // tdec.SPLIT_KEYS))
    for S in {max(length, 1), length + 1, 4 * length + 7}:
        for G in range(1, tdec.MMA_G + 1):
            part_o, part_lse = tdec.split_scratch(2, S, 3, G, 32, "cpu")
            n = 1 if part_o is None else part_o.shape[2]
            assert n == len(tdec.split_bounds(S)) >= len(spans)
            assert (part_o is None) == (S <= tdec.SPLIT_KEYS)
            if part_o is not None:
                assert part_o.shape == (2, 3, n, G, 32) and part_lse.shape == (2, 3, n, G)


def _walk_constant(name: str) -> int:
    """A ``constexpr int`` of the CUDA walk, ``csrc/decode_attention_core.cuh``."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "decode_attention_core.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_split_size_is_a_multiple_of_the_walks_warp_tile():
    """The CUDA walk refuses a split that is not a multiple of its warp tile
    (``WT``)."""
    wt = _walk_constant("WT")
    assert tdec.SPLIT_KEYS >= wt and tdec.SPLIT_KEYS % wt == 0


def test_every_group_fits_the_walks_tensor_core_rows():
    """The CUDA walk refuses a G above the M rows of its tensor-core tiles
    (``MMA_G``): one launch takes every G that fits them, those without a
    power of two (3, 5, 6, 12) included, and the wrappers cut a larger G
    into chunks of ``MMA_G``."""
    assert tdec.MMA_G == _walk_constant("MMA_G")
    assert max(3, 5, 6, 12) <= tdec.MMA_G


@pytest.mark.parametrize("G", [17, 24, 32])
def test_split_groups_with_the_plain_launcher_matches_one_call(G):
    """Above the walk's 16 rows the wrappers launch chunks of at most 16
    query heads per KV head: driven by the plain version as its launcher,
    the split gives the plain version on all heads at once, bit for bit,
    and the JAX oracle's result at the bf16 tolerance; dense and paged."""
    from repro.kernels import ref as jref

    rng = np.random.default_rng(40 + G)
    B, KVH, hd, S = 3, 2, 32, 40
    q = torch.from_numpy(rng.standard_normal((B, KVH * G, hd)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((B, S, KVH, hd)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((B, S, KVH, hd)).astype(np.float32)).bfloat16()
    lengths = torch.tensor([40, 17, 1], dtype=torch.int32)
    chunks = []

    def launch(qc):
        chunks.append(qc.shape[1] // KVH)
        assert qc.is_contiguous()
        return ref.decode_attention_ref(qc, k, v, lengths)

    got = tdec.split_groups(q, KVH, launch)
    assert chunks == [16] * (G // 16) + ([G % 16] if G % 16 else [])
    assert torch.equal(got, ref.decode_attention_ref(q, k, v, lengths))
    want = jref.decode_attention_ref(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(k.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(v.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bfloat16"])
    # the paged plain version through the same split: the rows' blocks of 4 in order
    table = torch.arange(B * 10, dtype=torch.int32).reshape(B, 10)
    k_pool, v_pool = (t.reshape(B * 10, 4, KVH, hd) for t in (k, v))
    paged = tdec.split_groups(q, KVH, lambda qc: ref.paged_decode_attention_ref(
        qc, k_pool, v_pool, table, lengths, seq_len=S))
    assert torch.equal(paged, got)
    # at G <= 16 the launcher gets the query itself, once
    seen = []
    q16 = q[:, : KVH * 16].contiguous()
    tdec.split_groups(q16, KVH, lambda qc: seen.append(qc) or qc)
    assert len(seen) == 1 and seen[0] is q16


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "internlm2-20b", "glm4-9b", "stablelm-1.6b",
                                  "zamba2-2.7b", "mixtral-8x7b"])
def test_registry_attention_fits_the_decode_wrappers(arch):
    """The GQA configs of the JAX registry that the staged engine serves (G
    5, 6, 16, 1 and mixtral-8x7b's 4, at hd 128, 64 and zamba2-2.7b's 80)
    are shapes both decode wrappers take in one launch of the walk, and the
    prefill flash kernel takes their head dim."""
    from repro.configs import get_config

    from repro_torch.kernels import flash_attention as tflash

    cfg = get_config(arch)
    assert cfg.num_heads % cfg.num_kv_heads == 0
    assert 1 <= cfg.num_heads // cfg.num_kv_heads <= tdec.MMA_G
    assert cfg.head_dim in tdec.HEAD_DIMS
    assert cfg.head_dim in tflash.HEAD_DIMS


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "musicgen-medium"])
def test_embeds_configs_attention_fits_the_flash_kernel(arch):
    """The ``frontend="embeds"`` configs reach attention kernels only through
    the batched prefill (the staged engine refuses them and the monolithic
    decode is plain attention): the flash kernel takes their head dim
    (phi-3-vision's 96, musicgen's 64), and hd 96 is in no decode
    wrapper."""
    from repro.configs import get_config

    from repro_torch.kernels import flash_attention as tflash

    cfg = get_config(arch)
    assert cfg.head_dim == {"phi-3-vision-4.2b": 96, "musicgen-medium": 64}[arch]
    assert cfg.num_heads == cfg.num_kv_heads  # MHA
    assert cfg.head_dim in tflash.HEAD_DIMS
    assert 96 not in tdec.HEAD_DIMS


def test_every_probe_variant_finds_its_marked_lines():
    """``tools/probe_decode_walk.py`` patches its variants of the walk in at
    the lines marked ``// PROBE: <name>``: each marker it names is on exactly
    one line of the sources, so every variant builds from them as they are."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import build

    path = Path(__file__).resolve().parents[1] / "tools" / "probe_decode_walk.py"
    spec = importlib.util.spec_from_file_location("probe_decode_walk", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    for name, patches in probe.PATCHES.items():
        texts = {}
        for file, marker, where, new in patches:
            text = texts.get(file, (build.CSRC / file).read_text())
            texts[file] = probe.patched(text, marker, where, new)
            assert texts[file] != text, (name, marker)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((16, 50)).astype(np.float32)).bfloat16()
    before = (texit.exit_confidence.launches, tdec.decode_attention.launches)
    for backend in ("auto", "torch"):
        ops.set_backend(backend)
        try:
            c, i = ops.exit_confidence(h, w)
        finally:
            ops.set_backend("auto")
        cr, ir = ref.exit_confidence_ref(h, w)
        torch.testing.assert_close(c, cr, rtol=0, atol=0)
        torch.testing.assert_close(i, ir, rtol=0, atol=0)
    assert (texit.exit_confidence.launches, tdec.decode_attention.launches) == before


def test_cuda_backend_rejects_cpu_tensors():
    h = torch.zeros((1, 8), dtype=torch.bfloat16)
    w = torch.zeros((8, 16), dtype=torch.bfloat16)
    q = torch.zeros((1, 2, 32), dtype=torch.bfloat16)
    kv = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    ops.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="cuda"):
            ops.exit_confidence(h, w)
        with pytest.raises(ValueError, match="cuda"):
            ops.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32))
    finally:
        ops.set_backend("auto")
    with pytest.raises(ValueError):
        ops.set_backend("pallas")


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def test_build_target_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header under ``csrc/`` renames the library of every source
    that includes it, directly or through another header, and no other; no
    nvcc is needed to name a build."""
    import shutil

    from repro_torch.kernels import build

    for path in build.CSRC.iterdir():
        shutil.copy(path, tmp_path / path.name)
    (tmp_path / "inner.cuh").write_text("#pragma once\n")
    core = tmp_path / "decode_attention_core.cuh"
    core.write_text('#include "inner.cuh"\n' + core.read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = ("exit_confidence", "decode_attention", "paged_decode_attention")
    assert sorted(p.name for p in build._sources("paged_decode_attention")) == [
        "decode_attention_core.cuh", "inner.cuh", "paged_decode_attention.cu"]
    before = {n: build._target(n) for n in names}
    for header in (core, tmp_path / "inner.cuh"):
        header.write_text(header.read_text() + "// edited\n")
        after = {n: build._target(n) for n in names}
        assert after["exit_confidence"] == before["exit_confidence"]
        for n in ("decode_attention", "paged_decode_attention"):
            assert after[n] != before[n] and after[n].parent == build.BUILD_DIR
        before = after
