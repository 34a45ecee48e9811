"""The port's prefill flash attention on the CPU vs the JAX package.

On a CPU tensor the wrapper and ``ops.flash_attention`` run the plain
version, ``ref.flash_attention_ref``; the same numpy inputs go through the
JAX oracle (``repro.kernels.ref``) on ``tests/test_kernels.py``'s sweep and
through the Pallas kernel in interpret mode.  Tolerances as there: f32 2e-5,
bf16 2e-2.  ``gqa_forward`` reaches the kernel only where the backend
launches one (a CUDA tensor); on the CPU and under the "torch" backend it
stays ``chunked_attention``, bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.layers import apply_rope, matmul

from torch_port_common import bridged_params

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, Sq, Sk, Hq, KVH, hd, dtype):
    """The same draws as JAX arrays and torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, Sq, Hq, hd), (B, Sk, KVH, hd), (B, Sk, KVH, hd))]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrays])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# tests/test_kernels.py's sweep: (B, Sq, Sk, Hq, KVH, hd)
SWEEP = [
    (1, 128, 128, 4, 4, 64),  # MHA
    (2, 256, 256, 8, 2, 64),  # GQA 4:1
    (1, 192, 192, 4, 1, 32),  # MQA, ragged seq vs block
    (2, 128, 384, 4, 4, 128),  # cross: kv longer than q
    (2, 104, 104, 8, 8, 80),  # zamba2-2.7b's head dim
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,KVH,hd", SWEEP)
def test_flash_ref_matches_jax_oracle(dtype, B, Sq, Sk, Hq, KVH, hd):
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, B, Sq, Sk, Hq, KVH, hd, dtype)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == (B, Sq, Hq, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 32), (True, 100), (True, 4096), (False, None)])
def test_flash_ref_window_and_non_causal_match_jax_oracle(causal, window):
    B, S, H, hd = 1, (256 if window else 128), (4 if window else 2), 64
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, B, S, S, H, H, hd, "float32")
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,KVH,hd,block", [
    (2, 128, 128, 8, 2, 64, 64),  # GQA 4:1
    (1, 64, 192, 4, 4, 32, 64),  # kv longer than q
    (1, 128, 128, 4, 4, 80, 64),  # zamba2-2.7b's head dim
])
def test_ops_flash_matches_pallas_interpret(dtype, B, Sq, Sk, Hq, KVH, hd, block):
    """The port's op on the CPU against the Pallas kernel in interpret mode
    (top-left positions also when Sk > Sq)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, B, Sq, Sk, Hq, KVH, hd, dtype)
    want = pallas_flash(jq, jk, jv, causal=True, block_q=block, block_k=block, interpret=True)
    n0 = tflash.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert tflash.flash_attention.launches == n0
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("B,S,Hq,KVH,hd,q_chunk", [
    (2, 40, 4, 4, 32, 1024),
    (3, 24, 8, 2, 64, 8),  # GQA, three q chunks
    (1, 17, 4, 1, 32, 1024),
])
def test_flash_plain_matches_chunked_attention_at_arange(B, S, Hq, KVH, hd, q_chunk):
    """At positions arange(S) the op's top-left causal mask is
    ``chunked_attention``'s; the division and the multiplication by
    1/sqrt(hd) differ by an ulp at most."""
    _, (tq, tk, tv) = _qkv(3, B, S, S, Hq, KVH, hd, "float32")
    pos = torch.arange(S, dtype=torch.int32)
    want = tattn.chunked_attention(tq, tk, tv, pos, pos, Hq // KVH, q_chunk=q_chunk)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL["float32"])


def _gqa_inputs():
    _, tparams, _, tcfg = bridged_params(0)
    p = tmodel._period(tparams["stages"][0]["blocks"][0], 0)["attn"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 12, tcfg.d_model)).astype(np.float32)).bfloat16()
    return p, x, tcfg.attn_dims()


def _gqa_forward_before(p, x, dims, q_chunk):
    """gqa_forward's body as it was before the kernel route: chunked attention."""
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32)
    q, k, v = tattn._project_qkv(p, x, dims)
    q = apply_rope(q, pos[None, :], dims.rope_theta)
    k = apply_rope(k, pos[None, :], dims.rope_theta)
    out = tattn.chunked_attention(q, k, v, pos, pos, dims.groups, q_chunk=q_chunk)
    return matmul(out.reshape(B, S, dims.q_dim), p["w_o"]), k, v


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_gqa_forward_on_the_cpu_stays_chunked_attention(backend, monkeypatch):
    """On the CPU (and under "torch") prefill never reaches the flash op or
    its kernel wrapper, and gives bitwise what it gave before."""
    p, x, dims = _gqa_inputs()

    def untouched(*args, **kwargs):
        raise AssertionError("the flash path was taken")

    monkeypatch.setattr(ops, "flash_attention", untouched)
    n0 = tflash.flash_attention.launches
    ops.set_backend(backend)
    try:
        out, (k, v) = tattn.gqa_forward(p, x, dims, None, 4, return_kv=True)
    finally:
        ops.set_backend("auto")
    assert tflash.flash_attention.launches == n0
    want, wk, wv = _gqa_forward_before(p, x, dims, 4)
    assert torch.equal(out, want) and torch.equal(k, wk) and torch.equal(v, wv)


def test_cuda_backend_rejects_cpu_tensors_for_flash():
    q = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    p, x, dims = _gqa_inputs()
    ops.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="cuda"):
            ops.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="cuda"):
            ops.uses_kernel(q)
        with pytest.raises(ValueError, match="cuda"):
            tattn.gqa_forward(p, x, dims)
    finally:
        ops.set_backend("auto")
    assert not ops.uses_kernel(q)


def test_flash_ref_top_left_positions_and_window_of_one():
    """Top-left positions when Sk > Sq: query 0 sees key 0 alone, whatever
    follows; a window of 1 leaves each query its own key."""
    _, (q, k, v) = _qkv(5, 1, 3, 7, 2, 2, 32, "float32")
    out = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out[:, 0], v[:, 0], rtol=0, atol=1e-6)
    out_w = ref.flash_attention_ref(q, k, v, causal=True, window=1)
    torch.testing.assert_close(out_w, v[:, :3], rtol=0, atol=1e-6)
