"""Attention and its caches: GQA (optional QKV bias) and MLA (DeepSeek-style
multi-head latent attention) — the counterpart of ``repro.models.attention``.

Prefill attention (``gqa_forward``) goes through
``kernels.ops.flash_attention`` wherever the backend launches a kernel (a
CUDA tensor under "auto" or "cuda"), and is the q-chunked plain
``chunked_attention`` (the reference's XLA path) otherwise: on the CPU and
under the "torch" backend.  Every caller prefills positions ``arange(S)``,
where the kernel's top-left causal mask is ``chunked_attention``'s; other
positions are not supported on the kernel path.  Cached one-token decode
goes through ``kernels.ops.decode_attention`` (dense slots) or
``kernels.ops.paged_decode_attention`` (paged blocks): the hand-written CUDA
kernels on the card, their plain versions on the CPU.

MLA has no kernel in the reference: its prefill is the plain
``chunked_attention`` (q/k head dim 192, v head dim 128) and its decode the
absorbed-latent ``einsum`` math, so both are plain torch on every device.

Caches are plain dicts of tensors:
  full   : {"k": [B,S,kv,hd], "v": [B,S,kv,hd], "pos": int32 [] or [B]}
  window : the same with S == window, a ring indexed by pos % window, plus
           "slot_pos": int32 [window], each slot's global position (-1 ==
           empty); the monolithic steps' cache when the window is shorter
           than ``max_len``
  paged  : {"k": [NB,bs,kv,hd], "v": [NB,bs,kv,hd], "pos": int32 [B],
            "table": int32 [B, n_logical]}
  mla    : {"c_kv": [B,S,lora], "k_pe": [B,S,rope_dim], "pos": int32 [] or [B]},
           paged as {"c_kv": [NB,bs,lora], "k_pe": [NB,bs,rope_dim], ...}

Unlike the JAX package, cache writes here are in place (``index_put_``):
a decode step updates the cache tensors it is given and returns a dict
holding the same tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers
from repro_torch.models.layers import Params, apply_rope, einsum, matmul

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int | None = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def groups(self) -> int:
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        return self.num_heads // self.num_kv_heads


def _project_qkv(params: Params, x: torch.Tensor, dims: AttnDims):
    B, S, _ = x.shape
    q = matmul(x, params["w_q"])
    k = matmul(x, params["w_k"])
    v = matmul(x, params["w_v"])
    if "b_q" in params:
        # the f32 biases are cast to the activation dtype before the add
        q = q + params["b_q"].to(q.dtype)
        k = k + params["b_k"].to(k.dtype)
        v = v + params["b_v"].to(v.dtype)
    q = q.reshape(B, S, dims.num_heads, dims.head_dim)
    k = k.reshape(B, S, dims.num_kv_heads, dims.head_dim)
    v = v.reshape(B, S, dims.num_kv_heads, dims.head_dim)
    return q, k, v


def _attend_block(
    q: torch.Tensor,  # [B, Cq, Hq, hd]
    k: torch.Tensor,  # [B, Sk, kv, hd]
    v: torch.Tensor,  # [B, Sk, kv, hd]
    q_pos: torch.Tensor,  # [Cq] global positions of the queries
    k_pos: torch.Tensor,  # [Sk] global positions of the keys (-1 == invalid)
    groups: int,
    window: int | None = None,
) -> torch.Tensor:
    """Masked softmax attention for one q-chunk (grouped heads); a key is
    seen when causal, valid and, with a ``window``, within it."""
    B, Cq, Hq, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(B, Cq, kvh, groups, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale  # [B, kv, g, Cq, Sk]
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] >= 0)
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Cq, Hq, v.shape[-1])


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [Sq]
    k_positions: torch.Tensor,  # [Sk]
    groups: int,
    window: int | None = None,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal attention (optionally within a sliding ``window``), q chunked
    so scores stay [B, kv, g, Cq, Sk]."""
    Sq = q.shape[1]
    q_chunk = min(q_chunk, Sq)
    if Sq % q_chunk != 0:  # one block for ragged tiny shapes, as the reference
        q_chunk = Sq
    outs = [
        _attend_block(
            q[:, i : i + q_chunk], k, v, q_positions[i : i + q_chunk], k_positions, groups,
            window,
        )
        for i in range(0, Sq, q_chunk)
    ]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def gqa_forward(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    dims: AttnDims,
    positions: torch.Tensor | None = None,  # [S]
    q_chunk: int = 1024,
    return_kv: bool = False,
):
    """Full-sequence causal attention (prefill).

    ``positions`` must be ``arange(S)`` (what every caller passes) wherever
    the backend launches a kernel: the flash kernel masks by top-left
    positions, which equals ``chunked_attention``'s causal mask only there.
    Elsewhere (CPU, backend "torch") attention is ``chunked_attention`` at
    the given positions.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, dims)
    q = apply_rope(q, positions[None, :], dims.rope_theta)
    k = apply_rope(k, positions[None, :], dims.rope_theta)
    if kernel_ops.uses_kernel(q):
        out = kernel_ops.flash_attention(q, k, v, causal=True, window=dims.sliding_window)
    else:
        out = chunked_attention(q, k, v, positions, positions, dims.groups, dims.sliding_window,
                                q_chunk)
    out = matmul(out.reshape(B, S, dims.q_dim), params["w_o"])
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def make_kv_cache(
    batch: int, max_len: int, dims: AttnDims, dtype=torch.bfloat16, device=None
) -> Params:
    shape = (batch, max_len, dims.num_kv_heads, dims.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_window_cache(batch: int, dims: AttnDims, dtype=torch.bfloat16, device=None) -> Params:
    """A ring of ``dims.sliding_window`` slots, every slot empty."""
    w = dims.sliding_window
    if w is None:
        raise ValueError("make_window_cache needs dims.sliding_window")
    cache = make_kv_cache(batch, w, dims, dtype, device)
    cache["slot_pos"] = torch.full((w,), -1, dtype=torch.int32, device=device)
    return cache


def prefill_into_cache(cache: Params, k: torch.Tensor, v: torch.Tensor) -> Params:
    """Write a prefilled (k, v) prefix into a full cache starting at 0."""
    S = k.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=k.device)
    return cache


def _cache_write_ragged(buf: torch.Tensor, new: torch.Tensor, slots: torch.Tensor) -> None:
    """Write one token per row at PER-ROW slots, in place.

    The same values as the reference's masked select
    (``repro/models/attention.py`` ``_cache_write_ragged``): row b gets
    ``new[b, 0]`` at position ``slots[b]``, and a row whose slot lies past
    the buffer (a padded row's trash slot can run past ``max_len``) is left
    unchanged.  The out-of-range rows write back what they read, so the
    write needs no host sync.
    """
    S = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    at = slots.long().clamp(max=S - 1)
    keep = (slots < S).reshape((-1,) + (1,) * (buf.ndim - 2))
    buf[rows, at] = torch.where(keep, new[:, 0].to(buf.dtype), buf[rows, at])


def gqa_decode_ragged(
    params: Params,
    x: torch.Tensor,  # [B, 1, d]
    cache: Params,
    dims: AttnDims,
):
    """One decode step with PER-ROW cache positions (``cache["pos"]``: [B]).

    The serving engine's slot-cache path: rope positions, the cache write and
    the validity mask are per row, and attention runs through
    ``kernels.ops.decode_attention`` with ``lengths = pos + 1``.
    """
    B = x.shape[0]
    pos = cache["pos"]  # int32 [B]
    q, k_new, v_new = _project_qkv(params, x, dims)
    pos_b = pos[:, None]
    q = apply_rope(q, pos_b, dims.rope_theta)
    k_new = apply_rope(k_new, pos_b, dims.rope_theta)
    _cache_write_ragged(cache["k"], k_new, pos)
    _cache_write_ragged(cache["v"], v_new, pos)
    new_cache = dict(cache, pos=pos + 1)
    out = kernel_ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos + 1)
    out = matmul(out.reshape(B, 1, dims.q_dim), params["w_o"])
    return out, new_cache


def _paged_token_write(
    pools: tuple[torch.Tensor, ...],  # each [NB, bs, ...], last row = trash block
    news: tuple[torch.Tensor, ...],  # each [B, 1, ...], one token per row
    table: torch.Tensor,  # [B, n_logical] int32
    pos: torch.Tensor,  # [B] int32, position the token lands at
) -> None:
    """Scatter one token per row into each pool (K and V) through the block
    table, in place; the block and offset are found once for all pools.

    A padded batch row's position keeps advancing and can pass the table
    (``pos >= n_logical * bs``).  The reference's gather then yields an
    out-of-range block and its scatter drops the write; here the write goes
    to the pool's trash block, the last pool row, which no real row reads.
    Several padded rows may hit the same trash cell in one call; real rows
    own their target blocks, so their cells are distinct.
    """
    NB, bs = pools[0].shape[:2]
    n_logical = table.shape[1]
    logical = (pos // bs).long()
    phys = torch.gather(table, 1, logical.clamp(max=n_logical - 1)[:, None])[:, 0].long()
    phys = torch.where(logical < n_logical, phys, NB - 1)
    offset = (pos % bs).long()
    for pool, new in zip(pools, news):
        pool[phys, offset] = new[:, 0].to(pool.dtype)


def gqa_decode_paged(
    params: Params,
    x: torch.Tensor,  # [B, 1, d]
    cache: Params,
    dims: AttnDims,
    seq_len: int,
):
    """One decode step against a PAGED slot store.

    ``cache`` holds the physical block pool plus per-row indirection:
    ``{"k"/"v": [NB, bs, kv, hd], "pos": int32 [B], "table": int32 [B, nlog]}``.
    The per-row ragged math of ``gqa_decode_ragged`` (rope positions, the
    token write and validity keyed by ``pos``), with reads and writes through
    the block table.  Attention runs through
    ``kernels.ops.paged_decode_attention``: the CUDA kernel on the card,
    gather-to-``seq_len`` plus the dense plain version on the CPU, which keeps
    paged decode bitwise identical to the dense slot path there.  The engine
    guarantees the block holding ``pos`` is owned by the row alone, so the
    write never touches a shared block.  The pool is updated in place.
    """
    B = x.shape[0]
    pos = cache["pos"]  # int32 [B]
    table = cache["table"]  # int32 [B, n_logical]
    q, k_new, v_new = _project_qkv(params, x, dims)
    pos_b = pos[:, None]
    q = apply_rope(q, pos_b, dims.rope_theta)
    k_new = apply_rope(k_new, pos_b, dims.rope_theta)
    _paged_token_write((cache["k"], cache["v"]), (k_new, v_new), table, pos)
    new_cache = dict(cache, pos=pos + 1)
    out = kernel_ops.paged_decode_attention(
        q[:, 0], cache["k"], cache["v"], table, pos + 1, seq_len=seq_len
    )
    out = matmul(out.reshape(B, 1, dims.q_dim), params["w_o"])
    return out, new_cache


def gqa_decode(
    params: Params,
    x: torch.Tensor,  # [B, 1, d]
    cache: Params,
    dims: AttnDims,
):
    """One decode step with one shared (scalar) position, against a full
    cache or a window ring (``"slot_pos"`` in the cache).

    A ring writes the token at slot ``pos % W`` and records ``pos`` there;
    its keys are masked by ``slot_pos`` alone (the ring already bounds the
    window).  A full cache writes at ``pos`` (clamped to the last slot, as
    the reference's masked write) and masks by position and
    ``dims.sliding_window``."""
    B = x.shape[0]
    pos = cache["pos"]  # int32 []
    q, k_new, v_new = _project_qkv(params, x, dims)
    pos_b = pos.expand(B, 1)
    q = apply_rope(q, pos_b, dims.rope_theta)
    k_new = apply_rope(k_new, pos_b, dims.rope_theta)
    S_cache = cache["k"].shape[1]
    windowed = "slot_pos" in cache
    slot = (pos % S_cache if windowed else pos.clamp(max=S_cache - 1)).long()
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    new_cache = dict(cache, pos=pos + 1)
    if windowed:
        cache["slot_pos"][slot] = pos
        k_positions, window = cache["slot_pos"], None
    else:
        arange = torch.arange(S_cache, dtype=torch.int32, device=x.device)
        k_positions, window = torch.where(arange <= pos, arange, -1), dims.sliding_window
    out = _attend_block(q, cache["k"], cache["v"], pos.reshape(1), k_positions, dims.groups,
                        window)
    out = matmul(out.reshape(B, 1, dims.q_dim), params["w_o"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MlaDims:
    d_model: int
    num_heads: int
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 1e4

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def mla_init(dims: MlaDims, dense, norm) -> Params:
    """MLA's parameters; ``dense(shape)`` makes one bf16 weight and
    ``norm(d)`` one RMSNorm's f32 scale, each stacked over the stage's
    periods (``models.model``)."""
    H = dims.num_heads
    return {
        # queries: full-rank projection to per-head (nope + rope) dims
        "w_q": dense((dims.d_model, H * dims.qk_head_dim)),
        # joint KV low-rank compression
        "w_dkv": dense((dims.d_model, dims.kv_lora_rank)),
        "w_kpe": dense((dims.d_model, dims.qk_rope_head_dim)),
        # up-projections out of the latent
        "w_uk": dense((dims.kv_lora_rank, H * dims.qk_nope_head_dim)),
        "w_uv": dense((dims.kv_lora_rank, H * dims.v_head_dim)),
        "w_o": dense((H * dims.v_head_dim, dims.d_model)),
        "norm_ckv": norm(dims.kv_lora_rank),
    }


def _mla_q(params: Params, x: torch.Tensor, dims: MlaDims, positions: torch.Tensor):
    B, S, _ = x.shape
    q = matmul(x, params["w_q"]).reshape(B, S, dims.num_heads, dims.qk_head_dim)
    q_nope = q[..., : dims.qk_nope_head_dim]
    q_pe = apply_rope(q[..., dims.qk_nope_head_dim :], positions, dims.rope_theta)
    return q_nope, q_pe


def _mla_latent(params: Params, x: torch.Tensor, dims: MlaDims, positions: torch.Tensor):
    c_kv = layers.rmsnorm(params["norm_ckv"], matmul(x, params["w_dkv"]))
    k_pe = matmul(x, params["w_kpe"])[:, :, None, :]  # single shared rope head
    k_pe = apply_rope(k_pe, positions, dims.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_forward(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    dims: MlaDims,
    positions: torch.Tensor | None = None,  # [S]
    q_chunk: int = 1024,
    return_latent: bool = False,
):
    """Prefill MLA: expand k/v out of the latent and attend causally through
    the plain ``chunked_attention`` (no kernel takes q/k head dim 192 with v
    head dim 128; the reference's prefill is its XLA path too)."""
    B, S, _ = x.shape
    H = dims.num_heads
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    pos2 = positions[None, :]
    q_nope, q_pe = _mla_q(params, x, dims, pos2)
    c_kv, k_pe = _mla_latent(params, x, dims, pos2)

    k_nope = matmul(c_kv, params["w_uk"]).reshape(B, S, H, dims.qk_nope_head_dim)
    v = matmul(c_kv, params["w_uv"]).reshape(B, S, H, dims.v_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, dims.qk_rope_head_dim)], dim=-1)
    out = chunked_attention(q, k, v, positions, positions, 1, q_chunk=q_chunk)
    out = matmul(out.reshape(B, S, H * dims.v_head_dim), params["w_o"])
    if return_latent:
        return out, (c_kv, k_pe)
    return out


def make_mla_cache(
    batch: int, max_len: int, dims: MlaDims, dtype=torch.bfloat16, device=None
) -> Params:
    return {
        "c_kv": torch.zeros((batch, max_len, dims.kv_lora_rank), dtype=dtype, device=device),
        "k_pe": torch.zeros((batch, max_len, dims.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_prefill_into_cache(cache: Params, c_kv: torch.Tensor, k_pe: torch.Tensor) -> Params:
    """Write a prefilled latent prefix into an MLA cache starting at 0."""
    S = c_kv.shape[1]
    cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
    cache["k_pe"][:, :S] = k_pe.to(cache["k_pe"].dtype)
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=c_kv.device)
    return cache


def _mla_absorbed_attend(
    params: Params,
    q_nope: torch.Tensor,  # [B, 1, H, nope_dim]
    q_pe: torch.Tensor,  # [B, 1, H, rope_dim]
    c_kv: torch.Tensor,  # [B, S, lora]
    k_pe: torch.Tensor,  # [B, S, rope_dim]
    pos: torch.Tensor,  # int32 [B], per-row position of the new token
    dims: MlaDims,
) -> torch.Tensor:
    """Absorbed-latent attention shared by the scalar, ragged and paged
    decodes: the query absorbs ``W_uk``, scores and mixes in latent space
    (O(S * (lora + rope_dim)) per head), and ``W_uv`` maps the mix out."""
    B, S_cache = c_kv.shape[0], c_kv.shape[1]
    H = dims.num_heads
    bf16 = torch.bfloat16
    w_uk = params["w_uk"].reshape(dims.kv_lora_rank, H, dims.qk_nope_head_dim)
    q_lat = einsum("bhd,rhd->bhr", q_nope[:, 0].to(bf16), w_uk.to(bf16))
    scores = einsum("bhr,bsr->bhs", q_lat, c_kv).float()
    scores = scores + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(), k_pe.float())
    scores = scores / math.sqrt(dims.qk_head_dim)
    valid = torch.arange(S_cache, device=c_kv.device)[None, :] <= pos[:, None]  # [B, S]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    out_lat = einsum("bhs,bsr->bhr", probs, c_kv)  # [B, H, lora]
    w_uv = params["w_uv"].reshape(dims.kv_lora_rank, H, dims.v_head_dim)
    out = einsum("bhr,rhd->bhd", out_lat, w_uv.to(out_lat.dtype))
    return matmul(out.reshape(B, 1, H * dims.v_head_dim), params["w_o"])


def mla_decode_ragged(params: Params, x: torch.Tensor, cache: Params, dims: MlaDims):
    """Absorbed MLA decode with PER-ROW cache positions (``cache["pos"]``:
    [B]): the serving engine's slot-cache path."""
    pos = cache["pos"]  # int32 [B]
    pos_b = pos[:, None]
    q_nope, q_pe = _mla_q(params, x, dims, pos_b)
    c_new, kpe_new = _mla_latent(params, x, dims, pos_b)
    _cache_write_ragged(cache["c_kv"], c_new, pos)
    _cache_write_ragged(cache["k_pe"], kpe_new, pos)
    new_cache = dict(cache, pos=pos + 1)
    out = _mla_absorbed_attend(params, q_nope, q_pe, cache["c_kv"], cache["k_pe"], pos, dims)
    return out, new_cache


def mla_decode_paged(params: Params, x: torch.Tensor, cache: Params, dims: MlaDims, seq_len: int):
    """Absorbed MLA decode against a PAGED latent pool.

    ``cache``: ``{"c_kv": [NB, bs, lora], "k_pe": [NB, bs, rope], "pos": [B],
    "table": [B, nlog]}``.  The token is written through the table
    (``_paged_token_write``, trash-block rule included); the latent rows
    are gathered to a contiguous ``seq_len`` view, the dense slot path's
    exact shape, so the absorbed math is bitwise ``mla_decode_ragged``'s.
    """
    B = x.shape[0]
    pos = cache["pos"]  # int32 [B]
    table = cache["table"]
    pos_b = pos[:, None]
    q_nope, q_pe = _mla_q(params, x, dims, pos_b)
    c_new, kpe_new = _mla_latent(params, x, dims, pos_b)
    _paged_token_write((cache["c_kv"], cache["k_pe"]), (c_new, kpe_new), table, pos)
    new_cache = dict(cache, pos=pos + 1)
    idx = table.long()
    c_virt = cache["c_kv"][idx].reshape(B, -1, dims.kv_lora_rank)[:, :seq_len]
    kpe_virt = cache["k_pe"][idx].reshape(B, -1, dims.qk_rope_head_dim)[:, :seq_len]
    out = _mla_absorbed_attend(params, q_nope, q_pe, c_virt, kpe_virt, pos, dims)
    return out, new_cache


def mla_decode(params: Params, x: torch.Tensor, cache: Params, dims: MlaDims):
    """Absorbed MLA decode against a shared-position cache (scalar ``pos``)."""
    B = x.shape[0]
    pos = cache["pos"]  # int32 []
    pos_b = pos.expand(B, 1)
    q_nope, q_pe = _mla_q(params, x, dims, pos_b)
    c_new, kpe_new = _mla_latent(params, x, dims, pos_b)
    # the reference's masked write: nothing lands once pos reaches the cache
    _cache_write_ragged(cache["c_kv"], c_new, pos.expand(B))
    _cache_write_ragged(cache["k_pe"], kpe_new, pos.expand(B))
    new_cache = dict(cache, pos=pos + 1)
    out = _mla_absorbed_attend(
        params, q_nope, q_pe, cache["c_kv"], cache["k_pe"], pos.expand(B), dims
    )
    return out, new_cache
