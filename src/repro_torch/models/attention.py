"""GQA attention (optional QKV bias) and its KV caches — the GQA half of
``repro.models.attention``.

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

Caches are plain dicts of tensors:
  full  : {"k": [B,S,kv,hd], "v": [B,S,kv,hd], "pos": int32 [] or [B]}
  paged : {"k": [NB,bs,kv,hd], "v": [NB,bs,kv,hd], "pos": int32 [B],
           "table": int32 [B, n_logical]}

Unlike the JAX package, cache writes here are in place (``index_put_``):
a decode step updates the cache tensors it is given and returns a dict
holding the same tensors.  MLA and sliding-window caches are not ported yet
(ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import Params, apply_rope, matmul

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
) -> torch.Tensor:
    """Masked softmax attention for one q-chunk (grouped heads)."""
    B, Cq, Hq, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(B, Cq, kvh, groups, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale  # [B, kv, g, Cq, Sk]
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] >= 0)
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
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal attention, q chunked so scores stay [B, kv, g, Cq, Sk]."""
    Sq = q.shape[1]
    q_chunk = min(q_chunk, Sq)
    if Sq % q_chunk != 0:  # one block for ragged tiny shapes, as the reference
        q_chunk = Sq
    outs = [
        _attend_block(
            q[:, i : i + q_chunk], k, v, q_positions[i : i + q_chunk], k_positions, groups
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
        out = chunked_attention(q, k, v, positions, positions, dims.groups, q_chunk)
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
    """One decode step against a full cache with one shared (scalar) position."""
    B = x.shape[0]
    pos = cache["pos"]  # int32 []
    q, k_new, v_new = _project_qkv(params, x, dims)
    pos_b = pos.expand(B, 1)
    q = apply_rope(q, pos_b, dims.rope_theta)
    k_new = apply_rope(k_new, pos_b, dims.rope_theta)
    S_cache = cache["k"].shape[1]
    slot = pos.clamp(max=S_cache - 1).long()
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    new_cache = dict(cache, pos=pos + 1)
    arange = torch.arange(S_cache, dtype=torch.int32, device=x.device)
    k_positions = torch.where(arange <= pos, arange, -1)
    out = _attend_block(q, cache["k"], cache["v"], pos.reshape(1), k_positions, dims.groups)
    out = matmul(out.reshape(B, 1, dims.q_dim), params["w_o"])
    return out, new_cache
