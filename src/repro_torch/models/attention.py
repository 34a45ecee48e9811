"""Attention and its caches: GQA (optional QKV bias) and MLA (DeepSeek-style
multi-head latent attention) — the counterpart of ``repro.models.attention``.

Prefill attention (``gqa_forward``) goes through
``kernels.ops.flash_attention`` wherever the backend launches a kernel (a
CUDA tensor under "auto" or "cuda"), and is the q-chunked plain
``chunked_attention`` (the reference's XLA path) otherwise: on the CPU,
under the "torch" backend, and in training (``train=True``) on every
device.  Every caller prefills positions ``arange(S)``,
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
from repro_torch.models.layers import Params, apply_rope, einsum, is_dtensor, matmul
from repro_torch.sharding import local_map, split_dims

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
    q = matmul(x, params["w_q"])
    k = matmul(x, params["w_k"])
    v = matmul(x, params["w_v"])
    if "b_q" in params:
        # the f32 biases are cast to the activation dtype before the add
        q = q + params["b_q"].to(q.dtype)
        k = k + params["b_k"].to(k.dtype)
        v = v + params["b_v"].to(v.dtype)
    q = layers.split_last(q, dims.num_heads, dims.head_dim)
    k = layers.split_last(k, dims.num_kv_heads, dims.head_dim)
    v = layers.split_last(v, dims.num_kv_heads, dims.head_dim)
    return q, k, v


# ``sharding.local_map`` roles of q/k/v [B, S, heads, hd]
_QKV = ("b", None, "h", None)
# ... of a cache [B, S, kv, hd] whose sequence split stays (split-KV decode)
_KV = ("b", "s", "h", None)


def _masked_seq_write(buf: torch.Tensor, new: torch.Tensor, at: torch.Tensor) -> None:
    """Under a mesh: write ``new`` [B, 1, ...] into the DTensor ``buf`` [B,
    S, ...] where ``at`` [S] is set, in place, on each device's shard of
    ``buf`` as it lies (the reference's masked where-write; an index write
    at a tensor position would read the position on the host).  A 4-D
    leaf's third dim is its heads."""
    rest = ("h", None) if buf.ndim == 4 else (None,)
    bcast = (None, slice(None)) + (None,) * len(rest)
    buf.copy_(local_map(lambda c, n, a: torch.where(a[bcast], n.to(c.dtype), c),
                        (buf, new, at), (("b", "s") + rest, ("b", None) + rest, ("s",)),
                        (("b", "s") + rest,)))


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
    seen when causal, valid and, with a ``window``, within it.  Under a mesh
    it runs on each device's rows and heads (``sharding.local_map``); keys
    split along their sequence (a decode cache, a window ring with its
    ``slot_pos``) stay split, each device attending to its own keys under
    the softmax's global max and sum (``_attend_shard``)."""
    if is_dtensor(q):
        dims = split_dims(k, 1)
        if dims:
            reduce = _shard_reduce(k.device_mesh, dims)

            def shard(k_, v_, q_, qp, kp):  # the cache leads: its sequence split stays
                return _attend_shard(q_, k_, v_, qp, kp, groups, window, reduce)

            return local_map(shard, (k, v, q, q_pos, k_pos), (_KV, _KV, _QKV, (None,), ("s",)),
                             (_QKV,))
        fn = lambda *a: _attend_block(*a, groups, window)  # noqa: E731
        return local_map(fn, (q, k, v, q_pos, k_pos), (_QKV, _QKV, _QKV, (None,), (None,)),
                         (_QKV,))
    scores, mask = _scores(q, k, q_pos, k_pos, groups, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(*q.shape[:3], v.shape[-1])


def _scores(q, k, q_pos, k_pos, groups: int, window: int | None):
    """The masked, scaled f32 scores [B, kv, g, Cq, Sk] and the mask [Cq,
    Sk] of ``_attend_block``."""
    B, Cq, _, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(B, Cq, kvh, groups, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale  # [B, kv, g, Cq, Sk]
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] >= 0)
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return torch.where(mask[None, None, None], scores, NEG_INF), mask


def _shard_reduce(mesh, dims: list[int]):
    """``reduce(t, op)``: ``t`` all-reduced ("max" or "sum") over the
    devices of the mesh dims ``dims`` (a sequence split over one or two of
    them), by functional collectives (``CollectiveRecorder`` sees them)."""
    from torch.distributed import _functional_collectives as funcol

    groups = [mesh.get_group(i) for i in dims]

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        for group in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, group))
        return t

    return reduce


def _mix(probs: torch.Tensor, values: torch.Tensor, eq: str, reduce) -> torch.Tensor:
    """This shard's share of ``einsum(eq, probs, values)``, summed over the
    shards by ``reduce`` and rounded once to ``values``' dtype: on the CPU
    the f32 products (the unsharded bf16 product's one rounding, as
    ``layers.einsum``), elsewhere each shard's bf16 product."""
    if values.device.type == "cpu":
        part = torch.einsum(eq, probs.float(), values.float())
    else:
        part = torch.einsum(eq, probs, values).float()
    return reduce(part, "sum").to(values.dtype)


def _attend_shard(q, k, v, q_pos, k_pos, groups: int, window: int | None, reduce):
    """``_attend_block`` on one shard of a sequence-split cache, the
    reference's distributed flash-decode: the scores' max and sum-exp are
    all-reduced over the shards, so each device's probabilities are the
    unsharded softmax's, cast to ``v``'s dtype as there; its P V partial
    sums are then all-reduced.  Three all-reduces, [B, kv, g, Cq] twice and
    [B, Cq, Hq, hd] f32."""
    scores, _ = _scores(q, k, q_pos, k_pos, groups, window)
    e = torch.exp(scores - reduce(scores.amax(dim=-1, keepdim=True), "max"))
    probs = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(v.dtype)
    return _mix(probs, v, "bkgqs,bskd->bqkgd", reduce).reshape(*q.shape[:3], v.shape[-1])


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
        _attend_block(q_c, k, v, pos_c, k_positions, groups, window)
        for q_c, pos_c in zip(layers.pieces(q, q_chunk), layers.pieces(q_positions, q_chunk, 0))
    ]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def gqa_forward(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    dims: AttnDims,
    positions: torch.Tensor | None = None,  # [S]
    q_chunk: int = 1024,
    return_kv: bool = False,
    train: bool = False,
):
    """Full-sequence causal attention (prefill, the stateless serve, training).

    ``positions`` must be ``arange(S)`` (what every caller passes) wherever
    the backend launches a kernel: the flash kernel masks by top-left
    positions, which equals ``chunked_attention``'s causal mask only there.
    Elsewhere (CPU, backend "torch") attention is ``chunked_attention`` at
    the given positions.  ``train=True`` takes ``chunked_attention`` on every
    device, the reference's training path: the flash kernel is forward-only
    (its wrapper raises on inputs that need a gradient).
    """
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, dims)
    q = apply_rope(q, positions[None, :], dims.rope_theta)
    k = apply_rope(k, positions[None, :], dims.rope_theta)
    if not train and kernel_ops.uses_kernel(q):
        out = kernel_ops.flash_attention(q, k, v, causal=True, window=dims.sliding_window)
    else:
        out = chunked_attention(q, k, v, positions, positions, dims.groups, dims.sliding_window,
                                q_chunk)
    out = matmul(layers.merge_last(out), params["w_o"])
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
    if is_dtensor(k):
        # under a mesh each device pads its own rows and heads of the prefix
        # to the cache's length (an in-place write into a plain buffer
        # cannot take a sharded prefix)
        pad = (0, 0, 0, 0, 0, cache["k"].shape[1] - S)
        for name, t in (("k", k), ("v", v)):
            cache[name] = local_map(lambda t_: torch.nn.functional.pad(t_, pad),
                                    (t.to(cache[name].dtype),), (_QKV,), (_QKV,))
    else:
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
    ``kernels.ops.decode_attention`` with ``lengths = pos + 1``.  The step
    is its two halves around that call (``gqa_decode_ragged_pre`` and
    ``_post``), which the CUDA-graph decode (``serving.decode_graphs``)
    replays with the same call between them.
    """
    q, lengths = gqa_decode_ragged_pre(params, x, cache, dims)
    out = kernel_ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
    return gqa_decode_ragged_post(params, out), dict(cache, pos=lengths)


def gqa_decode_ragged_pre(params: Params, x: torch.Tensor, cache: Params, dims: AttnDims):
    """The half of ``gqa_decode_ragged`` before attention: the q/k/v
    projections (and biases), RoPE at each row's ``cache["pos"]``, the
    token's K/V written into ``cache`` in place, and ``(q [B, 1, H, hd],
    lengths = pos + 1)``, the row's new position and valid prefix."""
    pos = cache["pos"]  # int32 [B]
    q, k_new, v_new = _project_qkv(params, x, dims)
    pos_b = pos[:, None]
    q = apply_rope(q, pos_b, dims.rope_theta)
    k_new = apply_rope(k_new, pos_b, dims.rope_theta)
    _cache_write_ragged(cache["k"], k_new, pos)
    _cache_write_ragged(cache["v"], v_new, pos)
    return q, pos + 1


def gqa_decode_ragged_post(params: Params, out: torch.Tensor) -> torch.Tensor:
    """The half of ``gqa_decode_ragged`` after attention: the heads of
    ``out`` [B, H, hd] merged and projected by ``w_o``, [B, 1, d]."""
    return matmul(layers.merge_last(out)[:, None], params["w_o"])


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
    out = matmul(layers.merge_last(out)[:, None], params["w_o"])
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
    ``dims.sliding_window``; where the backend launches kernels and the
    window (if any) spans the cache, it attends through
    ``kernels.ops.decode_attention`` with ``lengths = pos + 1``."""
    B = x.shape[0]
    pos = cache["pos"]  # int32 []
    q, k_new, v_new = _project_qkv(params, x, dims)
    pos_b = pos.expand(B, 1)
    q = apply_rope(q, pos_b, dims.rope_theta)
    k_new = apply_rope(k_new, pos_b, dims.rope_theta)
    S_cache = cache["k"].shape[1]
    windowed = "slot_pos" in cache
    slot = (pos % S_cache if windowed else pos.clamp(max=S_cache - 1)).long()
    if is_dtensor(cache["k"]):
        # under a mesh: the masked where-write of the reference (an index
        # write at a tensor position would read the position on the host),
        # on each device's shard of the cache as it lies
        at = torch.arange(S_cache, device=x.device) == slot
        for name, new in (("k", k_new), ("v", v_new)):
            _masked_seq_write(cache[name], new, at)
        if windowed:
            cache["slot_pos"].copy_(torch.where(at, pos, cache["slot_pos"]))
    else:
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        if windowed:
            cache["slot_pos"][slot] = pos
    new_cache = dict(cache, pos=pos + 1)
    full = not windowed and (dims.sliding_window is None or dims.sliding_window >= S_cache)
    if full and dims.head_dim in kernel_ops.DECODE_HEAD_DIMS and kernel_ops.uses_kernel(q):
        # a full cache whose window (if any) spans it: the flash-decode
        # kernel, every row's keys 0..pos
        lengths = (pos + 1).clamp(max=S_cache).expand(B).contiguous()
        out = kernel_ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
        return matmul(layers.merge_last(out)[:, None], params["w_o"]), new_cache
    if windowed:
        k_positions, window = cache["slot_pos"], None
    else:
        arange = torch.arange(S_cache, dtype=torch.int32, device=x.device)
        k_positions, window = torch.where(arange <= pos, arange, -1), dims.sliding_window
    out = _attend_block(q, cache["k"], cache["v"], pos.reshape(1), k_positions, dims.groups,
                        window)
    out = matmul(layers.merge_last(out), params["w_o"])
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
    out = matmul(layers.merge_last(out), params["w_o"])
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
    if is_dtensor(c_kv):  # padded to the cache's length, as ``prefill_into_cache``
        pad = (0, 0, 0, cache["c_kv"].shape[1] - S)
        for name, t in (("c_kv", c_kv), ("k_pe", k_pe)):
            cache[name] = local_map(lambda t_: torch.nn.functional.pad(t_, pad),
                                    (t.to(cache[name].dtype),), (("b", None, None),),
                                    (("b", None, None),))
    else:
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
    (O(S * (lora + rope_dim)) per head), and ``W_uv`` maps the mix out.
    Under a mesh a latent cache split along its sequence stays split: each
    device mixes its own positions under the softmax's global max and sum,
    as ``_attend_shard`` does."""
    B, S_cache = c_kv.shape[0], c_kv.shape[1]
    H = dims.num_heads
    bf16 = torch.bfloat16
    w_uk = params["w_uk"].reshape(dims.kv_lora_rank, H, dims.qk_nope_head_dim)
    q_lat = einsum("bhd,rhd->bhr", q_nope[:, 0].to(bf16), w_uk.to(bf16))
    split = split_dims(c_kv, 1)
    if split:
        reduce = _shard_reduce(c_kv.device_mesh, split)

        def shard(c_, kp_, ql_, qpe_, pos_, keys_):
            scores, _ = _mla_scores(ql_, qpe_, c_, kp_, keys_, pos_, dims)
            e = torch.exp(scores - reduce(scores.amax(dim=-1, keepdim=True), "max"))
            probs = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(c_.dtype)
            return _mix(probs, c_, "bhs,bsr->bhr", reduce)

        keys = torch.arange(S_cache, dtype=torch.int32, device=c_kv.to_local().device)
        out_lat = local_map(shard, (c_kv, k_pe, q_lat, q_pe[:, 0], pos, keys),
                            (("b", "s", None), ("b", "s", None), ("b", "h", None),
                             ("b", "h", None), ("b",), ("s",)), (("b", "h", None),))
    else:
        keys = torch.arange(S_cache, device=c_kv.device)
        scores, _ = _mla_scores(q_lat, q_pe[:, 0], c_kv, k_pe, keys, pos, dims)
        probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
        out_lat = einsum("bhs,bsr->bhr", probs, c_kv)  # [B, H, lora]
    w_uv = params["w_uv"].reshape(dims.kv_lora_rank, H, dims.v_head_dim)
    out = einsum("bhr,rhd->bhd", out_lat, w_uv.to(out_lat.dtype))
    return matmul(out.reshape(B, 1, H * dims.v_head_dim), params["w_o"])


def _mla_scores(q_lat, q_pe, c_kv, k_pe, keys, pos, dims: MlaDims):
    """The absorbed scores [B, H, S] f32 of positions ``keys`` [S] (masked
    past each row's ``pos``) and the validity [B, S]."""
    scores = einsum("bhr,bsr->bhs", q_lat, c_kv).float()
    scores = scores + torch.einsum("bhd,bsd->bhs", q_pe.float(), k_pe.float())
    scores = scores / math.sqrt(dims.qk_head_dim)
    valid = keys[None, :] <= pos[:, None]  # [B, S]
    return torch.where(valid[:, None, :], scores, NEG_INF), valid


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
    if is_dtensor(cache["c_kv"]):
        at = torch.arange(cache["c_kv"].shape[1], device=x.device) == pos
        _masked_seq_write(cache["c_kv"], c_new, at)
        _masked_seq_write(cache["k_pe"], kpe_new, at)
    else:
        _cache_write_ragged(cache["c_kv"], c_new, pos.expand(B))
        _cache_write_ragged(cache["k_pe"], kpe_new, pos.expand(B))
    new_cache = dict(cache, pos=pos + 1)
    out = _mla_absorbed_attend(
        params, q_nope, q_pe, cache["c_kv"], cache["k_pe"], pos.expand(B), dims
    )
    return out, new_cache
