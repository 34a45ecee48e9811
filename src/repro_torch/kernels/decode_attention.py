"""Flash-decode: one query token per row against a [B, S, KVH, hd] cache.

The counterpart of ``repro.kernels.decode_attention``.  On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/decode_attention.cu``
(one walk for every G up to 16: one CTA per (row, KV head, split of
``SPLIT_KEYS`` keys) on the tensor cores, plus a combine over the splits),
online softmax over the valid prefix; on a CPU tensor it runs the plain
version in ``ref``.  There is no other path: a CUDA tensor the kernel cannot
take raises.  A G above 16 is launched in chunks of at most 16 query heads
per KV head (``split_groups``), each chunk reading the same K/V.

As in the Pallas kernel, a row whose length is 0 returns zeros.

``decode_attention_partial`` launches the same kernel for the partial of one
sequence shard of a cache split over devices: each query row's output in
f32 before its bf16 cast and its log-sum-exp (-inf at length 0), which
``ops.combine_partials`` weighs across the shards as the kernel's own
combine weighs its splits.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 80, 128)
# Query heads per KV head one launch of the walk takes at most: the walk
# puts a KV head's G query heads on the first G of its tensor-core tiles' 16
# M rows.  The wrappers take any G, in chunks of at most ``MMA_G``
# (``split_groups``).
MMA_G = 16
# Keys per split of the walk: a multiple of its 32-key warp tile.  Fixed, so
# a row's splits, and so its output, depend on its own length only.
SPLIT_KEYS = 512


def split_bounds(length: int) -> list[tuple[int, int]]:
    """The key ranges ``[start, end)`` the walk gives its CTAs for a row
    of ``length`` keys, in the order the combine adds them.  A row of length
    0 keeps one empty split, whose CTA writes zeros."""
    n = max(1, -(-length // SPLIT_KEYS))
    return [(i * SPLIT_KEYS, min(length, (i + 1) * SPLIT_KEYS)) for i in range(n)]


def split_scratch(B: int, S: int, kvh: int, G: int, hd: int, device):
    """The walk's per-split partials for a cache of S positions and G query
    heads per KV head: (o [B, kvh, n, G, hd], lse [B, kvh, n, G]) in f32,
    with n the most splits a row of length <= S can have; (None, None) when
    that is one, since then every row writes its output directly."""
    n = len(split_bounds(S))
    if n == 1:
        return None, None
    return (torch.empty((B, kvh, n, G, hd), dtype=torch.float32, device=device),
            torch.empty((B, kvh, n, G), dtype=torch.float32, device=device))


def split_groups(q: torch.Tensor, kvh: int, launch):
    """``launch`` over chunks of at most ``MMA_G`` query heads per KV head.

    ``q`` is [B, kvh * G, hd], query head ``h * G + g`` belonging to KV head
    ``h``.  For G <= ``MMA_G`` this is ``launch(q)``.  Above, the G heads of
    every KV head are cut into ``ceil(G / MMA_G)`` chunks of ``MMA_G`` heads
    (the last one shorter); ``launch`` gets each chunk as a contiguous [B,
    kvh * g, hd] query (g heads per KV head, the same K/V) and returns its
    [B, kvh * g, ...] output (or a tuple of such), which lands in the
    chunk's heads of the result.  A query head's output depends on its own
    row of scores alone, so the split changes no value.
    """
    B, Hq, hd = q.shape
    G = Hq // kvh
    if G <= MMA_G:
        return launch(q)
    qg = q.view(B, kvh, G, hd)
    outs = None
    for g0 in range(0, G, MMA_G):
        g = min(MMA_G, G - g0)
        chunk = launch(qg[:, :, g0:g0 + g].reshape(B, kvh * g, hd).contiguous())
        chunk = chunk if isinstance(chunk, tuple) else (chunk,)
        if outs is None:
            outs = tuple(c.new_empty((B, kvh, G) + c.shape[2:]) for c in chunk)
        for o, c in zip(outs, chunk):
            o[:, :, g0:g0 + g] = c.view((B, kvh, g) + c.shape[2:])
    outs = tuple(o.view((B, Hq) + o.shape[3:]) for o in outs)
    return outs if len(outs) > 1 else outs[0]


def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def decode_attention(
    q: torch.Tensor,  # [B, Hq, hd]
    k: torch.Tensor,  # [B, S, KVH, hd]
    v: torch.Tensor,  # [B, S, KVH, hd]
    lengths: torch.Tensor,  # [B] int32, valid prefix of each cache row
) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    KVH = _checked(q, k, v, lengths)

    def launch(qc: torch.Tensor) -> torch.Tensor:
        out = torch.empty(qc.shape, dtype=torch.bfloat16, device=q.device)
        _launch(qc, k, v, lengths, out)
        decode_attention.launches += 1
        return out

    return split_groups(q, KVH, launch)


def decode_attention_partial(
    q: torch.Tensor,  # [B, Hq, hd]
    k: torch.Tensor,  # [B, S, KVH, hd]
    v: torch.Tensor,  # [B, S, KVH, hd]
    lengths: torch.Tensor,  # [B] int32, valid prefix of each cache row
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Hq, hd] f32, lse [B, Hq] f32): ``decode_attention``'s output
    before its bf16 cast and each row's log-sum-exp of the scaled scores; a
    row of length 0 gives (0, -inf).  The same kernel (its launches count in
    ``decode_attention.launches``), writing no bf16 output."""
    if q.device.type == "cpu":
        return ref.decode_attention_partial_ref(q, k, v, lengths)
    KVH = _checked(q, k, v, lengths)

    def launch(qc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        o = torch.empty(qc.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty(qc.shape[:2], dtype=torch.float32, device=q.device)
        _launch(qc, k, v, lengths, None, out_f32=o, lse=lse)
        decode_attention.launches += 1
        return o, lse

    return split_groups(q, KVH, launch)


def _checked(q, k, v, lengths) -> int:
    """The number of KV heads of inputs the kernel takes; raises otherwise."""
    build.refuse_grad("decode_attention", q, k, v)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, lengths)):
        raise ValueError("decode_attention: q, k, v and lengths must share one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"decode_attention kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: lengths must be int32, got {lengths.dtype}")
    B, Hq, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)} for batch {B}")
    KVH = k.shape[2]
    if Hq % KVH != 0:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {KVH}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes hd in {HEAD_DIMS}; got hd {hd}")
    for t in (q, k, v, lengths):
        if not t.is_contiguous():
            raise ValueError("decode_attention: inputs must be contiguous")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: q, k, v must be 16-byte aligned")
    return KVH


def _launch(q, k, v, lengths, out, combine: bool = True, out_f32=None, lse=None) -> None:
    """The C entry on checked inputs; ``out`` (bf16), ``out_f32`` and
    ``lse`` may each be None (not written).  ``combine=False`` leaves out
    the combine over splits: a planted fault for the card's gates, which
    rows with more than one split must fail."""
    B, Hq, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    part_o, part_lse = split_scratch(B, S, KVH, Hq // KVH, hd, q.device)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), _ptr(out),
        _ptr(part_o), _ptr(part_lse), _ptr(out_f32), _ptr(lse), B, S, KVH, Hq // KVH, hd,
        SPLIT_KEYS, int(combine), float(1.0 / math.sqrt(hd)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")


decode_attention.launches = 0
