"""Flash-decode: one query token per row against a [B, S, KVH, hd] cache.

The counterpart of ``repro.kernels.decode_attention``.  On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/decode_attention.cu``
(one walk for every G: one CTA per (row, KV head, split of ``SPLIT_KEYS``
keys) on the tensor cores, plus a combine over the splits), online softmax
over the valid prefix; on a CPU tensor it runs the plain version in
``ref``.  There is no other path: a CUDA tensor the kernel cannot take
raises.

As in the Pallas kernel, a row whose length is 0 returns zeros.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128)
GROUPS = (1, 2, 4, 8, 16)  # query heads per KV head the kernel takes
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


def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
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
    S, KVH = k.shape[1], k.shape[2]
    if Hq % KVH != 0:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {KVH}")
    G = Hq // KVH
    if hd not in HEAD_DIMS or G not in GROUPS:
        raise ValueError(f"decode_attention kernel takes hd in {HEAD_DIMS}, G in {GROUPS}; got {hd}, {G}")
    for t in (q, k, v, lengths):
        if not t.is_contiguous():
            raise ValueError("decode_attention: inputs must be contiguous")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: q, k, v must be 16-byte aligned")
    out = torch.empty((B, Hq, hd), dtype=torch.bfloat16, device=dev)
    _launch(q, k, v, lengths, out)
    decode_attention.launches += 1
    return out


def _launch(q, k, v, lengths, out, combine: bool = True) -> None:
    """The C entry on checked inputs.  ``combine=False`` leaves out the
    combine over splits: a planted fault for the card's gates, which rows
    with more than one split must fail."""
    B, Hq, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    part_o, part_lse = split_scratch(B, S, KVH, Hq // KVH, hd, q.device)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _ptr(part_o), _ptr(part_lse), B, S, KVH, Hq // KVH, hd, SPLIT_KEYS, int(combine),
        float(1.0 / math.sqrt(hd)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")


decode_attention.launches = 0
