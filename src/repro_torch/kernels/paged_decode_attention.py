"""Flash-decode through a block table over a paged KV pool.

The counterpart of ``repro.kernels.paged_decode_attention``.  On a CUDA
tensor the wrapper launches the hand-written kernel in
``csrc/paged_decode_attention.cu`` (the dense kernel's walk, with each key
row reached through ``table``, read once per 32-key tile, and its chunks of
at most 16 query heads per KV head where G is larger); on a CPU tensor it
runs the plain version in ``ref``.  There is no other path: a CUDA tensor
the kernel cannot take raises.

Key ``t`` of row ``b`` lives at pool row ``table[b, t // bs]``, offset
``t % bs``.  The walk covers ``[0, min(lengths[b], seq_len, n_logical *
bs))``; table entries past a row's length may point anywhere (the engine
points them at the trash block) and are never read.  As in the Pallas
kernel, a row whose length is 0 returns zeros.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import (HEAD_DIMS, SPLIT_KEYS, _ptr, split_groups,
                                                  split_scratch)


def _lib():
    lib = build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hq, hd]
    k_pool: torch.Tensor,  # [NB, bs, KVH, hd]
    v_pool: torch.Tensor,  # [NB, bs, KVH, hd]
    table: torch.Tensor,  # [B, n_logical] int32
    lengths: torch.Tensor,  # [B] int32, valid prefix of each row
    seq_len: int | None = None,
) -> torch.Tensor:
    """``seq_len`` cuts every row's view at that length, as the serving path
    asks: the plain version slices its gathered cache there, and the kernel
    walks ``min(lengths, seq_len)`` keys of each row, which gives it the
    dense kernel's walk on the sliced cache."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, seq_len=seq_len)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_pool, v_pool, table, lengths)):
        raise ValueError("paged_decode_attention: all inputs must share one CUDA device")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise TypeError(
            f"paged_decode_attention kernel takes bf16, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention: table and lengths must be int32, got "
                        f"{table.dtype} and {lengths.dtype}")
    B, Hq, hd = q.shape
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != hd:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    if table.ndim != 2 or table.shape[0] != B or table.shape[1] < 1 or lengths.shape != (B,):
        raise ValueError(f"paged_decode_attention: table {tuple(table.shape)}, lengths "
                         f"{tuple(lengths.shape)} for batch {B}")
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    if Hq % KVH != 0:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {KVH}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel takes hd in {HEAD_DIMS}; got hd {hd}")
    for t in (q, k_pool, v_pool, table, lengths):
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention: inputs must be contiguous")
    for t in (q, k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("paged_decode_attention: q, k_pool, v_pool must be 16-byte aligned")

    def launch(qc: torch.Tensor) -> torch.Tensor:
        out = torch.empty(qc.shape, dtype=torch.bfloat16, device=dev)
        _launch(qc, k_pool, v_pool, table, lengths, out, seq_len)
        paged_decode_attention.launches += 1
        return out

    return split_groups(q, KVH, launch)


def _launch(q, k_pool, v_pool, table, lengths, out, seq_len: int | None = None,
            combine: bool = True) -> None:
    """The C entry on checked inputs: the kernel walks a view of S =
    ``min(seq_len, n_logical * bs)`` positions of every row, so it cuts the
    lengths at ``seq_len`` itself.  ``combine=False`` leaves out the combine
    over splits: a planted fault for the card's gates."""
    B, Hq, hd = q.shape
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    n_logical = table.shape[1]
    S = n_logical * bs if seq_len is None else max(0, min(seq_len, n_logical * bs))
    part_o, part_lse = split_scratch(B, S, KVH, Hq // KVH, hd, q.device)
    err = _lib()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _ptr(part_o), _ptr(part_lse), B, n_logical, bs, S, KVH, Hq // KVH, hd,
        SPLIT_KEYS, int(combine), float(1.0 / math.sqrt(hd)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")


paged_decode_attention.launches = 0
