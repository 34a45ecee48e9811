"""Prefill flash attention: q [B, Sq, Hq, hd] against k, v [B, Sk, KVH, hd].

The counterpart of ``repro.kernels.flash_attention``.  On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/flash_attention.cu``
(bf16: one CTA per (128 query rows, query head, batch row), a producer warp
loading K/V tiles by TMA and two consumer warpgroups on ``wgmma``; f32: CUDA
cores; online softmax over the key tiles of the causal/window band); on a
CPU tensor it runs the plain version in ``ref``.  There is no other
path: a CUDA tensor the kernel cannot take raises.

Positions are top-left: query i and key j sit at positions i and j, also
when Sk > Sq.  As in the Pallas kernel, the scores are scaled by a multiply
and a fully masked row gives zeros (the plain version divides, and gives
such a row the mean of V).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 80, 96, 128)
_ENTRY = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}


def _lib(dtype: torch.dtype):
    fn = getattr(build.load("flash_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, hd]
    k: torch.Tensor,  # [B, Sk, KVH, hd]
    v: torch.Tensor,  # [B, Sk, KVH, hd]
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k and v must share one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention kernel takes bf16 or f32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if Hq % KVH != 0:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {KVH}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    fn = _lib(q.dtype)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, Hq, KVH, hd, int(causal), window or 0, float(1.0 / math.sqrt(hd)), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
