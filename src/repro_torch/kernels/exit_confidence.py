"""Fused early-exit confidence head: (top-1 softmax prob, argmax) of h @ w.

The counterpart of ``repro.kernels.exit_confidence``.  On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/exit_confidence.cu``
(vocab tiles across CTAs, a per-tile (max, sum-exp, argmax) partial, an
in-order combine); on a CPU tensor it runs the plain version in ``ref``.
There is no other path: a CUDA tensor the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SMEM_LIMIT = 227 * 1024
_ROWS = 8  # batch rows staged in shared memory per CTA (csrc ROWS)


def _lib():
    lib = build.load("exit_confidence")
    fn = lib.exit_confidence_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def exit_confidence(h: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h [B, d], w [d, V] -> (conf [B] f32, argmax [B] i32)."""
    if h.device.type == "cpu":
        return ref.exit_confidence_ref(h, w)
    if h.device.type != "cuda" or w.device != h.device:
        raise ValueError(f"exit_confidence: h on {h.device}, w on {w.device}")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"exit_confidence kernel takes bf16, got {h.dtype} and {w.dtype}")
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"exit_confidence: shapes {tuple(h.shape)} @ {tuple(w.shape)}")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("exit_confidence: h and w must be contiguous")
    B, d = h.shape
    V = w.shape[1]
    if B < 1 or V < 1:
        raise ValueError("exit_confidence: empty batch or vocab")
    if V % 8 != 0 or w.data_ptr() % 16 != 0:  # the kernel reads w in 16-byte rows of 8
        raise ValueError(f"exit_confidence kernel needs V % 8 == 0 and a 16-byte aligned w, "
                         f"got V={V} at offset {w.data_ptr() % 16}")
    if d * _ROWS * 2 > _SMEM_LIMIT:
        raise ValueError(f"exit_confidence: d={d} exceeds the kernel's shared-memory stage")
    fn = _lib()
    nt = -(-V // 256)
    part_m = torch.empty((B, nt), dtype=torch.float32, device=h.device)
    part_l = torch.empty((B, nt), dtype=torch.float32, device=h.device)
    part_i = torch.empty((B, nt), dtype=torch.int32, device=h.device)
    conf = torch.empty((B,), dtype=torch.float32, device=h.device)
    idx = torch.empty((B,), dtype=torch.int32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(
        h.data_ptr(), w.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_i.data_ptr(), conf.data_ptr(), idx.data_ptr(), B, d, V, stream,
    )
    if err != 0:
        raise RuntimeError(f"exit_confidence kernel launch failed: cudaError {err}")
    exit_confidence.launches += 1
    return conf, idx


exit_confidence.launches = 0
