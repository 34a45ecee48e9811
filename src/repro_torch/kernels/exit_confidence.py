"""Fused early-exit confidence head: (top-1 softmax prob, argmax) of h @ w.

The counterpart of ``repro.kernels.exit_confidence``.  On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/exit_confidence.cu``
(tensor cores, a TMA ring, at most one CTA per SM over a contiguous vocab
range, one (max, sum-exp, argmax) partial per (row, CTA), an in-order
combine), one pass over w per 64 batch rows; on a CPU tensor it runs the
plain version in ``ref``.  There is no other path: a CUDA tensor the kernel
cannot take raises.  ``grid_ctas``, ``vocab_ranges`` and ``batch_passes``
are the kernel's split of the vocab and the batch, written out so that the
CPU tests reach it (``ref.exit_confidence_split_ref`` runs the plain
version over it).

``exit_confidence_partial`` launches the same kernel for one vocab shard of
a head split over devices: it also hands back each row's max logit m, with
which the row's log-sum-exp is m - log(conf) (``ops.combine_exit_partials``
combines the shards).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_ROWS = 64  # batch rows per pass over w: wgmma's N at most
# vocab columns per unit of the split: one 128-byte row of a TMA box, so
# every box starts on a 128-byte boundary of w (at 16-byte offsets the loads
# ran at 55-63% of the bound, against 78-90% aligned); the kernel's UNIT
# (csrc/exit_confidence.cu)
UNIT = 64

_sm_count: dict[int, int] = {}


def batch_passes(B: int) -> list[tuple[int, int]]:
    """The batch rows ``[r0, r1)`` of each launch, in order, at most
    ``MAX_ROWS`` each: one pass over w for every B <= 64."""
    return [(r, min(B, r + MAX_ROWS)) for r in range(0, B, MAX_ROWS)]


def vocab_ranges(V: int, n_ctas: int) -> list[tuple[int, int]]:
    """CTA i's vocab columns ``[lo, hi)``: lo = min(V, floor(i * U /
    n_ctas) * UNIT) with U = ceil(V / UNIT) units, as the kernel computes
    them.  Contiguous, ascending, edges on units (the last at V), widths
    within one unit of each other, empty only when U < n_ctas."""
    units = -(-V // UNIT)
    return [(min(V, i * units // n_ctas * UNIT), min(V, (i + 1) * units // n_ctas * UNIT))
            for i in range(n_ctas)]


def grid_ctas(V: int, n_sm: int) -> int:
    """The persistent grid for a vocab of V on ``n_sm`` SMs: the fewest CTAs
    that still leave each at most q = ceil(U / n_sm) of the U units (the
    slowest CTA's work is that of a full grid), but not below 90% of the
    SMs.  Fewer CTAs then sit idle while the last units are read: at
    deepseek-v2-lite-16b's V 102400 (1600 units, q 13) 132 CTAs leave 16 of
    them a 13th unit and 116 slots idle, 124 CTAs leave 12."""
    units = -(-V // UNIT)
    q = -(-units // n_sm)
    return max(-(-9 * n_sm // 10), -(-units // q))


def _ctas(dev: torch.device) -> int:
    """The SM count of ``dev``: one persistent CTA per SM."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sm_count:
        _sm_count[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sm_count[i]


def _lib():
    lib = build.load("exit_confidence")
    fn = lib.exit_confidence_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def exit_confidence(h: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h [B, d], w [d, V] -> (conf [B] f32, argmax [B] i32)."""
    if h.device.type == "cpu":
        return ref.exit_confidence_ref(h, w)
    return _run(h, w, False)


def exit_confidence_partial(h: torch.Tensor, w: torch.Tensor):
    """h [B, d], w [d, V] -> (conf [B] f32, argmax [B] i32, max logit [B]
    f32): ``exit_confidence`` and each row's max logit, from the same kernel
    (its launches count in ``exit_confidence.launches``)."""
    if h.device.type == "cpu":
        return ref.exit_confidence_partial_ref(h, w)
    return _run(h, w, True)


def _run(h: torch.Tensor, w: torch.Tensor, with_max: bool):
    build.refuse_grad("exit_confidence", h, w)
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
    if B < 1 or V < 1 or d < 1:
        raise ValueError("exit_confidence: empty batch, width or vocab")
    # TMA reads w in rows of V elements: a row stride of 16-byte multiples
    # from a 16-byte aligned base
    if V % 8 != 0 or w.data_ptr() % 16 != 0:
        raise ValueError(f"exit_confidence kernel needs V % 8 == 0 and a 16-byte aligned w, "
                         f"got V={V} at offset {w.data_ptr() % 16}")
    if d % 8 != 0 or h.data_ptr() % 16 != 0:
        # the same rule for h's rows: a zero-padded aligned copy (B x d,
        # small beside w); the padded columns meet w's zero fill past d
        hp = torch.zeros((B, -(-d // 8) * 8), dtype=h.dtype, device=h.device)
        hp[:, :d] = h
        h = hp
    fn = _lib()
    n = grid_ctas(V, _ctas(h.device))
    # the partials m, l, argmax [B, n] each, then conf, idx and (with_max)
    # the max logit [B], in one allocation of 4-byte words (the serve is
    # host-bound: one allocation, the partials by address)
    buf = torch.empty(3 * B * n + (3 if with_max else 2) * B, dtype=torch.float32,
                      device=h.device)
    conf = buf[3 * B * n: 3 * B * n + B]
    idx = buf[3 * B * n + B: 3 * B * n + 2 * B].view(torch.int32)
    mx = buf[3 * B * n + 2 * B:] if with_max else None
    base, part_bytes = buf.data_ptr(), 4 * B * n
    stream = torch.cuda.current_stream(h.device).cuda_stream
    for r0, r1 in batch_passes(B):
        err = fn(
            h.data_ptr(), w.data_ptr(), base, base + part_bytes, base + 2 * part_bytes,
            conf.data_ptr(), idx.data_ptr(), None if mx is None else mx.data_ptr(), B, d,
            h.shape[1], V, r0, r1 - r0, n, stream,
        )
        if err != 0:
            raise RuntimeError(f"exit_confidence kernel launch failed: cudaError {err}")
        exit_confidence.launches += 1
    return (conf, idx, mx) if with_max else (conf, idx)


exit_confidence.launches = 0
