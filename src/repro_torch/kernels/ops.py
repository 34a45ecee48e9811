"""Dispatch to the port's kernels, mirroring ``repro.kernels.ops``.

Backends:
  * "auto"  — the CUDA kernel for a CUDA tensor, the plain version for a CPU
              tensor (the wrappers decide by the tensor's device, nothing
              else).
  * "cuda"  — the CUDA kernel; a CPU tensor raises.
  * "torch" — the plain PyTorch version on any device (the reference the
              kernels are held to on the card).
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import exit_confidence as _exit
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref

Backend = Literal["auto", "cuda", "torch"]
BACKENDS = ("auto", "cuda", "torch")

_backend: Backend = "auto"


def set_backend(backend: Backend) -> None:
    global _backend
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    _backend = backend


def get_backend() -> str:
    return _backend


def _plain(x: torch.Tensor) -> bool:
    if _backend == "torch":
        return True
    if _backend == "cuda" and not x.is_cuda:
        raise ValueError(f"kernel backend 'cuda' was asked for a tensor on {x.device}")
    return False


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether the current backend launches a kernel for a tensor like
    ``x``: True for a CUDA tensor under "auto" or "cuda", False under
    "torch" or for a CPU tensor under "auto"; "cuda" on a CPU tensor
    raises, as every op does."""
    return not _plain(x) and x.is_cuda


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Prefill attention, top-left positions (see ``ref.flash_attention_ref``)."""
    if _plain(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    if _plain(q):
        return ref.decode_attention_ref(q, k, v, lengths)
    return _dec.decode_attention(q, k, v, lengths)


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    seq_len: int | None = None,
) -> torch.Tensor:
    """Flash decode through a block table over a paged KV pool.

    The plain path gathers the rows' blocks into a contiguous cache sliced
    to ``seq_len``, the exact shape of the dense slot path, so paged and
    dense decode stay bitwise identical there.  The kernel walks the pool
    through the table and never gathers.
    """
    if _plain(q):
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, seq_len=seq_len)
    return _paged.paged_decode_attention(q, k_pool, v_pool, table, lengths, seq_len=seq_len)


def exit_confidence(h: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if _plain(h):
        return ref.exit_confidence_ref(h, w)
    return _exit.exit_confidence(h, w)
