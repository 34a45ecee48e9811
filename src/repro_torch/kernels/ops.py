"""Dispatch to the port's kernels, mirroring ``repro.kernels.ops``.

Backends:
  * "auto"  — the CUDA kernel for a CUDA tensor, the plain version for a CPU
              tensor (the wrappers decide by the tensor's device, nothing
              else).
  * "cuda"  — the CUDA kernel; a CPU tensor raises.
  * "torch" — the plain PyTorch version on any device (the reference the
              kernels are held to on the card).

A meta tensor (the dry run, ``launch.dryrun``) takes the plain version
under every backend: it computes shapes alone.

Under a device mesh a wrapper is handed DTensors.  It brings each argument
to a layout where the op is local (``sharding.local_map``): a mesh axis that shards
the batch rows of every batched argument, or the heads of every head-split
argument (q's query heads together with K/V's KV heads, so each device keeps
whole GQA groups), stays; any other axis is gathered.  It then runs itself
on the local shards (the hand-written kernel on the card, never the plain
version because of the mesh) and wraps the result over the same mesh.  The
exit head gathers ``w``'s vocab (``param_specs`` splits it over "model")
and runs the kernel on its rows' shard, so its confidences and tokens are
the unsharded kernel's, bit for bit.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import exit_confidence as _exit
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.sharding import is_dtensor, local_map

Backend = Literal["auto", "cuda", "torch"]
# head dims the decode kernels take (dense and paged)
DECODE_HEAD_DIMS = _dec.HEAD_DIMS
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
    if _backend == "torch" or x.is_meta:
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


def _is_dtensor(args) -> bool:
    return any(is_dtensor(a) for a in args)


_QKV = ("b", None, "h", None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Prefill attention, top-left positions (see ``ref.flash_attention_ref``)."""
    if _is_dtensor((q, k, v)):
        fn = lambda q, k, v: flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        return local_map(fn, (q, k, v), (_QKV,) * 3, (_QKV,))
    if _plain(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    if _is_dtensor((q, k, v, lengths)):
        return local_map(decode_attention, (q, k, v, lengths),
                         (("b", "h", None), _QKV, _QKV, ("b",)), (("b", "h", None),))
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
    if _is_dtensor((q, k_pool, v_pool, table, lengths)):
        pool = (None, None, "h", None)
        fn = lambda *a: paged_decode_attention(*a, seq_len=seq_len)  # noqa: E731
        return local_map(fn, (q, k_pool, v_pool, table, lengths),
                         (("b", "h", None), pool, pool, ("b", None), ("b",)),
                         (("b", "h", None),))
    if _plain(q):
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, seq_len=seq_len)
    return _paged.paged_decode_attention(q, k_pool, v_pool, table, lengths, seq_len=seq_len)


def exit_confidence(h: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if _is_dtensor((h, w)):
        return local_map(exit_confidence, (h, w), (("b", None), (None, None)), (("b",), ("b",)))
    if _plain(h):
        return ref.exit_confidence_ref(h, w)
    return _exit.exit_confidence(h, w)
