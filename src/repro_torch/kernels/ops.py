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
version because of the mesh) and wraps the result over the same mesh.  Two
splits stay where they lie and their partials are combined instead, as the
reference's compiled program does:
  * a KV cache split along its sequence (``cache_specs``): each device runs
    the decode kernel on its own keys for every query head
    (``decode_attention_partial``: the f32 output and the log-sum-exp), the
    shards' partials are all-gathered (n B H (hd + 1) f32) and weighed by
    ``combine_partials``: split-KV flash-decode;
  * an LM head split along its vocab (``param_specs``): each device runs the
    exit kernel on its columns (``exit_confidence_partial``: also the max
    logit), and ``combine_exit_partials`` adds the shards' sums and keeps the
    first shard's argmax on ties, the kernel's own rule.
"""
from __future__ import annotations

import math
from typing import Literal

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import exit_confidence as _exit
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.sharding import is_dtensor, local_map, split_dims

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
# a KV cache [B, S, KVH, hd] whose sequence split stays
_KV = ("b", "s", "h", None)


def combine_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Attention partials of n sequence shards, o [n, B, ...] f32 and lse
    [n, B, ...] f32 (o with one more trailing dim), into the f32 output
    over all the keys, for the caller to cast once: each shard weighed by
    exp(lse - max lse), summed in f32.  A shard with lse -inf (none of the
    row's keys) weighs 0; a row no shard holds a key of gives zeros.  A
    plain reduction (the reference leaves it to XLA), not a kernel."""
    m = lse.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse - m)
    den = w.sum(dim=0)
    num = (o * w[..., None]).sum(dim=0)
    return num / torch.where(den > 0, den, 1.0)[..., None]


def combine_exit_partials(conf: torch.Tensor, idx: torch.Tensor, m: torch.Tensor):
    """The exit head's partials of n vocab shards, conf, idx (global column
    indices) and max logit m, each [n, B], into (conf [B] f32, argmax [B]
    i32) over the whole vocab: m* = max m_i, conf = 1 / sum_i exp(m_i - m*)
    / conf_i, and the argmax of the first shard whose max is m* (the
    kernel's first-index rule on ties)."""
    top = m.amax(dim=0)
    conf = 1.0 / (torch.exp(m - top) / conf).sum(dim=0)
    first = (m == top).to(torch.int32).argmax(dim=0)
    return conf, torch.gather(idx, 0, first[None])[0].to(torch.int32)


def gather_shards(x):
    """The DTensor ``x`` with its leading (shard) dim replicated: the
    all-gather of each device's partial."""
    from torch.distributed.tensor import Replicate

    keep = set(split_dims(x, 0))
    return x.redistribute(x.device_mesh, [Replicate() if i in keep else p
                                          for i, p in enumerate(x.placements)])


def _arange_like(n: int, x) -> torch.Tensor:
    """``arange(n)`` int32 on the device of the DTensor ``x``'s shards: with
    role "s" or "v" in ``local_map`` each device receives its own indices,
    the first of which is its shard's offset."""
    return torch.arange(n, dtype=torch.int32, device=x.to_local().device)


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
        if split_dims(k, 1):
            return _split_kv_decode(q, k, v, lengths)
        return local_map(decode_attention, (q, k, v, lengths),
                         (("b", "h", None), _QKV, _QKV, ("b",)), (("b", "h", None),))
    if _plain(q):
        return ref.decode_attention_ref(q, k, v, lengths)
    return _dec.decode_attention(q, k, v, lengths)


def decode_attention_partial(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Hq, hd] f32, lse [B, Hq] f32) of plain tensors: the decode
    output before its cast and its log-sum-exp (see
    ``ref.decode_attention_partial_ref``)."""
    if _plain(q):
        return ref.decode_attention_partial_ref(q, k, v, lengths)
    return _dec.decode_attention_partial(q, k, v, lengths)


def _split_kv_decode(q, k, v, lengths):
    """Decode against a cache split along its sequence: each device's keys
    for all of its rows' query heads, a shard's valid length ``lengths``
    less its first key's position clamped to [0, S_local]; the partials
    all-gathered and combined."""

    def partial(k_, v_, q_, len_, keys_):
        local = (len_ - keys_[0]).clamp(0, k_.shape[1]).to(torch.int32).contiguous()
        o, lse = decode_attention_partial(q_.contiguous(), k_.contiguous(), v_.contiguous(),
                                          local)
        return o[None], lse[None]

    o, lse = local_map(partial, (k, v, q, lengths, _arange_like(k.shape[1], k)),
                       (_KV, _KV, ("b", "h", None), ("b",), ("s",)),
                       (("s", "b", "h", None), ("s", "b", "h")))
    return local_map(lambda o_, lse_: combine_partials(o_, lse_).to(torch.bfloat16),
                     (gather_shards(o), gather_shards(lse)),
                     ((None, "b", "h", None), (None, "b", "h")), (("b", "h", None),))


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
        if _vocab_splits(w):
            return _split_vocab_head(h, w)
        return local_map(exit_confidence, (h, w), (("b", None), (None, None)), (("b",), ("b",)))
    if _plain(h):
        return ref.exit_confidence_ref(h, w)
    return _exit.exit_confidence(h, w)


def exit_confidence_partial(h: torch.Tensor, w: torch.Tensor):
    """(conf, argmax, max logit), each [B], of plain tensors (see
    ``ref.exit_confidence_partial_ref``)."""
    if _plain(h):
        return ref.exit_confidence_partial_ref(h, w)
    return _exit.exit_confidence_partial(h, w)


def _vocab_splits(w) -> bool:
    """Whether the DTensor head ``w`` [d, V] is split along its vocab into
    even shards (otherwise the vocab is gathered).  The kernel takes a
    shard of any width (``exit_confidence.w_piece``)."""
    dims = split_dims(w, 1)
    n = math.prod(w.device_mesh.size(i) for i in dims)
    return bool(dims) and w.shape[1] % n == 0


def _split_vocab_head(h, w):
    """The exit head on an LM head split along its vocab: each device's
    columns for its rows (the kernel's partial, its argmax offset by its
    shard's first column), the partials all-gathered (3 n B words) and
    combined."""

    def partial(h_, w_, ids_):
        conf, idx, m = exit_confidence_partial(h_.contiguous(), w_.contiguous())
        return conf[None], (idx + ids_[0])[None], m[None]

    conf, idx, m = local_map(partial, (h, w, _arange_like(w.shape[1], w)),
                             (("b", None), (None, "v"), ("v",)), (("v", "b"),) * 3)
    return local_map(combine_exit_partials, tuple(gather_shards(t) for t in (conf, idx, m)),
                     ((None, "b"),) * 3, (("b",), ("b",)))
