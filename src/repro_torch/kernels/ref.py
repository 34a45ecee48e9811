"""Plain PyTorch versions of the ported kernels, op for op with
``repro.kernels.ref``.

They are the ground truth the CUDA kernels are held to on the card, and
what the kernel wrappers run for tensors that lie on the CPU.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, Hq, hd]
    k: torch.Tensor,  # [B, Sk, kv, hd]
    v: torch.Tensor,  # [B, Sk, kv, hd]
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Prefill attention with top-left positions (``q_pos`` and ``k_pos``
    both start at 0, also when Sk > Sq).  The scores are DIVIDED by
    sqrt(hd), as this oracle does in the reference (the kernels multiply);
    a fully masked row gives the mean of V (the kernels give zeros)."""
    B, Sq, Hq, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(B, Sq, kvh, Hq // kvh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, Hq, hd)


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hq, hd]
    k: torch.Tensor,  # [B, S, kv, hd]
    v: torch.Tensor,  # [B, S, kv, hd]
    lengths: torch.Tensor,  # [B] valid prefix length of each cache row
) -> torch.Tensor:
    B, Hq, hd = q.shape
    kvh = k.shape[2]
    G = Hq // kvh
    qg = q.reshape(B, kvh, G, hd)
    # * (1/sqrt) rather than /sqrt, as the reference and the kernels scale
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k).float() * float(1.0 / math.sqrt(hd))
    valid = torch.arange(k.shape[1], device=k.device)[None, :] < lengths[:, None]  # [B, S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    # probabilities are normalised in f32, then cast to v's dtype
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return out.reshape(B, Hq, hd)


def decode_attention_partial_ref(
    q: torch.Tensor,  # [B, Hq, hd]
    k: torch.Tensor,  # [B, S, kv, hd]
    v: torch.Tensor,  # [B, S, kv, hd]
    lengths: torch.Tensor,  # [B]
    f32_scores: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial of ``kernels.decode_attention.decode_attention_partial``:
    (o [B, Hq, hd] f32, lse [B, Hq] f32), o the output before its cast and
    lse the log-sum-exp of the masked, scaled scores.  A row of length 0
    gives (0, -inf), so that a sequence shard holding none of a row's keys
    weighs nothing in the combine (``decode_attention_ref`` gives the mean
    of V there).  By default the scores and probabilities are
    ``decode_attention_ref``'s (the product of the bf16-cast probabilities
    with V taken in f32); ``f32_scores`` takes
    ``decode_attention_f32_scores_ref``'s f32 softmax instead."""
    B, Hq, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(B, kvh, Hq // kvh, hd)
    if f32_scores:
        scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float())
    else:
        scores = torch.einsum("bkgd,bskd->bkgs", qg, k).float()
    scores = scores * float(1.0 / math.sqrt(hd))
    valid = (torch.arange(k.shape[1], device=k.device)[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if f32_scores:
        o = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / torch.where(l > 0, l, 1.0)
    else:
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.einsum("bkgs,bskd->bkgd", probs.float(), v.float())
    o = torch.where(l > 0, o, 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), -math.inf)
    return o.reshape(B, Hq, hd), lse.reshape(B, Hq)


def paged_decode_attention_ref(
    q: torch.Tensor,  # [B, Hq, hd]
    k_pool: torch.Tensor,  # [NB, bs, kv, hd] physical block pool
    v_pool: torch.Tensor,  # [NB, bs, kv, hd]
    table: torch.Tensor,  # [B, n_logical] physical block per logical block
    lengths: torch.Tensor,  # [B] valid prefix length of each row
    seq_len: int | None = None,
) -> torch.Tensor:
    """Gather each row's blocks into a contiguous virtual cache and run
    ``decode_attention_ref`` on it.

    ``seq_len`` truncates the virtual view (``n_logical * bs`` may overhang
    the real max length); slicing there keeps the softmax reductions the
    exact shape of the dense slot path, so paged decode is bitwise identical
    to it.  Table entries past a row's length may point at any pool row (the
    trash block): those positions are masked.
    """
    B = q.shape[0]
    idx = table.long()
    k = k_pool[idx].reshape(B, -1, *k_pool.shape[2:])
    v = v_pool[idx].reshape(B, -1, *v_pool.shape[2:])
    if seq_len is not None:
        k = k[:, :seq_len]
        v = v[:, :seq_len]
    return decode_attention_ref(q, k, v, lengths)


def decode_attention_f32_scores_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """The decode kernels' f32 softmax in plain PyTorch.

    Scores, probabilities and the P.V sums stay in f32 and the output is
    rounded once, after the division by l (l > 0 guarded); the Pallas body
    and the CUDA kernels differ only in casting the unnormalised
    probabilities to ``v``'s dtype for P.V.  ``decode_attention_ref`` rounds
    the scores to the input dtype first, as ``repro.kernels.ref`` does,
    which at bf16 moves the output by more than its own rounding; the CUDA
    kernel is held to this version as well.
    """
    B, Hq, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(B, kvh, Hq // kvh, hd).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * float(1.0 / math.sqrt(hd))
    valid = (torch.arange(k.shape[1], device=k.device)[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = acc / torch.where(l > 0, l, 1.0)
    return out.to(q.dtype).reshape(B, Hq, hd)


def exit_confidence_ref(h: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h: [B, d], w: [d, V] -> (top-1 softmax prob [B] f32, argmax [B] i32).

    ``w`` is cast to ``h``'s dtype and the product accumulates in f32: the
    f32 matmul of the cast operands (products of bf16 values are exact in
    f32, so only the summation order differs from an f32-accumulating bf16
    GEMM).
    """
    logits = torch.matmul(h.float(), w.to(h.dtype).float())
    m = torch.max(logits, dim=-1).values
    l = torch.sum(torch.exp(logits - m[:, None]), dim=-1)
    conf = 1.0 / l
    idx = torch.argmax(logits, dim=-1).to(torch.int32)
    return conf, idx


def exit_confidence_partial_ref(h: torch.Tensor, w: torch.Tensor):
    """``exit_confidence_ref`` and each row's max logit m [B] f32 (the row's
    log-sum-exp is m - log(conf)): the partial of one vocab shard of a split
    head, ``kernels.exit_confidence.exit_confidence_partial``'s contract."""
    logits = torch.matmul(h.float(), w.to(h.dtype).float())
    m = torch.max(logits, dim=-1).values
    l = torch.sum(torch.exp(logits - m[:, None]), dim=-1)
    idx = torch.argmax(logits, dim=-1).to(torch.int32)
    return 1.0 / l, idx, m


def exit_confidence_split_ref(h: torch.Tensor, w: torch.Tensor,
                              ranges: list[tuple[int, int]]) -> tuple[torch.Tensor, torch.Tensor]:
    """The exit head as the CUDA kernel splits it: one (max, sum-exp, first
    argmax) partial per vocab range (``exit_confidence.vocab_ranges``; an
    empty range gives m = -1e30, l = 0, idx 0), combined in range order, a
    later range taking the argmax only when its max is strictly greater.
    The logits are ``exit_confidence_ref``'s; only the order of the sums
    differs."""
    logits = torch.matmul(h.float(), w.to(h.dtype).float())
    B = logits.shape[0]
    m = torch.full((B,), NEG_INF, dtype=torch.float32, device=logits.device)
    l = torch.zeros((B,), dtype=torch.float32, device=logits.device)
    idx = torch.zeros((B,), dtype=torch.int32, device=logits.device)
    for lo, hi in ranges:
        if hi <= lo:
            continue  # the empty partial changes nothing
        part = logits[:, lo:hi]
        pm, parg = torch.max(part, dim=-1)  # the first index on ties
        pl = torch.sum(torch.exp(part - pm[:, None]), dim=-1)
        mn = torch.maximum(m, pm)
        l = l * torch.exp(m - mn) + pl * torch.exp(pm - mn)
        idx = torch.where(pm > m, parg.to(torch.int32) + lo, idx)
        m = mn
    return 1.0 / torch.where(l > 0, l, 1.0), idx
