"""Staged decoder with early-exit heads — ``repro.models.model``'s block
kinds: attention (``"attn"``, ``"dense_attn"`` and ``"moe_attn"``, each with
GQA or MLA attention, GQA optionally within a sliding window; a GLU or
two-matmul MLP FFN, or an MoE), Mamba2 (``"mamba"``) and xLSTM
(``"mlstm"``, ``"slstm"``).  The input is tokens through the embedding
table, or, under ``frontend="embeds"``, precomputed embeddings.

A model is ``num_stages`` pipeline stages; each stage runs its block
periods in order.  Early-exit branches hang off the stages in
``cfg.exit_stages``: a norm plus the shared LM head, confidence = top-1
softmax probability, computed by the fused ``exit_confidence`` kernel so
[B, vocab] logits are never written.

Parameters mirror the JAX tree: ``stages[i]["blocks"]`` is a tuple (one
entry per period kind) of dicts whose leaves are stacked over the stage's
periods.  Caches mirror it too: a stage's caches are a tuple of dicts with
leaves ``[n_periods, B, ...]``: an attention kind's K/V (or MLA's latent
rows) over the sequence, a recurrent kind's state (Mamba's conv tail and SSD
state, mLSTM's conv tail and ``C``/``n``/``m``, sLSTM's ``c``/``n``/``h``/
``m``), and ``pos``; the monolithic steps' attention cache is a ring of
``sliding_window`` slots with its ``slot_pos`` when the window is shorter
than ``max_len``.  The reference's ``lax.scan`` over periods is a Python
loop here.

Training (``loss_fn``) runs the stages in mode ``"train"``: attention is
the plain ``chunked_attention`` on every device (the CUDA kernels are
forward-only), each period is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) and the MoE
blocks' load-balance losses are summed.  ``init_params(..., master=True)``
keeps every weight in f32, as the reference's trainer does; the matmuls
cast to bf16 at each use either way.
"""
from __future__ import annotations

import math
import os
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.layers import Params
from repro_torch.sharding import constrain, local_map

# weight matrices kept in bf16 (cast once at load; the reference casts each
# to bf16 at every use, the conv kernels to the bf16 activations' dtype);
# everything else (norm scales and biases, QKV biases, MLA's ``norm_ckv``,
# the SSM blocks' ``a_log``, ``dt_bias``, ``d_skip``, conv and gate biases,
# and sLSTM's ``r_gates``, which the reference casts to its f32 state's
# dtype) is f32
BF16_LEAVES = (
    "embed", "lm_head", "w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down",
    "router", "w_dkv", "w_kpe", "w_uk", "w_uv",
    "in_proj", "out_proj", "up_proj", "down_proj", "w_if", "w_gates", "conv_w",
)


class _StateKind(NamedTuple):
    """A recurrent block kind's functions in ``models.ssm`` and the config
    field holding its dims."""
    init: Any
    forward: Any
    decode: Any
    make_cache: Any
    dims: str


_STATE_KINDS = {
    "mamba": _StateKind(ssm.mamba_init, ssm.mamba_forward, ssm.mamba_decode,
                        ssm.make_mamba_cache, "mamba"),
    "mlstm": _StateKind(ssm.mlstm_init, ssm.mlstm_forward, ssm.mlstm_decode,
                        ssm.make_mlstm_cache, "xlstm"),
    "slstm": _StateKind(ssm.slstm_init, ssm.slstm_forward, ssm.slstm_decode,
                        ssm.make_slstm_cache, "xlstm"),
}


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _dense(shape, generator: torch.Generator | None, device, stacked: int | None = None,
           dtype=torch.bfloat16) -> torch.Tensor:
    """Truncated normal at +-3 std with std 1/sqrt(shape[0]) (the
    reference's fan-in), made in f32 and stored in ``dtype`` (bf16 for a
    served weight matrix, f32 for a master).  A stacked leaf is filled one
    period at a time, so no f32 temporary is larger than one period's
    matrix.  On the meta device nothing is drawn (shapes only)."""
    std = 1.0 / math.sqrt(shape[0])
    out = torch.empty(shape if stacked is None else (stacked, *shape), dtype=dtype,
                      device=device)
    if out.is_meta:
        return out
    for part in ([out] if stacked is None else out):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-3 * std, b=3 * std, generator=generator)
        part.copy_(t)
    return out


def _norm_init(kind: str, d: int, device, stacked: int | None = None) -> Params:
    shape = (d,) if stacked is None else (stacked, d)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def _state_block_init(kind: str, cfg: ArchConfig, n: int, generator: torch.Generator | None,
                      device, wdtype) -> Params:
    """One Mamba2, mLSTM or sLSTM block (its pre-norm and its cell's
    parameters), stacked over ``n`` periods; weight matrices in ``wdtype``."""
    sk = _STATE_KINDS[kind]

    def const(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty((n, *t.shape), dtype=torch.float32, device=device)
        return out if out.is_meta else out.copy_(t.expand(n, *t.shape))

    cell = sk.init(
        getattr(cfg, sk.dims),
        lambda shape: _dense(shape, generator, device, n, wdtype),
        lambda shape: _dense(shape, generator, device, n, torch.float32),
        const,
        lambda w: _norm_init("rmsnorm", w, device, n),
    )
    return {"norm": _norm_init(cfg.norm, cfg.d_model, device, n), kind: cell}


def _block_init(kind: str, cfg: ArchConfig, n: int, generator: torch.Generator | None,
                device, wdtype) -> Params:
    """One block of ``kind``, stacked over ``n`` periods: an attention block
    (GQA or MLA attention; a GLU or MLP FFN or, for ``"moe_attn"``, a
    mixture of experts), or a recurrent one (``_state_block_init``)."""
    if kind in _STATE_KINDS:
        return _state_block_init(kind, cfg, n, generator, device, wdtype)
    d = cfg.d_model

    def dense(shape):
        return _dense(shape, generator, device, n, wdtype)

    if cfg.mla is not None:
        attn = attention.mla_init(cfg.mla, dense, lambda w: _norm_init("rmsnorm", w, device, n))
    else:
        dims = cfg.attn_dims()
        attn = {
            "w_q": dense((d, dims.q_dim)),
            "w_k": dense((d, dims.kv_dim)),
            "w_v": dense((d, dims.kv_dim)),
            "w_o": dense((dims.q_dim, d)),
        }
        if dims.qkv_bias:
            for name, width in (("b_q", dims.q_dim), ("b_k", dims.kv_dim), ("b_v", dims.kv_dim)):
                attn[name] = torch.zeros((n, width), dtype=torch.float32, device=device)
    p: Params = {
        "norm1": _norm_init(cfg.norm, d, device, n),
        "attn": attn,
        "norm2": _norm_init(cfg.norm, d, device, n),
    }
    if kind == "moe_attn":
        p["moe"] = moe.moe_init(cfg.moe, dense)
    elif cfg.ffn == "mlp":
        p["ffn"] = layers.mlp_ffn_init(dense, d, cfg.d_ff)
    else:
        p["ffn"] = layers.glu_ffn_init(dense, d, cfg.d_ff)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator | None, device="cuda",
                master: bool = False) -> Params:
    """Random weights with the reference's tree, shapes and init law.

    ``generator`` must live on ``device``.  The values differ from
    ``repro.models.model.init_params`` (another generator); tests that need
    equal weights bridge the JAX tree with ``models.bridge``.  On the
    ``"meta"`` device (``generator`` None) it builds the shapes alone.  An
    ``"embeds"`` frontend has no embedding table.  Weight matrices are bf16
    for serving, or f32 masters with ``master=True`` (training; the
    products are the same, since every matmul casts to bf16).
    """
    d = cfg.d_model
    wdtype = torch.float32 if master else torch.bfloat16
    params: Params = {}
    if cfg.frontend == "tokens":
        params["embed"] = {"embed": _dense((cfg.vocab_size, d), generator, device, dtype=wdtype)}
    params.update({
        "lm_head": _dense((d, cfg.vocab_size), generator, device, dtype=wdtype),
        "final_norm": _norm_init(cfg.norm, d, device),
        "exit_norms": {f"exit_{h}": _norm_init(cfg.norm, d, device) for h in cfg.exit_stages},
    })
    params["stages"] = [
        {"blocks": tuple(_block_init(kind, cfg, n, generator, device, wdtype)
                         for kind in cfg.period)}
        for n in cfg.stage_periods()
    ]
    return params


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree as meta tensors, nothing allocated (the dry run's
    path): the reference's ``abstract_params``, whose leaves are all f32, so
    the weight matrices come as f32 masters."""
    return init_params(cfg, None, device="meta", master=True)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of the model (shapes on the meta device, nothing drawn);
    ``active_only`` leaves out each MoE block's routed experts past top-k."""
    leaves = torch.utils._pytree.tree_leaves(init_params(cfg, None, "meta"))
    total = sum(t.numel() for t in leaves)
    if active_only and cfg.moe is not None:
        n_moe = sum(1 for k in cfg.period if k == "moe_attn") * cfg.num_periods
        m = cfg.moe
        total -= n_moe * (m.num_experts - m.top_k) * 3 * m.d_model * m.d_ff_expert
    return total


def _period(tree: Params, i: int) -> Params:
    """Period ``i`` of a stacked block (or cache) dict."""
    return {k: (_period(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocks and stages
# ---------------------------------------------------------------------------


def _ffn(kind: str, p: Params, h2: torch.Tensor, cfg: ArchConfig):
    """The block's FFN on the normed residual: ``(out, aux)``, the GLU or
    the MLP with ``aux`` None, or the MoE with its load-balance loss (which
    only training reads)."""
    if kind == "moe_attn":
        return moe.moe_forward(p["moe"], h2, cfg.moe)
    if cfg.ffn == "mlp":
        return layers.mlp_ffn(p["ffn"], h2, cfg.act), None
    return layers.glu_ffn(p["ffn"], h2, cfg.act), None


def _state_block_apply(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig, mode: str):
    """One recurrent block.  Prefill also returns its cache: the cell's
    final state, the conv tail (the last ``conv_kernel - 1`` pre-conv
    features, recomputed from the normed input; a prompt shorter than that
    leaves fewer rows, as in the reference, and the engine refuses such a
    prompt for cached decode) and ``pos``.  An sLSTM block's output holds
    its own residual FFN (the xLSTM block form)."""
    h = layers.apply_norm(cfg.norm, p["norm"], x)
    if mode != "prefill":
        sk = _STATE_KINDS[kind]
        return x + sk.forward(p[kind], h, getattr(cfg, sk.dims)), None
    if kind == "mamba":
        dims = cfg.mamba
        out, state = ssm.mamba_forward(p["mamba"], h, dims, return_state=True)
        _, xbc, _ = ssm._mamba_split(p["mamba"], h[:, -(dims.conv_kernel - 1):], dims)
        cache = {"conv": xbc.to(torch.bfloat16), "ssd": state}
    elif kind == "mlstm":
        dims = cfg.xlstm
        out, (C, n, m) = ssm.mlstm_forward(p["mlstm"], h, dims, return_state=True)
        up = layers.matmul(h[:, -(dims.conv_kernel - 1):], p["mlstm"]["up_proj"])
        cache = {"conv": torch.chunk(up, 2, dim=-1)[0].to(torch.bfloat16), "C": C, "n": n, "m": m}
    else:
        out, (c, n, hs, m) = ssm.slstm_forward(p["slstm"], h, cfg.xlstm, return_state=True)
        cache = {"c": c, "n": n, "h": hs, "m": m}
    cache["pos"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
    return x + out, cache


def _cache_from_kv(k: torch.Tensor, v: torch.Tensor, dims: attention.AttnDims,
                   max_len: int) -> Params:
    """A prefill's GQA cache: a full ``max_len`` cache holding the prompt,
    or, when ``dims.sliding_window`` is shorter than ``max_len``, a ring of
    that many slots holding the prompt's last ``min(S, W)`` keys at slots
    ``position % W``, each slot's position in ``slot_pos`` (-1 == empty)."""
    B, S = k.shape[:2]
    W = dims.sliding_window
    if W is None or W >= max_len:
        cache = attention.make_kv_cache(B, max_len, dims, device=k.device)
        return attention.prefill_into_cache(cache, k, v)
    if layers.is_dtensor(k):
        # under a mesh each device fills the ring from its own rows and heads
        def ring(k, v):
            c = _cache_from_kv(k, v, dims, max_len)
            return c["k"], c["v"], c["slot_pos"]

        qkv = ("b", None, "h", None)
        rk, rv, slot_pos = local_map(ring, (k, v), (qkv, qkv), (qkv, qkv, (None,)))
        return {"k": rk, "v": rv, "slot_pos": slot_pos,
                "pos": torch.tensor(S, dtype=torch.int32, device=k.device)}
    cache = attention.make_window_cache(B, dims, device=k.device)
    start = S - min(S, W)
    pos_tail = torch.arange(start, S, dtype=torch.int32, device=k.device)
    slots = (pos_tail % W).long()
    cache["k"][:, slots] = k[:, start:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, start:].to(cache["v"].dtype)
    cache["slot_pos"][slots] = pos_tail
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=k.device)
    return cache


def _block_apply(
    kind: str,
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    mode: str,  # "train" | "forward" | "prefill"
    max_len: int = 0,
):
    """One block of ``kind``.  Returns (x', cache or None, aux or None).

    ``"prefill"`` also builds the block's cache; ``"forward"`` (the
    stateless serve) and ``"train"`` build none and differ only in
    attention, which ``"train"`` computes with the plain
    ``chunked_attention`` on every device, since the flash kernel has no
    backward.  ``aux`` is an MoE block's load-balance loss (None for the
    other blocks, where the reference adds a zero)."""
    if kind in _STATE_KINDS:
        return (*_state_block_apply(kind, p, x, cfg, mode), None)
    h = layers.apply_norm(cfg.norm, p["norm1"], x)
    cache = None
    if cfg.mla is not None:
        if mode == "prefill":
            out, (c_kv, k_pe) = attention.mla_forward(
                p["attn"], h, cfg.mla, positions, cfg.q_chunk, return_latent=True
            )
            cache = attention.make_mla_cache(x.shape[0], max_len, cfg.mla, device=x.device)
            cache = attention.mla_prefill_into_cache(cache, c_kv, k_pe)
        else:
            out = attention.mla_forward(p["attn"], h, cfg.mla, positions, cfg.q_chunk)
    else:
        dims = cfg.attn_dims()
        if mode == "prefill":
            out, (k, v) = attention.gqa_forward(p["attn"], h, dims, positions, cfg.q_chunk,
                                                return_kv=True)
            cache = _cache_from_kv(k, v, dims, max_len)
        else:
            out = attention.gqa_forward(p["attn"], h, dims, positions, cfg.q_chunk,
                                        train=mode == "train")
    x = x + out
    h2 = layers.apply_norm(cfg.norm, p["norm2"], x)
    ffn_out, aux = _ffn(kind, p, h2, cfg)
    return x + ffn_out, cache, aux


def _block_decode(kind: str, p: Params, x: torch.Tensor, cache: Params, cfg: ArchConfig,
                  ragged: bool = False, paged_seq_len: int | None = None):
    """One-token block step.  ``ragged=True`` treats ``cache["pos"]`` as a
    per-row int32 [B] vector (the serving engine's slot-cache batches);
    ``paged_seq_len`` selects the paged path, where the cache holds a block
    pool plus a per-row block ``table`` instead of contiguous rows.  The
    recurrent kinds' steps are position-free: their new state is written
    into ``cache``'s leaves in place."""
    if kind in _STATE_KINDS:
        sk = _STATE_KINDS[kind]
        h = layers.apply_norm(cfg.norm, p["norm"], x)
        out, new = sk.decode(p[kind], h, cache, getattr(cfg, sk.dims))
        for key, t in new.items():
            if key != "pos":
                cache[key].copy_(t)
        return x + out, dict(cache, pos=new["pos"])
    h = layers.apply_norm(cfg.norm, p["norm1"], x)
    if cfg.mla is not None:
        if paged_seq_len is not None:
            out, cache = attention.mla_decode_paged(p["attn"], h, cache, cfg.mla, paged_seq_len)
        else:
            decode = attention.mla_decode_ragged if ragged else attention.mla_decode
            out, cache = decode(p["attn"], h, cache, cfg.mla)
    elif paged_seq_len is not None:
        out, cache = attention.gqa_decode_paged(p["attn"], h, cache, cfg.attn_dims(), paged_seq_len)
    else:
        decode = attention.gqa_decode_ragged if ragged else attention.gqa_decode
        out, cache = decode(p["attn"], h, cache, cfg.attn_dims())
    x = x + out
    h2 = layers.apply_norm(cfg.norm, p["norm2"], x)
    return x + _ffn(kind, p, h2, cfg)[0], cache


def _stack_caches(per_period: list[Params]) -> Params:
    return {k: torch.stack([c[k] for c in per_period]) for k in per_period[0]}


def _num_periods(stage: Params) -> int:
    """Periods of a stage, from its parameters (every block has a pre-norm:
    ``norm1`` in an attention block, ``norm`` in a recurrent one)."""
    block = stage["blocks"][0]
    return block["norm1" if "norm1" in block else "norm"]["scale"].shape[0]


def _add_aux(total: torch.Tensor | None, a: torch.Tensor | None) -> torch.Tensor | None:
    """``total + a`` where None stands for the reference's zero (``0 + a``
    is ``a`` exactly, so the sums round as the reference's do)."""
    if a is None:
        return total
    return a if total is None else total + a


def _period_apply(blocks: tuple, i: int, x: torch.Tensor, aux: torch.Tensor | None,
                  cfg: ArchConfig, positions: torch.Tensor, mode: str, max_len: int):
    """Period ``i`` of a stage (each kind's block in order): ``(x, aux,
    the blocks' caches)``, ``aux`` carried through the blocks."""
    caches = []
    for j, kind in enumerate(cfg.period):
        x, cache, a = _block_apply(kind, _period(blocks[j], i), x, cfg, positions, mode, max_len)
        caches.append(cache)
        aux = _add_aux(aux, a)
    # the residual stream between periods, sequence-parallel over the model
    # axis under a mesh (``REPRO_SP=0`` keeps the sequence whole)
    seq = "seq" if os.environ.get("REPRO_SP", "1") == "1" else None
    return constrain(x, "batch", seq, None), aux, caches


def _run_stage(
    stage: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, mode: str,
    max_len: int = 0,
):
    """Run this stage's periods in order.  Returns (x, stacked caches or
    None, the MoE blocks' summed aux loss or None).  In mode ``"train"``
    with grad enabled each period is recomputed in the backward pass
    (``torch.utils.checkpoint``; the reference's ``jax.checkpoint``): only
    the periods' inputs are kept."""
    caches: list[list[Params]] = [[] for _ in cfg.period]
    aux = None
    remat = mode == "train" and torch.is_grad_enabled()
    for i in range(_num_periods(stage)):
        args = (stage["blocks"], i, x, aux, cfg, positions, mode, max_len)
        if remat:
            x, aux, period_caches = torch.utils.checkpoint.checkpoint(
                _period_apply, *args, use_reentrant=False)
        else:
            x, aux, period_caches = _period_apply(*args)
        for j, cache in enumerate(period_caches):
            caches[j].append(cache)
    if mode != "prefill":
        return x, None, aux
    return x, tuple(_stack_caches(c) for c in caches), aux


def _decode_stage(stage: Params, x: torch.Tensor, caches, cfg: ArchConfig, ragged: bool = False,
                  paged_seq_len: int | None = None):
    """One token through a stage.  The stacked caches are updated in place;
    the returned tuple holds them with their advanced ``pos``."""
    n_periods = _num_periods(stage)
    pos_out: list[list[torch.Tensor]] = [[] for _ in cfg.period]
    for i in range(n_periods):
        for j, kind in enumerate(cfg.period):
            x, nc = _block_decode(
                kind, _period(stage["blocks"][j], i), x, _period(caches[j], i), cfg, ragged,
                paged_seq_len,
            )
            pos_out[j].append(nc["pos"])
    return x, tuple(dict(c, pos=torch.stack(p)) for c, p in zip(caches, pos_out))


# ---------------------------------------------------------------------------
# Per-stage entry points (the collaborative serving data plane)
# ---------------------------------------------------------------------------


def prefill_stage(params: Params, stage_idx: int, x: torch.Tensor, cfg: ArchConfig, max_len: int):
    """Prefill through stage ``stage_idx`` (1-indexed): residual stream in,
    (residual stream out, stage caches sized ``max_len``) back."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    out, caches, _ = _run_stage(params["stages"][stage_idx - 1], x, cfg, positions, "prefill",
                                max_len)
    return out, caches


def decode_stage_ragged(params: Params, stage_idx: int, x: torch.Tensor, caches, cfg: ArchConfig):
    """One token through stage ``stage_idx`` against its caches, with
    per-row positions (``cache["pos"]``: int32 [n_periods, B])."""
    return _decode_stage(params["stages"][stage_idx - 1], x, caches, cfg, ragged=True)


def min_cached_prompt_len(cfg: ArchConfig) -> int:
    """The shortest prompt whose prefill caches a whole conv tail: Mamba and
    mLSTM blocks keep the last ``conv_kernel - 1`` pre-conv features, and a
    shorter prompt leaves fewer rows than their decode step reads (the
    reference's cached serve and ``monolithic_generate`` fail on it)."""
    kernels = [getattr(cfg, _STATE_KINDS[k].dims).conv_kernel for k in ("mamba", "mlstm")
               if k in cfg.period]
    return max(kernels, default=2) - 1


def validate_slot_layout(cfg: ArchConfig, stage_idx: int, max_len: int) -> None:
    """Reject configs the slot-resident cache layout cannot represent."""
    if not cfg.uses_attention or cfg.mla is not None:
        return
    w = cfg.attn_dims().sliding_window
    if w is not None and w < max_len:
        raise ValueError(
            f"stage {stage_idx} of config {cfg.name!r}: slot-resident caches need "
            f"full attention caches, but sliding_window={w} < max_len={max_len}"
        )


def _block_cache(kind: str, cfg: ArchConfig, n: int, batch: int, max_len: int, device) -> Params:
    """One kind's empty cache leaves (all but ``pos``), stacked over ``n``
    periods: an attention kind's zeroed sequence leaves, ``k``/``v`` ``[n,
    batch, max_len, kv, hd]`` or MLA's ``c_kv``/``k_pe`` ``[n, batch,
    max_len, lora or rope_dim]``; a recurrent kind's state ``[n, batch,
    ...]`` as its cache maker builds it (``m`` at -1e30)."""
    if kind in _STATE_KINDS:
        sk = _STATE_KINDS[kind]
        one = sk.make_cache(batch, getattr(cfg, sk.dims), device=device)
        return {key: t.expand(n, *t.shape).clone() for key, t in one.items() if key != "pos"}
    if cfg.mla is not None:
        one = attention.make_mla_cache(batch, max_len, cfg.mla, device="meta")
    else:
        one = attention.make_kv_cache(batch, max_len, cfg.attn_dims(), device="meta")
    return {key: torch.zeros((n, *t.shape), dtype=t.dtype, device=device)
            for key, t in one.items() if key in PAGED_CACHE_LEAVES}


def init_stage_slot_caches(
    cfg: ArchConfig, stage_idx: int, num_slots: int, max_len: int, device="cuda"
):
    """Zeroed slot-resident caches for one stage's replica (dense layout):
    leaves ``[n_periods, num_slots, ...]`` with ``pos`` a per-slot int32
    vector, so a decode batch can gather any subset of slots."""
    validate_slot_layout(cfg, stage_idx, max_len)
    n = cfg.stage_periods()[stage_idx - 1]
    return tuple(
        dict(_block_cache(kind, cfg, n, num_slots, max_len, device),
             pos=torch.zeros((n, num_slots), dtype=torch.int32, device=device))
        for kind in cfg.period
    )


# cache leaves with a ``max_len`` sequence dimension: the only ones the paged
# layout moves into the block pool (``pos`` and the recurrent kinds' state
# stay slot-indexed)
PAGED_CACHE_LEAVES = ("k", "v", "c_kv", "k_pe")


def init_stage_paged_caches(
    cfg: ArchConfig,
    stage_idx: int,
    num_slots: int,
    num_blocks: int,
    block_size: int,
    max_len: int,
    device="cuda",
):
    """Zeroed PAGED caches for one stage's replica: ``(pool, state)``.

    ``pool`` holds an attention kind's sequence leaves (``k``/``v``, or
    MLA's ``c_kv``/``k_pe``) as physical block pools ``[n_periods,
    num_blocks, block_size, ...]`` addressed through per-request block
    tables (a recurrent kind's pool dict is empty); ``state`` keeps ``pos``
    and any recurrent state per slot, ``[n_periods, num_slots, ...]``, as
    the dense layout does.  Both counts INCLUDE their trailing trash row
    (padded batch rows write there).
    """
    validate_slot_layout(cfg, stage_idx, max_len)
    n = cfg.stage_periods()[stage_idx - 1]
    pool, state = [], []
    for kind in cfg.period:
        recurrent = kind in _STATE_KINDS
        pool.append({} if recurrent else _block_cache(kind, cfg, n, num_blocks, block_size, device))
        st = _block_cache(kind, cfg, n, num_slots, max_len, device) if recurrent else {}
        st["pos"] = torch.zeros((n, num_slots), dtype=torch.int32, device=device)
        state.append(st)
    return tuple(pool), tuple(state)


def decode_stage_paged(
    params: Params,
    stage_idx: int,
    x: torch.Tensor,
    pool_caches,
    state_rows,
    tables: torch.Tensor,  # int32 [B, n_logical]
    cfg: ArchConfig,
    seq_len: int,
):
    """One token through stage ``stage_idx`` reading and writing the block
    pool through per-row block tables.

    ``pool_caches``: per-period pool dicts ``[n_periods, num_blocks, bs,
    ...]``, updated in place; ``state_rows``: the batch's gathered per-slot
    rows ``[n_periods, B, ...]`` (``pos`` and any recurrent state, updated
    in place).  Returns ``(x_out, new_caches)`` with each period's dict
    holding the pools, the table (attention kinds) and the advanced ``pos``.
    """
    n_periods = cfg.stage_periods()[stage_idx - 1]
    table = {"table": tables[None].expand(n_periods, *tables.shape)}
    caches = tuple(
        dict(state_d, **pool_d, **(table if pool_d else {}))
        for pool_d, state_d in zip(pool_caches, state_rows)
    )
    return _decode_stage(
        params["stages"][stage_idx - 1], x, caches, cfg, ragged=True, paged_seq_len=seq_len
    )


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------


def _head_confidence(params: Params, norm_params, hidden: torch.Tensor, cfg: ArchConfig):
    """(confidence, argmax) of one LM-head branch on [B, 1, d] hidden states,
    through the fused kernel: [B, vocab] logits are never written."""
    h = layers.apply_norm(cfg.norm, norm_params, hidden[:, 0])
    return kernel_ops.exit_confidence(h.contiguous(), params["lm_head"])


def exit_confidence(params: Params, hidden: torch.Tensor, stage: int, cfg: ArchConfig):
    """(confidence, argmax) of exit branch b_h on [B, 1, d] hidden states."""
    return _head_confidence(params, params["exit_norms"][f"exit_{stage}"], hidden, cfg)


def final_confidence(params: Params, hidden: torch.Tensor, cfg: ArchConfig):
    """(confidence, argmax) of the final head, through the same fused path."""
    return _head_confidence(params, params["final_norm"], hidden, cfg)


def lm_logits(params: Params, hidden: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """f32 logits of the shared LM head (a bf16 product, then cast)."""
    return layers.matmul(hidden, params["lm_head"]).float()


def _vocab_ids(logits: torch.Tensor) -> torch.Tensor:
    """``arange(V)`` as a DTensor split along the mesh dims that split the
    last dim of the DTensor ``logits``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = [Shard(0) if isinstance(p, Shard) and p.dim == logits.ndim - 1 else Replicate()
          for p in logits.placements]
    ids = torch.arange(logits.shape[-1], device=logits.to_local().device)
    return distribute_tensor(ids, logits.device_mesh, pl, src_data_rank=None)


def chunked_xent(
    hidden: torch.Tensor,  # [B, S, d]
    labels: torch.Tensor,  # [B, S] (-1 == masked)
    head: torch.Tensor,  # [d, V]
    chunk: int = 512,
):
    """``(nll_sum, count)`` of the token NLL over the unmasked labels,
    ``chunk`` positions at a time (the whole ``S`` when ``chunk`` does not
    divide it), so the f32 logits are ``[B, chunk, V]`` at most."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S
    if layers.is_dtensor(head):  # gathered (FSDP) once, not per chunk
        head = layers.gather_contraction(head)
    nll, cnt = [], []
    for i in range(0, S, chunk):
        y = labels[:, i:i + chunk].long()
        logits = layers.matmul(hidden[:, i:i + chunk], head).float()  # [B, C, V]
        lse = torch.logsumexp(logits, dim=2)  # dims counted from 0: a DTensor's vocab split
        if layers.is_dtensor(logits):
            # a masked sum over the (vocab-sharded) logits, the vocab ids
            # split as the logits are: DTensor's gather over a sharded dim
            # leaves a partial it cannot reduce after [..., 0]
            tgt = torch.sum(torch.where(_vocab_ids(logits) == y.clamp(min=0)[..., None], logits,
                                        0.0), 2)
        else:
            tgt = torch.gather(logits, -1, y.clamp(min=0)[..., None])[..., 0]
        mask = (y >= 0).float()
        nll.append(torch.sum((lse - tgt) * mask))
        cnt.append(torch.sum(mask))
    return torch.sum(torch.stack(nll)), torch.sum(torch.stack(cnt))


def forward_hidden(params: Params, batch: dict, cfg: ArchConfig):
    """The training forward: ``(final hidden, {stage: exit hidden}, aux)``,
    ``aux`` the MoE blocks' summed load-balance loss (f32, 0 without MoE)."""
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    exits: dict[int, torch.Tensor] = {}
    aux_total = None
    for si, stage in enumerate(params["stages"], start=1):
        x, _, aux = _run_stage(stage, x, cfg, positions, "train")
        aux_total = _add_aux(aux_total, aux)
        if si in cfg.exit_stages:
            exits[si] = x
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, exits, aux_total


def loss_fn(params: Params, batch: dict, cfg: ArchConfig, aux_weight: float = 0.01):
    """Deep-supervision LM loss: the final head plus the early-exit heads
    weighted by ``cfg.exit_loss_weight``, plus ``aux_weight`` times the MoE
    load-balance loss.  Returns ``(loss, metrics)``, metrics ``loss``,
    ``final_loss``, ``moe_aux`` and ``exit_{h}_loss`` (f32 scalars)."""
    x, exits, moe_aux = forward_hidden(params, batch, cfg)
    head = params["lm_head"]
    labels = batch["labels"]

    h_final = layers.apply_norm(cfg.norm, params["final_norm"], x)
    nll, cnt = chunked_xent(h_final, labels, head)
    total, weight_sum = nll, cnt
    per_exit = {}
    for h_stage in cfg.exit_stages:
        he = layers.apply_norm(cfg.norm, params["exit_norms"][f"exit_{h_stage}"], exits[h_stage])
        e_nll, e_cnt = chunked_xent(he, labels, head)
        per_exit[f"exit_{h_stage}_loss"] = e_nll / torch.clamp(e_cnt, min=1.0)
        total = total + cfg.exit_loss_weight * e_nll
        weight_sum = weight_sum + cfg.exit_loss_weight * e_cnt

    loss = total / torch.clamp(weight_sum, min=1.0) + aux_weight * moe_aux
    metrics = {
        "loss": loss,
        "final_loss": nll / torch.clamp(cnt, min=1.0),
        "moe_aux": moe_aux,
        **per_exit,
    }
    return loss, metrics


# ---------------------------------------------------------------------------
# Monolithic entry points (the single-host reference generator)
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> list:
    """Zeroed caches of the monolithic steps, mirroring the stage / period
    structure: per stage a tuple (one dict per period kind) of leaves
    ``[n_periods, ...]`` (``pos`` ``[n_periods]``).  A GQA kind whose
    sliding window is shorter than ``max_len`` gets a ring of the window's
    slots (``slot_pos`` at -1), as ``repro.models.model._block_cache``."""

    def one(kind: str) -> Params:
        if kind in _STATE_KINDS:
            sk = _STATE_KINDS[kind]
            return sk.make_cache(batch, getattr(cfg, sk.dims), device=device)
        if cfg.mla is not None:
            return attention.make_mla_cache(batch, max_len, cfg.mla, device=device)
        dims = cfg.attn_dims()
        if dims.sliding_window is not None and dims.sliding_window < max_len:
            return attention.make_window_cache(batch, dims, device=device)
        return attention.make_kv_cache(batch, max_len, dims, device=device)

    return [
        tuple({key: t.expand(n, *t.shape).clone() for key, t in one(kind).items()}
              for kind in cfg.period)
        for n in cfg.stage_periods()
    ]


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> list:
    """``init_caches`` as meta tensors (the dry run's decode caches)."""
    return init_caches(cfg, batch, max_len, device="meta")


def embed_inputs(params: Params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """The residual stream ``[B, S, d]`` of a batch: ``{"tokens": [B, S]}``
    through the embedding table, or, under ``frontend="embeds"``,
    ``{"embeds": [B, S, d]}`` cast to the compute dtype."""
    if cfg.frontend == "embeds":
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = layers.embed(params["embed"], batch["tokens"])
    return constrain(x, "batch", "seq", None)


def _stack_heads(confs: list, toks: list, B: int, device):
    if not confs:
        return (
            torch.zeros((B, 0), dtype=torch.float32, device=device),
            torch.zeros((B, 0), dtype=torch.int32, device=device),
        )
    return torch.stack(confs, dim=1), torch.stack(toks, dim=1)


def prefill(params: Params, batch: dict, cfg: ArchConfig, max_len: int):
    """The whole model over a batch (``embed_inputs``), building the decode
    caches (a window ring where the window is shorter than ``max_len``).
    Returns (next_token [B], exit_conf [B, n_exits], exit_token [B, n_exits], caches)."""
    x = embed_inputs(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    caches, confs, toks = [], [], []
    for si, stage in enumerate(params["stages"], start=1):
        x, stage_caches, _ = _run_stage(stage, x, cfg, positions, "prefill", max_len)
        caches.append(stage_caches)
        if si in cfg.exit_stages:
            c, t = exit_confidence(params, x[:, -1:], si, cfg)
            confs.append(c)
            toks.append(t)
    _, next_token = final_confidence(params, x[:, -1:], cfg)
    exit_conf, exit_tok = _stack_heads(confs, toks, B, x.device)
    return next_token, exit_conf, exit_tok, caches


def decode_step(params: Params, batch: dict, caches: list, cfg: ArchConfig):
    """One token for every sequence (a batch of one position, shared scalar
    position); returns (next_token, exit_conf, exit_token, caches').
    Updates ``caches`` in place."""
    x = embed_inputs(params, batch, cfg)
    B = x.shape[0]
    new_caches, confs, toks = [], [], []
    for si, (stage, stage_cache) in enumerate(zip(params["stages"], caches), start=1):
        x, nc = _decode_stage(stage, x, stage_cache, cfg)
        new_caches.append(nc)
        if si in cfg.exit_stages:
            c, t = exit_confidence(params, x, si, cfg)
            confs.append(c)
            toks.append(t)
    _, next_token = final_confidence(params, x, cfg)
    exit_conf, exit_tok = _stack_heads(confs, toks, B, x.device)
    return next_token, exit_conf, exit_tok, new_caches


def params_to(params: Any, device) -> Any:
    """The parameter tree on ``device`` (no copy for leaves already there)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)
