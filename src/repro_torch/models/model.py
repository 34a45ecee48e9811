"""Staged decoder with early-exit heads — the ``"attn"`` kind of
``repro.models.model``.

A model is ``num_stages`` pipeline stages; each stage runs its block
periods in order.  Early-exit branches hang off the stages in
``cfg.exit_stages``: a norm plus the shared LM head, confidence = top-1
softmax probability, computed by the fused ``exit_confidence`` kernel so
[B, vocab] logits are never written.

Parameters mirror the JAX tree: ``stages[i]["blocks"]`` is a tuple (one
entry per period kind) of dicts whose leaves are stacked over the stage's
periods.  Caches mirror it too: a stage's caches are a tuple of dicts with
leaves ``[n_periods, B, ...]``.  The reference's ``lax.scan`` over periods
is a Python loop here.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention, layers
from repro_torch.models.layers import Params

# weight matrices kept in bf16 (cast once at load); everything else is f32
BF16_LEAVES = ("embed", "lm_head", "w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _dense(shape, generator: torch.Generator, device, stacked: int | None = None) -> torch.Tensor:
    """Truncated normal at +-3 std with std 1/sqrt(fan_in), made in f32 and
    stored in bf16 (the reference keeps the f32 master)."""
    fan_in = shape[0]
    full = shape if stacked is None else (stacked, *shape)
    std = 1.0 / math.sqrt(fan_in)
    t = torch.empty(full, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-3 * std, b=3 * std, generator=generator)
    return t.to(torch.bfloat16)


def _norm_init(kind: str, d: int, device, stacked: int | None = None) -> Params:
    shape = (d,) if stacked is None else (stacked, d)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def _block_init(cfg: ArchConfig, n: int, generator: torch.Generator, device) -> Params:
    """One ``"attn"`` block, stacked over ``n`` periods."""
    d = cfg.d_model
    dims = cfg.attn_dims()
    attn: Params = {
        "w_q": _dense((d, dims.q_dim), generator, device, n),
        "w_k": _dense((d, dims.kv_dim), generator, device, n),
        "w_v": _dense((d, dims.kv_dim), generator, device, n),
        "w_o": _dense((dims.q_dim, d), generator, device, n),
    }
    if dims.qkv_bias:
        for name, width in (("b_q", dims.q_dim), ("b_k", dims.kv_dim), ("b_v", dims.kv_dim)):
            attn[name] = torch.zeros((n, width), dtype=torch.float32, device=device)
    return {
        "norm1": _norm_init(cfg.norm, d, device, n),
        "attn": attn,
        "norm2": _norm_init(cfg.norm, d, device, n),
        "ffn": {
            "w_gate": _dense((d, cfg.d_ff), generator, device, n),
            "w_up": _dense((d, cfg.d_ff), generator, device, n),
            "w_down": _dense((cfg.d_ff, d), generator, device, n),
        },
    }


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> Params:
    """Random weights with the reference's tree, shapes and init law.

    ``generator`` must live on ``device``.  The values differ from
    ``repro.models.model.init_params`` (another generator); tests that need
    equal weights bridge the JAX tree with ``models.bridge``.
    """
    d = cfg.d_model
    params: Params = {
        "embed": {"embed": _dense((cfg.vocab_size, d), generator, device)},
        "lm_head": _dense((d, cfg.vocab_size), generator, device),
        "final_norm": _norm_init(cfg.norm, d, device),
        "exit_norms": {f"exit_{h}": _norm_init(cfg.norm, d, device) for h in cfg.exit_stages},
    }
    params["stages"] = [
        {"blocks": tuple(_block_init(cfg, n, generator, device) for _ in cfg.period)}
        for n in cfg.stage_periods()
    ]
    return params


def _period(tree: Params, i: int) -> Params:
    """Period ``i`` of a stacked block (or cache) dict."""
    return {k: (_period(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocks and stages
# ---------------------------------------------------------------------------


def _block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    mode: str,  # "train" | "prefill"
    max_len: int = 0,
):
    """One attention block.  Returns (x', cache or None)."""
    h = layers.apply_norm(cfg.norm, p["norm1"], x)
    dims = cfg.attn_dims()
    cache = None
    if mode == "prefill":
        out, (k, v) = attention.gqa_forward(p["attn"], h, dims, positions, cfg.q_chunk, return_kv=True)
        cache = attention.make_kv_cache(x.shape[0], max_len, dims, device=x.device)
        cache = attention.prefill_into_cache(cache, k, v)
    else:
        out = attention.gqa_forward(p["attn"], h, dims, positions, cfg.q_chunk)
    x = x + out
    h2 = layers.apply_norm(cfg.norm, p["norm2"], x)
    return x + layers.glu_ffn(p["ffn"], h2, cfg.act), cache


def _block_decode(p: Params, x: torch.Tensor, cache: Params, cfg: ArchConfig, ragged: bool = False,
                  paged_seq_len: int | None = None):
    """One-token block step.  ``ragged=True`` treats ``cache["pos"]`` as a
    per-row int32 [B] vector (the serving engine's slot-cache batches);
    ``paged_seq_len`` selects the paged path, where the cache holds a block
    pool plus a per-row block ``table`` instead of contiguous rows."""
    h = layers.apply_norm(cfg.norm, p["norm1"], x)
    if paged_seq_len is not None:
        out, cache = attention.gqa_decode_paged(p["attn"], h, cache, cfg.attn_dims(), paged_seq_len)
    else:
        decode = attention.gqa_decode_ragged if ragged else attention.gqa_decode
        out, cache = decode(p["attn"], h, cache, cfg.attn_dims())
    x = x + out
    h2 = layers.apply_norm(cfg.norm, p["norm2"], x)
    return x + layers.glu_ffn(p["ffn"], h2, cfg.act), cache


def _stack_caches(per_period: list[Params]) -> Params:
    return {k: torch.stack([c[k] for c in per_period]) for k in per_period[0]}


def _run_stage(
    stage: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, mode: str,
    max_len: int = 0,
):
    """Run this stage's periods in order.  Returns (x, stacked caches or None)."""
    n_periods = stage["blocks"][0]["attn"]["w_q"].shape[0]
    caches: list[list[Params]] = [[] for _ in cfg.period]
    for i in range(n_periods):
        for j, _ in enumerate(cfg.period):
            x, cache = _block_apply(_period(stage["blocks"][j], i), x, cfg, positions, mode, max_len)
            caches[j].append(cache)
    if mode != "prefill":
        return x, None
    return x, tuple(_stack_caches(c) for c in caches)


def _decode_stage(stage: Params, x: torch.Tensor, caches, cfg: ArchConfig, ragged: bool = False,
                  paged_seq_len: int | None = None):
    """One token through a stage.  The stacked caches are updated in place;
    the returned tuple holds them with their advanced ``pos``."""
    n_periods = caches[0]["k"].shape[0]
    new_caches = []
    for j, _ in enumerate(cfg.period):
        pos_out = []
        for i in range(n_periods):
            x, nc = _block_decode(
                _period(stage["blocks"][j], i), x, _period(caches[j], i), cfg, ragged,
                paged_seq_len,
            )
            pos_out.append(nc["pos"])
        new_caches.append(dict(caches[j], pos=torch.stack(pos_out)))
    return x, tuple(new_caches)


# ---------------------------------------------------------------------------
# Per-stage entry points (the collaborative serving data plane)
# ---------------------------------------------------------------------------


def prefill_stage(params: Params, stage_idx: int, x: torch.Tensor, cfg: ArchConfig, max_len: int):
    """Prefill through stage ``stage_idx`` (1-indexed): residual stream in,
    (residual stream out, stage caches sized ``max_len``) back."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return _run_stage(params["stages"][stage_idx - 1], x, cfg, positions, "prefill", max_len)


def decode_stage_ragged(params: Params, stage_idx: int, x: torch.Tensor, caches, cfg: ArchConfig):
    """One token through stage ``stage_idx`` against its caches, with
    per-row positions (``cache["pos"]``: int32 [n_periods, B])."""
    return _decode_stage(params["stages"][stage_idx - 1], x, caches, cfg, ragged=True)


def validate_slot_layout(cfg: ArchConfig, stage_idx: int, max_len: int) -> None:
    """Reject configs the slot-resident cache layout cannot represent."""
    w = cfg.attn_dims().sliding_window
    if w is not None and w < max_len:
        raise ValueError(
            f"stage {stage_idx} of config {cfg.name!r}: slot-resident caches need "
            f"full attention caches, but sliding_window={w} < max_len={max_len}"
        )


def init_stage_slot_caches(
    cfg: ArchConfig, stage_idx: int, num_slots: int, max_len: int, device="cuda"
):
    """Zeroed slot-resident caches for one stage's replica (dense layout):
    leaves ``[n_periods, num_slots, ...]`` with ``pos`` a per-slot int32
    vector, so a decode batch can gather any subset of slots."""
    validate_slot_layout(cfg, stage_idx, max_len)
    n = cfg.stage_periods()[stage_idx - 1]
    dims = cfg.attn_dims()
    shape = (n, num_slots, max_len, dims.num_kv_heads, dims.head_dim)
    return tuple(
        {
            "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "pos": torch.zeros((n, num_slots), dtype=torch.int32, device=device),
        }
        for _ in cfg.period
    )


# cache leaves with a ``max_len`` sequence dimension: the only ones the paged
# layout moves into the block pool (``pos`` stays slot-indexed).  The
# reference adds MLA's ``c_kv``/``k_pe``, which are not ported yet.
PAGED_CACHE_LEAVES = ("k", "v")


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

    ``pool`` holds ``k``/``v`` as physical block pools ``[n_periods,
    num_blocks, block_size, kv, hd]`` addressed through per-request block
    tables; ``state`` keeps ``pos`` per slot, ``[n_periods, num_slots]``, as
    the dense layout does.  Both counts INCLUDE their trailing trash row
    (padded batch rows write there).
    """
    validate_slot_layout(cfg, stage_idx, max_len)
    n = cfg.stage_periods()[stage_idx - 1]
    dims = cfg.attn_dims()
    shape = (n, num_blocks, block_size, dims.num_kv_heads, dims.head_dim)
    pool = tuple(
        {key: torch.zeros(shape, dtype=torch.bfloat16, device=device) for key in PAGED_CACHE_LEAVES}
        for _ in cfg.period
    )
    state = tuple(
        {"pos": torch.zeros((n, num_slots), dtype=torch.int32, device=device)} for _ in cfg.period
    )
    return pool, state


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
    rows ``[n_periods, B]`` (``pos``).  Returns ``(x_out, new_caches)`` with
    each period's dict holding the pools, the table and the advanced ``pos``.
    """
    n_periods = cfg.stage_periods()[stage_idx - 1]
    caches = tuple(
        dict(state_d, **pool_d, table=tables[None].expand(n_periods, *tables.shape))
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


# ---------------------------------------------------------------------------
# Monolithic entry points (the single-host reference generator)
# ---------------------------------------------------------------------------


def embed_inputs(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embed(params["embed"], tokens)


def _stack_heads(confs: list, toks: list, B: int, device):
    if not confs:
        return (
            torch.zeros((B, 0), dtype=torch.float32, device=device),
            torch.zeros((B, 0), dtype=torch.int32, device=device),
        )
    return torch.stack(confs, dim=1), torch.stack(toks, dim=1)


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig, max_len: int):
    """Returns (next_token [B], exit_conf [B, n_exits], exit_token [B, n_exits], caches)."""
    x = embed_inputs(params, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    caches, confs, toks = [], [], []
    for si, stage in enumerate(params["stages"], start=1):
        x, stage_caches = _run_stage(stage, x, cfg, positions, "prefill", max_len)
        caches.append(stage_caches)
        if si in cfg.exit_stages:
            c, t = exit_confidence(params, x[:, -1:], si, cfg)
            confs.append(c)
            toks.append(t)
    _, next_token = final_confidence(params, x[:, -1:], cfg)
    exit_conf, exit_tok = _stack_heads(confs, toks, B, x.device)
    return next_token, exit_conf, exit_tok, caches


def decode_step(params: Params, tokens: torch.Tensor, caches: list, cfg: ArchConfig):
    """One token for every sequence (shared scalar position); returns
    (next_token, exit_conf, exit_token, caches').  Updates ``caches`` in place."""
    x = embed_inputs(params, tokens)
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
