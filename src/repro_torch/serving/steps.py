"""Serve steps: staged forwards, fused exit heads, cache-threaded decode.

The counterpart of ``repro.serving.steps``.  PyTorch runs eagerly, so the
reference's ``make_*`` builders of jitted programs become plain functions,
and the reference's donated slot stores become in-place updates of the
store tensors:

  * ``stage_prefill`` — stage forward that also builds the stage's caches
    (one request row each);
  * ``slot_write``    — scatter a prefill batch's cache rows into the
    replica's slot store;
  * ``stage_decode``  — one token per row against the slot store: gather
    the batch's slots, run the ragged cached decode (per-row positions,
    flash-decode kernel), scatter the rows back;
  * ``paged_slot_write`` / ``paged_stage_decode`` / ``block_copy`` — the
    same for the paged layout, whose sequence leaves (K/V, or MLA's latent
    rows) live in a pool of blocks reached through per-request block tables;
  * ``make_prefill_step`` / ``make_decode_step`` — the batched monolithic
    steps (every stage, the exit rule applied) over a batch dict of tokens
    or embeddings, with window rings where a sliding window is shorter than
    ``max_len``: the path the ``frontend="embeds"`` configs serve on.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.sharding import mesh_scope


def embed_step(params: Any, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """tokens [B, S] -> embedded residual stream [B, S, d]."""
    return model_lib.embed_inputs(params, {"tokens": tokens}, cfg)


def stage_forward(params: Any, x: torch.Tensor, cfg: ArchConfig, stage_idx: int) -> torch.Tensor:
    """Residual stream through stage ``stage_idx`` (1-indexed), any batch."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    out, _, _ = model_lib._run_stage(params["stages"][stage_idx - 1], x, cfg, positions, "forward")
    return out


def exit_head_step(params: Any, x: torch.Tensor, cfg: ArchConfig, stage_idx: int):
    """Fused (confidence, token) of exit branch b_h on the last position of x [B, S, d]."""
    return model_lib.exit_confidence(params, x[:, -1:], stage_idx, cfg)


def final_head_step(params: Any, x: torch.Tensor, cfg: ArchConfig):
    """Fused (confidence, token) of the final head on the last position of x [B, S, d]."""
    return model_lib.final_confidence(params, x[:, -1:], cfg)


def stage_prefill(params: Any, x: torch.Tensor, cfg: ArchConfig, stage_idx: int, max_len: int):
    """``(x_out [B, S, d], stage caches)`` with cache leaves
    ``[n_periods, B, max_len, ...]`` — one row per request."""
    return model_lib.prefill_stage(params, stage_idx, x, cfg, max_len)


def slot_write(slot_caches, new_caches, slots: torch.Tensor) -> None:
    """Scatter a prefill batch's cache rows into the slot store, in place.

    ``slots`` is int64 [B]; padded rows point at the store's trash slot.
    """
    for buf_d, new_d in zip(slot_caches, new_caches):
        for key, buf in buf_d.items():
            new = new_d[key]
            if new.ndim < buf.ndim:  # "pos" comes out of prefill as one scalar per period
                new = new[:, None].expand(-1, slots.shape[0])
            buf[:, slots] = new.to(buf.dtype)


def stage_decode(params: Any, x: torch.Tensor, slot_caches, slots: torch.Tensor,
                 cfg: ArchConfig, stage_idx: int) -> torch.Tensor:
    """One cached decode token per row against the replica's slot store.

    Gathers the batch's rows (a copy of each row's whole ``max_len`` arena),
    runs the ragged decode on them, and scatters the updated rows back into
    the store in place.  Returns the stage output.
    """
    gathered = tuple({k: a[:, slots] for k, a in d.items()} for d in slot_caches)
    x_out, new_rows = model_lib.decode_stage_ragged(params, stage_idx, x, gathered, cfg)
    slot_write(slot_caches, new_rows, slots)
    return x_out


def paged_slot_write(pool_stage, state_stage, new_caches, wtab: torch.Tensor,
                     slots: torch.Tensor) -> None:
    """Scatter a prefill batch's cache rows into the PAGED slot store, in place.

    ``wtab`` is int64 [B, n_logical], each row's WRITE table: the pool block
    per logical block, with prefix-shared blocks (already filled and read by
    other rows) and blocks past the prompt sent to the trash block; padded
    rows are all trash.  Every pool leaf's rows (``k``/``v``, or MLA's
    ``c_kv``/``k_pe``) are cut into blocks and scattered through ``wtab``;
    ``pos`` scatters at ``slots`` as in the dense layout.  Only the trash block repeats in ``wtab``, and which
    duplicate lands there does not matter: no row reads it.
    """
    flat = wtab.reshape(-1)  # [B * n_logical]
    n_logical = wtab.shape[1]
    for pool_d, state_d, new_d in zip(pool_stage, state_stage, new_caches):
        for key, buf in pool_d.items():
            new = new_d[key]  # [P, B, max_len, ...]
            P, B, L = new.shape[:3]
            bs = buf.shape[2]
            pad = n_logical * bs - L
            if pad:
                new = torch.cat([new, new.new_zeros((P, B, pad) + tuple(new.shape[3:]))], dim=2)
            buf[:, flat] = new.reshape((P, B * n_logical, bs) + tuple(new.shape[3:])).to(buf.dtype)
        for key, buf in state_d.items():
            new = new_d[key]
            if new.ndim < buf.ndim:  # "pos" comes out of prefill as one scalar per period
                new = new[:, None].expand(-1, slots.shape[0])
            buf[:, slots] = new.to(buf.dtype)


def paged_stage_decode(params: Any, x: torch.Tensor, pool_stage, state_stage,
                       tables: torch.Tensor, slots: torch.Tensor, cfg: ArchConfig,
                       stage_idx: int, seq_len: int) -> torch.Tensor:
    """One cached decode token per row against the replica's PAGED store.

    ``tables`` int32 [B, n_logical] maps each row's logical blocks to pool
    rows (unallocated entries point at the trash block); ``slots`` int64 [B]
    names each row's state row.  Gathers the state rows, runs the ragged
    decode reading and writing K/V through the tables (the pool is updated
    in place), scatters the state rows back and returns the stage output.
    """
    rows = tuple({k: a[:, slots] for k, a in d.items()} for d in state_stage)
    x_out, new_caches = model_lib.decode_stage_paged(
        params, stage_idx, x, pool_stage, rows, tables, cfg, seq_len
    )
    for state_d, new_d in zip(state_stage, new_caches):
        for key, buf in state_d.items():
            buf[:, slots] = new_d[key].to(buf.dtype)
    return x_out


def block_copy(pool_stage, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy pool blocks ``src -> dst`` (int64 [n] each) in every pool leaf,
    in place: the device half of the allocator's copy-on-write.  The source
    blocks are read into a temporary first, so a block that is both a source
    and a destination is copied from its old contents."""
    for pool_d in pool_stage:
        for buf in pool_d.values():
            blocks = buf[:, src]  # advanced indexing: a copy, not a view
            buf[:, dst] = blocks


def select_exit(
    next_token: torch.Tensor,  # [B] final-head tokens
    exit_conf: torch.Tensor,  # [B, n_exits]
    exit_tok: torch.Tensor,  # [B, n_exits]
    thresholds: torch.Tensor,  # [n_exits]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper's exit rule: first branch with conf >= c_h wins, else final head.

    Returns (token [B], exit_stage_index [B] — n_exits means the final head).
    """
    B, n_exits = exit_conf.shape
    if n_exits == 0:
        return next_token, torch.zeros((B,), dtype=torch.int32, device=next_token.device)
    took = exit_conf >= thresholds[None, :]
    any_took = took.any(dim=1)
    first = took.int().argmax(dim=1)  # first True
    chosen = torch.gather(exit_tok, 1, first[:, None])[:, 0]
    token = torch.where(any_took, chosen, next_token)
    stage_idx = torch.where(any_took, first, n_exits).to(torch.int32)
    return token, stage_idx


def make_prefill_step(cfg: ArchConfig, max_len: int):
    """The batched prefill step: ``prefill_step(params, batch, thresholds)``
    runs ``model.prefill`` over ``batch`` (``{"tokens": [B, S]}`` or, under
    ``frontend="embeds"``, ``{"embeds": [B, S, d]}``) and applies the exit
    rule.  Returns ``{"token", "exit_stage", "exit_conf", "caches"}``, the
    caches sized ``max_len`` (a window ring where the window is shorter)."""

    def prefill_step(params: Any, batch: dict, thresholds: torch.Tensor) -> dict:
        with mesh_scope(params):
            next_token, exit_conf, exit_tok, caches = model_lib.prefill(params, batch, cfg, max_len)
            token, stage_idx = select_exit(next_token, exit_conf, exit_tok, thresholds)
        return {"token": token, "exit_stage": stage_idx, "exit_conf": exit_conf, "caches": caches}

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """The batched decode step: ``decode_step(params, batch, caches,
    thresholds)`` runs ``model.decode_step`` (one position for every row,
    the caches updated in place) and applies the exit rule; returns as
    ``make_prefill_step``'s step does."""

    def decode_step(params: Any, batch: dict, caches: list, thresholds: torch.Tensor) -> dict:
        with mesh_scope(params):
            next_token, exit_conf, exit_tok, new_caches = model_lib.decode_step(params, batch,
                                                                                caches, cfg)
            token, stage_idx = select_exit(next_token, exit_conf, exit_tok, thresholds)
        return {"token": token, "exit_stage": stage_idx, "exit_conf": exit_conf,
                "caches": new_caches}

    return decode_step


def monolithic_generate(
    params: Any,
    cfg: ArchConfig,
    prompt: np.ndarray,  # [S] int32
    thresholds: np.ndarray,  # [n_early_branches]
    gen_len: int,
    max_len: int | None = None,
) -> tuple[list[int], int]:
    """Single-host reference: ``model.prefill`` + ``model.decode_step`` on
    the device the parameters live on.

    Applies the paper's exit rule per token — the first early branch with
    conf >= c_b emits the token AND terminates the generation; otherwise the
    final head's token is appended and decoding continues up to ``gen_len``.
    Returns ``(tokens, exit_stage_of_last)``.
    """
    device = params["lm_head"].device
    S = int(prompt.shape[0])
    if max_len is None:
        max_len = S + gen_len
    exit_stages = list(cfg.exit_stages)
    H = cfg.num_stages

    def pick(conf, tok, final_tok):
        conf, tok, final_tok = conf.cpu().numpy(), tok.cpu().numpy(), final_tok.cpu().numpy()
        for b, stage in enumerate(exit_stages):
            if float(conf[0, b]) >= float(thresholds[b]):
                return int(tok[0, b]), stage
        return int(final_tok[0]), H

    tokens_in = torch.as_tensor(np.asarray(prompt, np.int32)[None], device=device)
    next_tok, conf, etok, caches = model_lib.prefill(params, {"tokens": tokens_in}, cfg, max_len)
    token, stage = pick(conf, etok, next_tok)
    tokens = [token]
    while stage == H and len(tokens) < gen_len:
        step = torch.tensor([[tokens[-1]]], dtype=torch.int32, device=device)
        next_tok, conf, etok, caches = model_lib.decode_step(params, {"tokens": step}, caches, cfg)
        token, stage = pick(conf, etok, next_tok)
        tokens.append(token)
    return tokens, stage
