"""The plain reference of the served model: a decoder of attention blocks
with a GLU FFN, staged, with early-exit heads, in plain PyTorch.

It follows the configuration file's ``port`` group (the model as the port
runs it; the file's ``departures`` say where that differs from the
published model) and takes the benchmark's weight tree, the same tensors
the program serves, and nothing the program has made.  It imports nothing
of the program.

Per layer: ``x += Attn(norm1(x))``, ``x += FFN(norm2(x))``.  Attention
projects Q, K, V (plus their biases), rotates Q and K by rotate-half RoPE
over the whole head at ``rope_theta``, and takes causal softmax attention
with ``num_heads / num_kv_heads`` query heads on each K/V head, scaled by
``1 / sqrt(head_dim)``; then the O projection.  The FFN is
``down(silu(gate(h)) * up(h))``.  The layers fall into ``num_stages``
stages as ``numpy.array_split`` cuts them (earlier stages take the extra
layers); after each stage in ``exit_stages`` an exit head reads
``lm_head(exit_norm(x))``, and after the last stage the final head
``lm_head(final_norm(x))``.  ``layernorm`` has eps 1e-5 and a bias,
``rmsnorm`` eps 1e-6.

``precision="f32"`` computes in float32 with TF32 off: the reference.
``precision="fp8"`` is the control: every matmul's operands are rounded to
float8 e4m3 first (the weight per output column, the activation per row,
each scaled to e4m3's largest finite value 448), the rest in float32, as an
fp8 GEMM with per-channel scales would compute.

The weights are taken to float32 one layer at a time, so the reference's
own memory is one layer's weights and the activations of one sequence.
"""
from __future__ import annotations

import math

import numpy as np
import torch

FP8_MAX = 448.0
Q_CHUNK = 1024


def stage_layers(m: dict) -> list[int]:
    """Layers per stage, as ``numpy.array_split`` cuts ``num_layers``."""
    return [len(a) for a in np.array_split(np.arange(m["num_layers"]), m["num_stages"])]


def _qdq_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per row (last dim reduced)."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


def _qdq_cols(w: torch.Tensor) -> torch.Tensor:
    """``w`` [in, out] rounded to e4m3 with one scale per output column."""
    return _qdq_rows(w.t()).t()


class _Math:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _qdq_cols(w) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_qdq_rows(x) if self.fp8 else x) @ w


def _norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * p["scale"].float() + p["bias"].float()
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * p["scale"].float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over the last dim of x [S, heads, hd], positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q [S, Hq, hd] over k, v [S, KVH, hd], queries in
    chunks of ``Q_CHUNK`` so the scores stay [Hq, chunk, S]."""
    S, hq, hd = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [Hq, S, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    keys = torch.arange(S, device=q.device)
    for s0 in range(0, S, Q_CHUNK):
        s1 = min(S, s0 + Q_CHUNK)
        qc = q[s0:s1].transpose(0, 1)  # [Hq, c, hd]
        scores = (qc @ k[:, :s1].transpose(1, 2)) * scale
        mask = keys[None, :s1] > torch.arange(s0, s1, device=q.device)[:, None]
        scores = scores.masked_fill(mask, float("-inf"))
        out[s0:s1] = (torch.softmax(scores, dim=-1) @ v[:, :s1]).transpose(0, 1)
    return out


def _layer(m: dict, blk: dict, i: int, x: torch.Tensor, mt: _Math) -> torch.Tensor:
    """Decoder layer ``i`` of a stage's stacked block dict ``blk``."""
    hd, hq, kvh = m["head_dim"], m["num_heads"], m["num_kv_heads"]
    S = x.shape[0]
    at = blk["attn"]

    def w(name):
        return mt.weight(at[name][i])

    def norm(name, y):
        return _norm(m["norm"], {k: t[i] for k, t in blk[name].items()}, y)

    h = norm("norm1", x)
    q, k, v = mt.mm(h, w("w_q")), mt.mm(h, w("w_k")), mt.mm(h, w("w_v"))
    if m["qkv_bias"]:
        q, k, v = q + at["b_q"][i].float(), k + at["b_k"][i].float(), v + at["b_v"][i].float()
    q = _rope(q.reshape(S, hq, hd), m["rope_theta"])
    k = _rope(k.reshape(S, kvh, hd), m["rope_theta"])
    o = _attention(q, k, v.reshape(S, kvh, hd)).reshape(S, hq * hd)
    x = x + mt.mm(o, w("w_o"))
    h2 = norm("norm2", x)
    ffn = blk["ffn"]
    gate = mt.mm(h2, mt.weight(ffn["w_gate"][i]))
    up = mt.mm(h2, mt.weight(ffn["w_up"][i]))
    return x + mt.mm(torch.nn.functional.silu(gate) * up, mt.weight(ffn["w_down"][i]))


def head_logits(weights: dict, m: dict, tokens: torch.Tensor, positions,
                precision: str = "f32") -> dict[int, torch.Tensor]:
    """``{stage: logits [len(positions), V] float32}`` of every head (the
    exit stages' and, under ``num_stages``, the final head's) at
    ``positions`` of the sequence ``tokens`` [S] (int, on the weights'
    device)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _head_logits(weights, m, tokens, positions, _Math(precision))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _head_logits(weights, m, tokens, positions, mt: _Math):
    pos = torch.as_tensor(np.asarray(positions, np.int64), device=tokens.device)
    lm_head = mt.weight(weights["lm_head"])
    x = weights["embed"]["embed"][tokens.long()].float()
    out = {}
    for s, (n_layers, stage) in enumerate(zip(stage_layers(m), weights["stages"]), start=1):
        (blk,) = stage["blocks"]
        for i in range(n_layers):
            x = _layer(m, blk, i, x, mt)
        if s in m["exit_stages"]:
            out[s] = mt.mm(_norm(m["norm"], weights["exit_norms"][f"exit_{s}"], x[pos]), lm_head)
    out[m["num_stages"]] = mt.mm(_norm(m["norm"], weights["final_norm"], x[pos]), lm_head)
    return out
