"""Operations and bytes: the kernels' least times and the model FLOPs that
``mfu`` counts, from shapes alone.

The kernel counts are frozen copies of ``chip_smoke.py``'s bound arithmetic
(its times phase): each input byte is read once and each output byte
written once, whatever a kernel reads again; decode counts the keys up to
each row's length, flash the causal triangle.  The least time of a call is
the larger of its FLOPs over the bf16 peak and its bytes over HBM's rate.
"""
from __future__ import annotations

from perfbench.harness.peaks import HBM_BW, PEAK_FLOPS_BF16

BF16 = 2


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BW)


def flash_attention(B: int, S: int, hq: int, kvh: int, hd: int) -> tuple[float, float]:
    """(FLOPs, bytes) of causal prefill attention over q [B, S, hq, hd] and
    k, v [B, S, kvh, hd]: QK^T and PV over the S (S + 1) / 2 causal pairs;
    q and the output, k and v, once each."""
    pairs = S * (S + 1) // 2
    flops = 4 * B * hq * hd * pairs
    nbytes = 2 * B * S * hq * hd * BF16 + 2 * B * S * kvh * hd * BF16
    return float(flops), float(nbytes)


def decode_attention(total_len: int, B: int, hq: int, kvh: int, hd: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode call: ``total_len`` is the sum of the
    rows' lengths (keys read), K and V over them, q and the output, the
    lengths."""
    flops = 4 * total_len * hq * hd
    nbytes = 2 * total_len * kvh * hd * BF16 + 2 * B * hq * hd * BF16 + B * 4
    return float(flops), float(nbytes)


def exit_confidence(B: int, d: int, V: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the fused head over h [B, d] and w [d, V]: w and h
    read once, a confidence and a token (4 bytes each) a row written."""
    return float(2 * B * d * V), float(d * V * BF16 + B * d * BF16 + B * 8)


def layer_linear_flops(m: dict) -> float:
    """Matmul FLOPs of one decoder layer for one token (``m`` the config
    file's ``port`` group): the Q, K, V and O projections and the GLU FFN."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    return 2.0 * (d * q + 2 * d * kv + q * d + 3 * d * m["d_ff"])


def pass_flops(m: dict, start: int, n: int) -> float:
    """Model FLOPs of one pass through every stage of ``n`` tokens at
    positions ``start .. start + n - 1`` (a prefill: start 0, n the prompt;
    a decode step: start the position, n 1), causal attention included, plus
    one call of each head (the exits and the final head) at the last
    position.  Padding rows and re-reads are not counted; norms, biases and
    activations are left out (under 0.1% of it)."""
    L = m["num_layers"]
    ctx = n * start + n * (n + 1) // 2  # (query, key) pairs of the n tokens
    attn = 4.0 * m["num_heads"] * m["head_dim"] * ctx
    heads = (len(m["exit_stages"]) + 1) * 2.0 * m["d_model"] * m["vocab_size"]
    return L * (n * layer_linear_flops(m) + attn) + heads
