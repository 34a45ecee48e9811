"""The kernels' FLOP and byte counts and the model FLOPs ``mfu`` counts,
against hand counts at two shapes each."""
from __future__ import annotations

from perfbench_tiny import ROOT  # noqa: F401

from perfbench.harness import flops
from perfbench.harness.bench import PERFBENCH, load_json


def test_flash_counts():
    # B 1, S 4, 2 query heads on 1 KV head of 8: 10 causal pairs
    assert flops.flash_attention(1, 4, 2, 1, 8) == (4 * 2 * 8 * 10, 2 * 4 * 2 * 8 * 2 + 2 * 4 * 8 * 2)
    # glm4's heads at S 2048 (chip_smoke's 34.38 GFLOP)
    f, b = flops.flash_attention(1, 2048, 32, 2, 128)
    assert round(f / 1e9, 2) == 34.38
    assert b == 2 * 2048 * 32 * 128 * 2 + 2 * 2048 * 2 * 128 * 2


def test_decode_counts():
    # two rows of lengths 3 and 5, 4 query heads on 2 KV heads of 16
    f, b = flops.decode_attention(8, 2, 4, 2, 16)
    assert f == 4 * 8 * 4 * 16
    assert b == 2 * 8 * 2 * 16 * 2 + 2 * 2 * 4 * 16 * 2 + 2 * 4
    # stablelm, B 8 at 4096 keys each: 2 x 32768 x 32 x 64 x 2 bytes of K/V
    f, b = flops.decode_attention(8 * 4096, 8, 32, 32, 64)
    assert b == 268435456 + 2 * 8 * 32 * 64 * 2 + 32


def test_exit_counts():
    assert flops.exit_confidence(1, 4, 10) == (80, 4 * 10 * 2 + 4 * 2 + 8)
    f, b = flops.exit_confidence(8, 2048, 100352)  # chip_smoke: 411.1 MB
    assert round(b / 1e6, 1) == 411.1 and f == 2 * 8 * 2048 * 100352


def test_least_time_takes_the_larger_bound():
    assert flops.least_seconds(989e12, 0) == 1.0
    assert flops.least_seconds(0, 3.35e12) == 1.0


def _port(name):
    return load_json(PERFBENCH / "configs" / f"{name}.json")["port"]


def test_pass_flops_by_hand():
    m = {"num_layers": 2, "d_model": 4, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2,
         "d_ff": 8, "vocab_size": 10, "exit_stages": [1]}
    # per token and layer: q 4x4, k and v 4x2 each, o 4x4, FFN 3 x 4x8 -> 144 MACs
    linear = 2 * (16 + 8 + 8 + 16 + 96)
    heads = 2 * 2 * 4 * 10  # two heads (one exit, the final) of 4 x 10
    # a 3-token prefill: 6 causal pairs; 4 FLOPs x 2 heads x 2 dims a pair
    assert flops.pass_flops(m, 0, 3) == 2 * (3 * linear + 4 * 2 * 2 * 6) + heads
    # the decode step at position 3 reads 4 keys
    assert flops.pass_flops(m, 3, 1) == 2 * (linear + 4 * 2 * 2 * 4) + heads


def test_pass_flops_at_full_width():
    # stablelm: 1.61 G matmul parameters a token in its 24 layers
    m = _port("stablelm-1.6b")
    per_token = flops.pass_flops(m, 1000, 1) - 3 * 2 * 2048 * 100352 - 24 * 4 * 32 * 64 * 1001
    assert per_token == 24 * 2 * (4 * 2048 * 2048 + 3 * 2048 * 5632)
    # glm4: 4.08 GFLOP a token a stage (2.04 G matmul parameters)
    g = _port("glm4-9b")
    stage = flops.layer_linear_flops(g) * 10
    assert round(stage / 1e9, 2) == 4.08
