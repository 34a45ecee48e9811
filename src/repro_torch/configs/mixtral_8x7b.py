"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.  SWA window 4096 -> decode touches only the window ring
buffer, so long_500k runs (O(n*w) attention).
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoeDims

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope_theta=1e6,
    sliding_window=4096,
    period=("moe_attn",),
    moe=MoeDims(
        d_model=4096,
        d_ff_expert=14336,
        num_experts=8,
        top_k=2,
        router_norm="topk_softmax",
    ),
    num_stages=4,
    exit_stages=(2, 3),
    sub_quadratic=True,
)
