"""stablelm-1.6b [dense].  [hf:stabilityai/stablelm-2-1_6b; unverified]

24L d_model=2048 32H (GQA kv=32 == MHA) d_ff=5632 vocab=100352.
LayerNorm + QKV bias per the stablelm-2 family.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    norm="layernorm",
    act="silu",
    qkv_bias=True,
    rope_theta=1e4,
    period=("attn",),
    num_stages=4,
    exit_stages=(2, 3),
    sub_quadratic=False,
)
