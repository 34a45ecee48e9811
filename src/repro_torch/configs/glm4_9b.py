"""glm4-9b [dense] — RoPE + aggressive GQA (kv=2).  [hf:THUDM/glm-4-9b; hf]

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RMSNorm + QKV bias; 16 query heads share each KV head of 128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    qkv_bias=True,
    rope_theta=1e4,
    period=("attn",),
    num_stages=4,
    exit_stages=(2, 3),
    sub_quadratic=False,
)
