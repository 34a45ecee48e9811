"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (kv=24 == MHA) d_ff=6144
vocab=2048.  Classic post-GPT block: LayerNorm + 2-matmul GELU MLP.  The
EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings.  H=5 stages mirrors the paper's BERT 5-way split.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    ffn="mlp",
    rope_theta=1e4,
    period=("attn",),
    frontend="embeds",
    num_stages=5,
    exit_stages=(2, 3, 4),
    sub_quadratic=False,
    notes="EnCodec frontend stubbed as precomputed frame embeddings",
)
